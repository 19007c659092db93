"""Synthetic overfit corpus of the hermetic quality recipe.

Counterpart of examples/hermetic/corpus.py. Real checkpoints are not part of
the repo, so quality is evidenced on a procedurally generated "language"
whose ground truth is exact:

- 8 spoken "words", each a 0.24 s harmonic tone with a word-specific pitch
  and formant boost (separable on a mel spectrogram);
- 2 "speakers" (f0 register and spectral tilt), so that CAM++ x-vector
  similarity measures something;
- every utterance is textA + textB, two 4-word segments ending in "." and
  joined with no space, so that the tokenizer's encode(textA + textB) is
  encode(textA) + encode(textB) and a zero-shot input [sos][prompt_text +
  text][task][prompt tokens] is exactly a training sequence's prefix;
- speech tokens are extracted per segment and concatenated, so that the eval
  prompt's S3 tokens (segment A alone) equal the training prefix.

`make_corpus` writes the wavs, kaldi-style files, eval files and the mel
templates of the template ASR; `train_tokenizer` supervises the S3
tokenizer on per-frame word labels; `prep_features` writes
utt2embedding.pkl and utt2speech_token.pkl through a model dir's frontend.
numpy generation with the JAX recipe's seeds: the wav bytes and the files
are the same.
"""

import json
import os
import pickle

import numpy as np
import torch

SR = 24000
UNIT_SEC = 0.24
UNITS = ["ba", "du", "ki", "mo", "ta", "re", "su", "no"]
SEG_WORDS = 4
N_SPK = 2
MEL_HOP = 480  # 50 fps at 24 kHz -> 12 mel frames per unit
UNIT_FRAMES = int(UNIT_SEC * SR / MEL_HOP)
TOKEN_RATE = 25  # S3 tokens per second


def unit_wave(unit: int, spk: int) -> np.ndarray:
    """One word's waveform: a harmonic complex with a word-specific f0 and
    formant harmonic, 10 ms raised-cosine edges."""
    n = int(UNIT_SEC * SR)
    t = np.arange(n) / SR
    f0 = 110.0 * (2.0 ** (unit / 5.0)) * (1.0 if spk == 0 else 1.3)
    tilt = 1.3 if spk == 0 else 0.9
    boost_h = 2 + (unit % 4)
    rng = np.random.default_rng(1000 + unit)  # fixed per-unit phases
    x = np.zeros(n)
    for h in range(1, 9):
        amp = h ** (-tilt) * (3.0 if h == boost_h else 1.0)
        x += amp * np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 2 * np.pi))
    edge = int(0.01 * SR)
    env = np.ones(n)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)
    env[:edge], env[-edge:] = ramp, ramp[::-1]
    x *= env
    return (0.3 * x / np.max(np.abs(x))).astype(np.float32)


def segment(words, spk: int) -> np.ndarray:
    return np.concatenate([unit_wave(int(w), spk) for w in words])


def seg_text(words) -> str:
    return " ".join(UNITS[int(w)] for w in words) + "."


def unit_templates() -> np.ndarray:
    """The template ASR's mel templates: [N_SPK * len(UNITS), UNIT_FRAMES,
    80], speaker-major, each the first UNIT_FRAMES frames of the word's mel
    (ops/mel.mel_spectrogram, float64 inside)."""
    from cosyvoice_tpu_torch.ops.mel import mel_spectrogram

    temps = []
    for spk in range(N_SPK):
        for u in range(len(UNITS)):
            m = mel_spectrogram(torch.from_numpy(unit_wave(u, spk)[None]), sr=SR)[0].numpy()  # [80, T]
            temps.append(m[:, :UNIT_FRAMES].T)
    return np.stack(temps)


def make_corpus(out_dir: str, n_utts: int = 32, seed: int = 0) -> str:
    """Writes, under out_dir:
      wavs/utt{i}.wav              the utterance (segment A + segment B)
      wavs/utt{i}_A.wav, _B.wav    the two segments
      wav.scp, text, utt2spk       training metadata
      eval/{wav.scp, text, tts_text.json, ref.scp}
      meta.json                    per utterance: spk, text_a, text_b
      templates.npz                the template ASR's per-(speaker, unit) mels
    """
    from cosyvoice_tpu_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wavs")
    eval_dir = os.path.join(out_dir, "eval")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(eval_dir, exist_ok=True)

    scp, texts, utt2spk = [], [], []
    e_scp, e_text, e_ref, e_tts = [], [], [], {}
    meta = {}
    for i in range(n_utts):
        spk = i % N_SPK
        utt = f"utt{i:03d}"
        wa = rng.integers(0, len(UNITS), SEG_WORDS)
        wb = rng.integers(0, len(UNITS), SEG_WORDS)
        seg_a, seg_b = segment(wa, spk), segment(wb, spk)
        pa, pb, pf = (os.path.join(wav_dir, f"{utt}{s}.wav") for s in ("_A", "_B", ""))
        save_wav(pa, seg_a, SR)
        save_wav(pb, seg_b, SR)
        save_wav(pf, np.concatenate([seg_a, seg_b]), SR)
        ta, tb = seg_text(wa), seg_text(wb)
        scp.append(f"{utt} {pf}")
        texts.append(f"{utt} {ta}{tb}")  # byte-exact concatenation, no joiner
        utt2spk.append(f"{utt} spk{spk}")
        e_scp.append(f"{utt} {pa}")
        e_text.append(f"{utt} {ta}")
        e_tts[utt] = [tb]
        e_ref.append(f"{utt}_0 {pb}")
        meta[utt] = {"spk": spk, "text_a": ta, "text_b": tb}

    for name, lines in (("wav.scp", scp), ("text", texts), ("utt2spk", utt2spk)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    for name, lines in (("wav.scp", e_scp), ("text", e_text), ("ref.scp", e_ref)):
        with open(os.path.join(eval_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(eval_dir, "tts_text.json"), "w") as f:
        json.dump(e_tts, f, indent=1)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    np.savez(
        os.path.join(out_dir, "templates.npz"),
        templates=unit_templates(),
        units=np.array([u for _ in range(N_SPK) for u in range(len(UNITS))]),
        unit_frames=UNIT_FRAMES,
    )
    return out_dir


def _augment_variants(w: np.ndarray, rng: np.random.Generator):
    """The clean wav and four distortions (quiet, noise at 15-25 dB SNR, a
    +6 dB/oct tilt, a gentle one-pole lowpass): token recovery re-tokenizes
    synthesized audio, so the tokenizer's codes must not move with gain,
    noise floors and tilt."""
    out = [w]
    out.append((0.2 * w).astype(np.float32))
    snr = 10 ** (rng.uniform(15.0, 25.0) / 20.0)
    noise = rng.standard_normal(len(w)).astype(np.float32) * (np.std(w) / snr)
    out.append((w + noise).astype(np.float32))
    tilt = np.empty_like(w)  # x[n] - 0.5 x[n-1]
    tilt[0] = w[0]
    tilt[1:] = w[1:] - 0.5 * w[:-1]
    out.append(tilt.astype(np.float32))
    lp = np.empty_like(w)  # y[n] = 0.6 y[n-1] + 0.4 x[n]
    acc = 0.0
    for i in range(len(w)):
        acc = 0.6 * acc + 0.4 * w[i]
        lp[i] = acc
    out.append(lp.astype(np.float32))
    return out


def segment_labels(text: str) -> np.ndarray:
    """Per-token word labels of a segment's text at the 25 Hz token rate: each
    word's 6 slots, its first and last -1 (word boundaries are unsupervised)."""
    per_unit = int(UNIT_SEC * TOKEN_RATE)
    fl = []
    for w in text.rstrip(".").split():
        fl += [-1] + [UNITS.index(w)] * (per_unit - 2) + [-1]
    return np.asarray(fl)


def tokenizer_batch(s3, wavs_16k, frame_labels, augment: bool = True, device="cpu"):
    """The supervision batch: every wav (and its augmented variants, drawn
    from numpy's default_rng(4242)) as a whisper log-mel, padded: X [N, T,
    n_mels] float32, Y [N, T_tok] int64 (-1 pads), L [N] mel lengths."""
    from cosyvoice_tpu_torch.ops.mel import whisper_log_mel

    c = s3.cfg
    aug_rng = np.random.default_rng(4242)
    mels, labs = [], []
    for w16, fl in zip(wavs_16k, frame_labels):
        w = np.asarray(w16, np.float32).reshape(-1)
        for var in (_augment_variants(w, aug_rng) if augment else [w]):
            mel = whisper_log_mel(torch.from_numpy(np.ascontiguousarray(var)).to(device)[None], n_mels=c.n_mels)
            mels.append(mel[0].T.float())
            labs.append(np.asarray(fl, np.int64))
    T = max(m.shape[0] for m in mels)
    T_tok = (T + 1) // 2
    if c.token_rate_div > 1:
        T_tok = (T_tok + c.token_rate_div - 1) // c.token_rate_div
    X = torch.zeros((len(mels), T, c.n_mels), dtype=torch.float32, device=device)
    Y = np.full((len(mels), T_tok), -1, np.int64)
    L = np.zeros((len(mels),), np.int64)
    for i, (m, lab) in enumerate(zip(mels, labs)):
        X[i, : m.shape[0]] = m
        L[i] = m.shape[0]
        Y[i, : min(T_tok, len(lab))] = lab[:T_tok]
    return X, torch.from_numpy(Y).to(device), torch.from_numpy(L).to(device)


def tokenizer_loss(s3, head_w, head_b, X, Y, L, noise):
    """The supervised loss: tanh(fsq_proj(encode(X))) plus `noise` (uniform
    in [-0.5, 0.5), the shape of the projection) over the FSQ half-widths,
    a linear word head, masked mean cross-entropy over the labelled slots."""
    c = s3.cfg
    half = torch.as_tensor((np.asarray(c.fsq_levels) - 1) / 2.0, dtype=torch.float32, device=X.device)
    z = torch.tanh(s3.fsq_proj(s3.encode(X, L)[0]))
    z = z + noise / half
    logits = z @ head_w + head_b
    mask = (Y >= 0).float()
    ce = torch.nn.functional.cross_entropy(logits.transpose(1, 2), Y.clamp_min(0), reduction="none")
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)


def train_tokenizer(fe, wavs_16k, frame_labels, steps: int = 500, lr: float = 3e-3, seed: int = 0,
                    augment: bool = True, head=None, noise=None, losses=None) -> float:
    """Supervised training of the frontend's S3 tokenizer, in place: the
    recipe's stand-in for the ASR supervision the released tokenizer had.

    A random tokenizer collapses the FSQ code space onto a few codes, which
    leaves the LM nothing to learn the words from; so the whole S3 trunk
    trains, with Adam at `lr`, on a per-frame word head over the
    noise-regularised tanh(fsq_proj) bottleneck (`tokenizer_loss`); the head
    is dropped after. wavs_16k: float32 arrays at 16 kHz; frame_labels:
    int arrays at the 25 Hz token rate, -1 unsupervised.

    `head` (w [len(fsq_levels), n_cls], b [n_cls]) and `noise(step, shape)`
    replace the draws of a torch.Generator seeded `seed` (the head's 0.1 *
    normal first, then each step's uniform noise); `losses` collects each
    step's loss. Returns the last step's loss."""
    s3 = fe.speech_tokenizer
    dev = next(s3.parameters()).device
    X, Y, L = tokenizer_batch(s3, wavs_16k, frame_labels, augment, dev)
    n_cls = int(max(np.asarray(lab).max() for lab in frame_labels)) + 1
    k = len(s3.cfg.fsq_levels)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if head is None:
        w = 0.1 * torch.randn((k, n_cls), generator=gen, device=dev)
        b = torch.zeros((n_cls,), device=dev)
    else:
        w, b = (torch.tensor(np.asarray(a, np.float32), device=dev) for a in head)
    w, b = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    if noise is None:
        def noise(step, shape):
            return torch.rand(shape, generator=gen, device=dev) - 0.5

    params = [p for p in s3.parameters()]
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.Adam(params + [w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    T_tok = Y.shape[1]
    loss = None
    s3.train()
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = tokenizer_loss(s3, w, b, X, Y, L, noise(i, (X.shape[0], T_tok, k)))
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(loss.item())
    s3.eval()
    for p in params:
        p.grad = None
    return loss.item() if loss is not None else float("nan")


def prep_features(data_dir: str, model_dir: str = "", fe=None, device="cuda"):
    """utt2embedding.pkl and utt2speech_token.pkl of data_dir's wav.scp
    through a model dir's frontend (or `fe`): CAM++ of the whole utterance
    at 16 kHz, and the S3 tokens of segment A and of segment B
    concatenated (the eval prompt, segment A alone, reproduces the
    training prefix). Returns (embeddings, tokens)."""
    from cosyvoice_tpu_torch.runtime.api import load_frontend
    from cosyvoice_tpu_torch.utils.audio_io import load_wav

    fe = fe or load_frontend(model_dir, device=device)
    with open(f"{data_dir}/wav.scp") as f:
        utt2wav = dict(line.split(maxsplit=1) for line in f.read().splitlines())
    emb, tok = {}, {}
    for utt, path in utt2wav.items():
        path = path.strip()
        emb[utt] = np.asarray(fe._extract_spk_embedding(load_wav(path, 16000))[0], np.float32)
        seg_toks = [fe._extract_speech_token(load_wav(path.replace(".wav", f"{seg}.wav"), 16000))
                    for seg in ("_A", "_B")]
        tok[utt] = np.concatenate(seg_toks).astype(np.int32)
    with open(f"{data_dir}/utt2embedding.pkl", "wb") as f:
        pickle.dump(emb, f)
    with open(f"{data_dir}/utt2speech_token.pkl", "wb") as f:
        pickle.dump({k: v.tolist() for k, v in tok.items()}, f)
    return emb, tok
