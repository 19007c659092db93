"""Quality evaluation over a tts_text.json set: speaker similarity, and with
references token recovery and log-mel correlation; CER through an ASR hook.

Counterpart of cosyvoice_tpu/tools/eval_quality.py. For each (utt, texts)
of tts_text.json (the recipes' format) with a prompt wav and transcript
(kaldi-style `utt path` / `utt text` files), every text is synthesized
offline with `inference_zero_shot` on the model dir's model
(`runtime/api.AutoModel`, on `--device`), then:

- speaker similarity: the cosine of the CAM++ x-vectors of the prompt and
  of the synthesis (resampled to 16 kHz with `ops/resample.resample_poly`);
- with `--ref_scp` (`{utt}_{i} path`, a ground-truth wav per text): token
  recovery, the share of S3 speech tokens read off the synthesis that equal
  those read off the reference (over the shorter), and the Pearson
  correlation of their log-mels over the frames they share;
- with `--asr module:function` (`fn(wav, sample_rate) -> str`): the
  character error rate against the text (serving/reward_server.cer). No
  ASR model ships, so CER is null without the hook.

Prints one JSON line {"n", "speaker_similarity", "cer", "token_recovery",
"mel_corr"}, a metric null where nothing measured it.

    python -m cosyvoice_tpu_torch.tools.eval_quality --model_dir DIR --tts_text tts_text.json \\
        --prompt_scp wav.scp --prompt_text text [--ref_scp ref.scp] [--asr pkg.mod:fn] [--out_dir wavs] \\
        [--max_utts N] [--device cuda]
"""

import argparse
import importlib
import json
import os
from fractions import Fraction

import numpy as np
import torch


def _scp(path: str) -> dict:
    with open(path) as f:
        return dict(line.split(maxsplit=1) for line in f.read().splitlines() if line.strip())


def _to_16k(wav: np.ndarray, sr: int) -> np.ndarray:
    """[L] or [1, L] at sr -> [1, L'] float32 at 16 kHz (float64 inside)."""
    from cosyvoice_tpu_torch.ops.resample import resample_poly

    frac = Fraction(16000, sr).limit_denominator(1000)
    x = torch.from_numpy(np.asarray(wav, np.float64).reshape(-1))
    return resample_poly(x, frac.numerator, frac.denominator).numpy().astype(np.float32)[None]


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def evaluate(model, tts_text: dict, utt2wav: dict, utt2text: dict, ref_scp: dict, asr_fn=None, out_dir: str = "",
             max_utts: int = 0) -> dict:
    """The metrics over the set (see the module docstring); `model` an API
    instance (CosyVoice, CosyVoice2, CosyVoice3)."""
    from cosyvoice_tpu_torch.serving.reward_server import cer
    from cosyvoice_tpu_torch.utils.audio_io import load_wav, save_wav

    fe, sr = model.frontend, model.sample_rate
    sims, cers, recov, mcorr, n = [], [], [], [], 0
    for utt, texts in tts_text.items():
        if utt not in utt2wav or utt not in utt2text:
            continue
        prompt_16k = load_wav(utt2wav[utt].strip(), 16000)
        prompt_emb = fe._extract_spk_embedding(prompt_16k)[0]
        for i, text in enumerate(texts):
            outs = model.inference_zero_shot(text, utt2text[utt].strip(), prompt_16k, stream=False)
            wav = np.concatenate([o["tts_speech"] for o in outs], axis=-1).reshape(1, -1)
            if out_dir:
                save_wav(os.path.join(out_dir, f"{utt}_{i}.wav"), wav, sr)
            synth_16k = _to_16k(wav, sr)
            sims.append(_cosine(prompt_emb, fe._extract_spk_embedding(synth_16k)[0]))
            if asr_fn is not None:
                cers.append(cer(asr_fn(wav.reshape(-1), sr), text))
            ref_path = ref_scp.get(f"{utt}_{i}", "").strip()
            if ref_path:
                ref = load_wav(ref_path, sr)
                t_syn = fe._extract_speech_token(synth_16k)
                t_ref = fe._extract_speech_token(_to_16k(ref, sr))
                L = min(len(t_syn), len(t_ref))
                recov.append(float(np.mean(t_syn[:L] == t_ref[:L])) if L else 0.0)
                m_syn, m_ref = fe._extract_speech_feat(wav)[0], fe._extract_speech_feat(ref)[0]
                F = min(m_syn.shape[0], m_ref.shape[0])
                a, b = m_syn[:F].reshape(-1), m_ref[:F].reshape(-1)
                mcorr.append(_cosine(a - a.mean(), b - b.mean()))
            n += 1
            if max_utts and n >= max_utts:
                break
        if max_utts and n >= max_utts:
            break

    def mean(xs):
        return float(np.mean(xs)) if xs else None

    return {"n": n, "speaker_similarity": mean(sims), "cer": mean(cers), "token_recovery": mean(recov),
            "mel_corr": mean(mcorr)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default="")
    parser.add_argument("--tts_text", required=True)
    parser.add_argument("--prompt_scp", required=True, help="utt -> prompt wav path")
    parser.add_argument("--prompt_text", required=True, help="utt -> prompt transcript")
    parser.add_argument("--asr", default="", help="module:function -> fn(wav, sr) -> str")
    parser.add_argument("--out_dir", default="", help="save the synthesized wavs here")
    parser.add_argument("--max_utts", type=int, default=0)
    parser.add_argument("--ref_scp", default="", help="'{utt}_{i} wav-path': a ground-truth wav per text")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cosyvoice_tpu_torch.runtime.api import AutoModel

    asr_fn = None
    if args.asr:
        mod, _, fn = args.asr.partition(":")
        asr_fn = getattr(importlib.import_module(mod), fn or "transcribe")
    model = AutoModel(args.model_dir, device=args.device)
    with open(args.tts_text) as f:
        tts_text = json.load(f)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    result = evaluate(model, tts_text, _scp(args.prompt_scp), _scp(args.prompt_text),
                      _scp(args.ref_scp) if args.ref_scp else {}, asr_fn, args.out_dir, args.max_utts)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
