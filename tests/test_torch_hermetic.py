"""The port's hermetic quality recipe (cosyvoice_tpu_torch/examples/hermetic)
against the JAX recipe's functions (examples/hermetic) on the CPU:

- make_corpus: the same wav bytes, meta.json and kaldi-style files, and
  templates.npz within 1e-5 relative;
- transcribe: the same strings on corpus segments and on noisy ones;
- train_tokenizer: three steps from the same S3 weights with JAX's head
  and noise draws, the loss within 1e-5 relative per step, and the first
  step's gradient within 1e-4 relative L2;
- prep_features: equal tokens and embeddings within 1e-4 (a tiny CAM++ on
  both sides, as tests/test_torch_api.py);
- a rehearsal of run.py (4 utterances, one epoch per model, a few tokenizer
  and pretrain steps, one eval utterance) whose four metrics are finite;
- where pyarrow is installed, the rows the recipe feeds equal what
  make_parquet_list -> parquet_opener gives back.
"""

import json
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.frontend import frontend as jfrontend
from cosyvoice_tpu.models.campplus import CamPPConfig as JCamPPConfig
from cosyvoice_tpu.models.campplus import CamPPEmbedding as JCamPPEmbedding
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.examples.hermetic import corpus as tc
from cosyvoice_tpu_torch.examples.hermetic import run as trun
from cosyvoice_tpu_torch.examples.hermetic import template_asr as tasr
from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from examples.hermetic import corpus as jc
from examples.hermetic import template_asr as jasr
from tests.test_torch_common import np_tree

torch.set_num_threads(1)

CAM = dict(blocks=((2, 3, 1), (2, 3, 2), (2, 3, 2)))  # tests/test_torch_api.py's tiny CAM++
S3 = trun.CONFIG["frontend"]["s3"]


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            out[os.path.relpath(os.path.join(root, n), d)] = os.path.join(root, n)
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The JAX and the port's corpus of 4 utterances."""
    jd, td = str(tmp_path_factory.mktemp("jax_corpus")), str(tmp_path_factory.mktemp("port_corpus"))
    jc.make_corpus(jd, n_utts=4)
    tc.make_corpus(td, n_utts=4)
    return jd, td


def test_make_corpus_matches_jax(corpora):
    jd, td = corpora
    jf, tf = _files(jd), _files(td)
    assert sorted(jf) == sorted(tf)
    assert len([n for n in jf if n.endswith(".wav")]) == 12
    for name, jp in jf.items():
        tp = tf[name]
        if name == "templates.npz":
            jz, tz = np.load(jp), np.load(tp)
            assert sorted(jz.files) == sorted(tz.files)
            # relative L2 over the templates: the port's mel computes in
            # float64, JAX's in float32, whose log of the quietest bins moves
            # single elements by up to ~2e-4 relative
            jt, tt = jz["templates"].astype(np.float64), tz["templates"].astype(np.float64)
            assert np.linalg.norm(tt - jt) <= 1e-5 * np.linalg.norm(jt)
            np.testing.assert_array_equal(tz["units"], jz["units"])
            assert int(tz["unit_frames"]) == int(jz["unit_frames"])
        elif name.endswith(".wav") or name.endswith(".json"):
            with open(jp, "rb") as a, open(tp, "rb") as b:
                assert a.read() == b.read(), name
        else:  # kaldi files name the wavs under their own dir
            with open(jp) as a, open(tp) as b:
                assert a.read().replace(jd, "<d>") == b.read().replace(td, "<d>"), name


def test_transcribe_matches_jax(corpora, monkeypatch):
    """Segments of the corpus and the same segments at 20 and 5 dB SNR."""
    jd, td = corpora
    monkeypatch.setenv("HERMETIC_DIR", jd)
    rng = np.random.default_rng(0)
    n = 0
    for utt in range(4):
        for seg in ("_A", "_B"):
            from cosyvoice_tpu_torch.utils.audio_io import load_wav

            w = load_wav(os.path.join(jd, "wavs", f"utt{utt:03d}{seg}.wav"), 24000)[0]
            for snr_db in (None, 20.0, 5.0):
                x = w if snr_db is None else (w + rng.standard_normal(len(w)).astype(np.float32)
                                              * np.std(w) / 10 ** (snr_db / 20)).astype(np.float32)
                want = jasr.transcribe(x, 24000)
                assert tasr.transcribe(x, 24000, td) == want
                n += want.count(" ") + 1
    with open(os.path.join(jd, "meta.json")) as f:
        meta = json.load(f)
    clean = load_wav(os.path.join(jd, "wavs", "utt000_B.wav"), 24000)[0]
    assert tasr.transcribe(clean, 24000, td) == meta["utt000"]["text_b"]
    assert n == 4 * 2 * 3 * 4


def _write_config(d):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"version": 2, "frontend": {"s3": S3}}, f)
    return str(d)


def _jax_frontend(model_dir):
    from cosyvoice_tpu.runtime.api import load_frontend

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfrontend, "CamPPEmbedding", lambda: JCamPPEmbedding(JCamPPConfig(**CAM)))
        return load_frontend(model_dir)


def _port_frontend(model_dir, jfe):
    from cosyvoice_tpu_torch.runtime.api import load_frontend

    fe = load_frontend(model_dir, device="cpu")
    fe.campplus = CamPPEmbedding(CamPPConfig(**CAM))
    load_jax_params(fe.speech_tokenizer, np_tree(jfe.speech_tokenizer_params["params"]))
    load_jax_params(fe.campplus, np_tree(jfe.campplus_params["params"]))
    return fe


def _supervision(corpus_dir, n_utts=2):
    from cosyvoice_tpu_torch.utils.audio_io import load_wav

    with open(os.path.join(corpus_dir, "meta.json")) as f:
        meta = json.load(f)
    wavs, labels = [], []
    for utt, m in list(meta.items())[:n_utts]:
        for seg, key in (("_A", "text_a"), ("_B", "text_b")):
            wavs.append(load_wav(os.path.join(corpus_dir, "wavs", f"{utt}{seg}.wav"), 16000)[0])
            labels.append(tc.segment_labels(m[key]))
    return wavs, labels


def _jax_draws(k, n_cls, shape, steps, seed=0):
    """The JAX train_tokenizer's head init and per-step noise."""
    key = jax.random.PRNGKey(seed)
    k_head, key = jax.random.split(key)
    w = np.asarray(0.1 * jax.random.normal(k_head, (k, n_cls), jnp.float32))
    noise = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.uniform(sub, shape, minval=-0.5, maxval=0.5)))
    return (w, np.zeros((n_cls,), np.float32)), noise


def _jax_grads(jfe, wavs, labels, head, noise):
    """The gradient of the JAX recipe's loss (examples/hermetic/corpus.py's
    loss_fn) at the frontend's S3 weights and `head`, over its batch."""
    import optax

    from cosyvoice_tpu.ops.mel import whisper_log_mel

    mod, c = jfe.speech_tokenizer, jfe.speech_tokenizer.cfg
    aug_rng = np.random.default_rng(4242)
    mels, labs = [], []
    for w16, fl in zip(wavs, labels):
        for var in jc._augment_variants(np.asarray(w16, np.float32).reshape(-1), aug_rng):
            mel = jnp.swapaxes(whisper_log_mel(jnp.asarray(var).reshape(1, -1), n_mels=c.n_mels), 1, 2)
            mels.append(np.asarray(mel[0], np.float32))
            labs.append(np.asarray(fl, np.int32))
    T = max(m.shape[0] for m in mels)
    T_tok = ((T + 1) // 2 + c.token_rate_div - 1) // c.token_rate_div
    X = np.zeros((len(mels), T, c.n_mels), np.float32)
    Y = np.full((len(mels), T_tok), -1, np.int32)
    L = np.zeros((len(mels),), np.int32)
    for i, (m, lab) in enumerate(zip(mels, labs)):
        X[i, : m.shape[0]], L[i] = m, m.shape[0]
        Y[i, : min(T_tok, len(lab))] = lab[:T_tok]
    half = jnp.asarray((np.asarray(c.fsq_levels) - 1) / 2.0, jnp.float32)

    def loss_fn(p):
        _, inter = mod.apply({"params": p["s3"]}, jnp.asarray(X), jnp.asarray(L), capture_intermediates=True)
        z = jnp.tanh(inter["intermediates"]["fsq_proj"]["__call__"][0]) + jnp.asarray(noise) / half
        logits = z @ p["head"]["w"] + p["head"]["b"]
        mask = (Y >= 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.maximum(jnp.asarray(Y), 0))
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    params = {"s3": jfe.speech_tokenizer_params["params"], "head": {"w": jnp.asarray(head[0]),
                                                                     "b": jnp.asarray(head[1])}}
    return jax.value_and_grad(loss_fn)(params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def test_train_tokenizer_matches_jax(corpora, tmp_path):
    """Three steps of the port's train_tokenizer against three runs of the
    JAX one (steps 1, 2, 3: each returns its last loss), from the same S3
    weights with JAX's draws; the gradient of the first step against
    jax.grad of the JAX loss, over every S3 weight and the head."""
    import copy

    jd, _ = corpora
    model_dir = _write_config(tmp_path / "model")
    wavs, labels = _supervision(jd)
    jfe = _jax_frontend(model_dir)
    s3_params = jfe.speech_tokenizer_params
    want = []
    for steps in (1, 2, 3):
        jfe.speech_tokenizer_params = s3_params
        want.append(jc.train_tokenizer(jfe, wavs, labels, steps=steps))
    jfe.speech_tokenizer_params = s3_params

    fe = _port_frontend(model_dir, jfe)
    s3 = fe.speech_tokenizer
    X, Y, L = tc.tokenizer_batch(s3, wavs, labels)
    k, n_cls = len(S3["fsq_levels"]), int(max(lab.max() for lab in labels)) + 1
    head, noise = _jax_draws(k, n_cls, (X.shape[0], Y.shape[1], k), 3)

    # the gradient of the first step
    jloss, jgrad = _jax_grads(jfe, wavs, labels, head, noise[0])
    start = copy.deepcopy(s3)
    w, b = (torch.tensor(a, requires_grad=True) for a in head)
    loss = tc.tokenizer_loss(s3, w, b, X, Y, L, torch.from_numpy(noise[0].copy()))
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    g = copy.deepcopy(s3)
    for p, q in zip(g.parameters(), s3.parameters()):
        p.data = q.grad.clone()
    got = _flat({"s3": export_params(g)["params"], "head": {"w": w.grad.numpy(), "b": b.grad.numpy()}})
    ref = _flat(np_tree(jgrad))
    assert sorted(got) == sorted(ref)
    diff = math.sqrt(sum(float(np.sum((got[n] - ref[n]) ** 2)) for n in ref))
    norm = math.sqrt(sum(float(np.sum(ref[n] ** 2)) for n in ref))
    assert diff <= 1e-4 * norm, (diff, norm)

    # three steps of the port's loop from the same start
    s3.load_state_dict(start.state_dict())
    losses = []
    tc.train_tokenizer(fe, wavs, labels, steps=3, head=head, noise=lambda i, shape: torch.from_numpy(noise[i].copy()),
                       losses=losses)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[2] < losses[0]


def test_prep_features_matches_jax(corpora, tmp_path):
    """CAM++ embeddings within 1e-4 and the per-segment S3 tokens equal
    (a token may differ only where an FSQ projection sits within 1e-5 of a
    rounding edge: none does on this corpus)."""
    jd, _ = corpora
    model_dir = _write_config(tmp_path / "model")
    jfe = _jax_frontend(model_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfrontend, "CamPPEmbedding", lambda: JCamPPEmbedding(JCamPPConfig(**CAM)))
        jemb, jtok = jc.prep_features(jd, model_dir)
    emb, tok = tc.prep_features(jd, fe=_port_frontend(model_dir, jfe))
    assert sorted(emb) == sorted(jemb) == sorted(tok)
    for utt in jemb:
        np.testing.assert_allclose(emb[utt], jemb[utt], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tok[utt], jtok[utt])
    with open(os.path.join(jd, "utt2speech_token.pkl"), "rb") as f:
        assert pickle.load(f) == {k: v.tolist() for k, v in tok.items()}


def test_run_rehearses_on_cpu(tmp_path):
    """run.py at 4 utterances, one epoch per model, 5 tokenizer and 5
    pretrain steps, one eval utterance, on the CPU: the metrics and the
    artifact, every metric finite, every stage timed, the process's TF32
    settings (set here to one of each) recorded."""
    out = tmp_path / "q.json"
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        metrics = trun.main(["--work", str(tmp_path / "work"), "--n_utts", "4", "--lm_epochs", "1", "--flow_epochs",
                             "1", "--gan_epochs", "1", "--tok_steps", "5", "--gan_pretrain_steps", "5",
                             "--max_eval_utts", "1", "--device", "cpu", "--out_json", str(out)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert metrics["n"] == 1
    for k in ("cer", "token_recovery", "mel_corr", "speaker_similarity"):
        assert math.isfinite(metrics[k]), metrics
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and art["card"] is None and "thresholds_passed" in art
    assert art["tf32"] == {"cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": True}
    assert set(art["stage_s"]) == {"corpus", "tokenizer", "features", "rows", "train_llm", "train_flow",
                                   "train_hifigan", "assemble", "eval"}
    model = tmp_path / "work" / "model"
    assert all((model / f"{n}.msgpack").exists() for n in ("lm", "flow", "hift", "speech_tokenizer", "campplus"))


def test_recipe_rows_equal_the_parquet_rows(corpora, tmp_path):
    """corpus_rows and shard_rows' opener against make_parquet_list's shards
    read back by parquet_opener (the shards of 2: two of them)."""
    pytest.importorskip("pyarrow")
    from cosyvoice_tpu_torch.data.processor import parquet_opener
    from cosyvoice_tpu_torch.tools import make_parquet_list

    jd, _ = corpora
    rng = np.random.default_rng(0)
    utts = [f"utt{i:03d}" for i in range(4)]
    with open(os.path.join(jd, "utt2embedding.pkl"), "wb") as f:
        pickle.dump({u: rng.standard_normal(192).astype(np.float32) for u in utts}, f)
    with open(os.path.join(jd, "utt2speech_token.pkl"), "wb") as f:
        pickle.dump({u: rng.integers(0, 81, 48).tolist() for u in utts}, f)
    make_parquet_list.main(["--src_dir", jd, "--des_dir", str(tmp_path / "parquet"), "--num_utts_per_parquet", "2"])
    with open(tmp_path / "parquet" / "data.list") as f:
        shards = [line.strip() for line in f if line.strip()]
    want = list(parquet_opener({"src": s} for s in shards))
    data_list, opener = trun.shard_rows(trun.corpus_rows(jd), str(tmp_path / "rows"), per_shard=2)
    with open(data_list) as f:
        names = [line.strip() for line in f if line.strip()]
    got = list(opener({"src": s} for s in names))
    assert len(names) == 2 and len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if key == "audio":
                assert g[key].dtype == w[key].dtype == np.float32
                np.testing.assert_array_equal(g[key], w[key])
            else:
                assert g[key] == w[key], key
    again = list(opener({"src": s} for s in names))  # the opener hands out copies
    again[0]["audio"][:] = 0
    assert np.any(list(opener([{"src": names[0]}]))[0]["audio"] != 0)
