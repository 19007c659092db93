"""The port's streaming `tts(stream=True)` against the JAX engine at tiny
width, float32, chunk for chunk: the hop policies; the recompute path, the
incremental path and a crossover mid-stream (a recompute chunk, then the
catch-up chunk over the whole prefix, then incremental chunks and
finalize); a quantised LM; bi-streaming text input; the odd-prompt
finalize, the port's intended difference (ROADMAP C4); the streamed
length against the offline one; a stream closed after its first chunk.

The JAX engine runs at its defaults (fused_stream, incremental_flow, the
speculative first chunk) with its flow_incr_min_tok set per path. The LMs
decode greedily and the HiFT source is pinned by configuration, as in
tests/test_torch_engine.py, whose engines these are (token hop 5, the tiny
flow's chunk size; token bucket 16, mel bucket 8). A `cuda`-marked test holds the
incremental path against the recompute path on a card; the module imports
JAX and the JAX package only inside the CPU tests, so that the card, which
has no JAX, runs it with `python -m pytest tests/test_torch_stream.py -m
cuda`."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.runtime.engine import CosyVoice2Engine, _Prefetcher

torch.set_num_threads(1)

ATOL = 1e-3  # float32 wav in [-1, 1] after LM, flow (3 Euler steps) and HiFT, as the offline engine test

# flow_incr_min_tok per path: above any request (recompute only), 0
# (incremental from the first chunk) and 20 (the 4-token prompt + 16 tokens:
# the second chunk is the catch-up)
PATHS = {"recompute": 10**6, "incremental": 0, "crossover": 20}


@pytest.fixture(scope="module")
def engines():
    from tests.test_torch_common import jax_lm_cfg
    from tests.test_torch_engine import _engines

    return _engines(jax_lm_cfg(top_k=1, tau_r=2.0))


@pytest.fixture(scope="module")
def quant_engines():
    from tests.test_torch_common import jax_lm_cfg_quant
    from tests.test_torch_engine import _engines

    return _engines(jax_lm_cfg_quant(quant="int4p", kv_quant=True, top_k=1, tau_r=2.0), quantize=True)


def _request(seed):
    from tests.test_torch_engine import _request

    return _request(seed)


def _bistream_request(seed):
    from tests.test_torch_engine import _bistream_request

    return _bistream_request(seed)


def _stream(eng, req):
    return list(eng.tts(**req, stream=True))


def _hold(want, got, label):
    """The port's chunks (dicts) against the JAX engine's wavs, chunk for chunk."""
    assert len(got) == len(want), f"{label}: {len(got)} chunks, the JAX engine {len(want)}"
    for i, (w, g) in enumerate(zip(want, got)):
        g = g["tts_speech"]
        assert g.shape == w.shape, f"{label} chunk {i}: {g.shape} vs {w.shape}"
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{label} chunk {i}")


def _paths(eng):
    return [c["path"] for c in eng.stream_log]


# ---------------------------------------------------------------- hop policies

NEXT_HOP = [  # (policy, hop, chunk_index, elapsed_s, token_offset, n_pending), from tests/test_hop_policy.py
    ("doubling", 25, 0, 1.0, 25, 100), ("doubling", 50, 1, 1.0, 50, 100), ("doubling", 100, 2, 1.0, 75, 100),
    ("exponential", 25, 0, 1.0, 0, 0), ("exponential", 25, 3, 1.0, 0, 0),
    ("time_based", 25, 0, 0.01, 25, 100), ("time_based", 25, 2, 0.3, 75, 60), ("time_based", 25, 6, 2.1, 75, 60),
    ("time_based", 100, 2, 3.5, 75, 200), ("time_based", 25, 3, 0.0, 75, 60), ("time_based", 25, 4, 0.5, 100, 7),
]


def _bare(cls, policy):
    """An engine carrying only the state next_hop reads."""
    eng = cls.__new__(cls)
    eng.token_hop_len, eng.token_max_hop_len, eng.stream_scale_factor = 25, 100, 2
    eng.token_rate, eng.hop_policy = 25, policy
    return eng


@pytest.mark.parametrize("policy,hop,ci,elapsed,offset,pending", NEXT_HOP)
def test_next_hop_matches_jax(policy, hop, ci, elapsed, offset, pending):
    from cosyvoice_tpu.runtime.engine import CosyVoice2Engine as JEngine

    args = (hop, ci, elapsed, offset, pending)
    assert _bare(CosyVoice2Engine, policy).next_hop(*args) == _bare(JEngine, policy).next_hop(*args)


def test_unknown_hop_policy_rejected(engines):
    _, eng = engines
    with pytest.raises(ValueError):
        CosyVoice2Engine(eng.lm, eng.flow, eng.hift, hop_policy="bogus")


# ---------------------------------------------------------------- streams


@pytest.mark.parametrize("path", list(PATHS))
def test_stream_matches_jax_engine(engines, path, monkeypatch):
    """Request seed 0 (120 tokens: hops 6, 10, then 20 each, and a finalize
    of 4): every chunk equals the JAX engine's. The port's chunk log shows
    the path each chunk took. The port's speculative first chunk is off,
    so that its first chunk takes the path under test (the fused first
    chunk against the JAX engine's: tests/test_torch_first_chunk.py)."""
    jeng, eng = engines
    monkeypatch.setattr(jeng, "flow_incr_min_tok", PATHS[path])
    monkeypatch.setattr(eng, "flow_incr_min_tok", PATHS[path])
    monkeypatch.setattr(eng, "speculative_first_chunk", False)
    req = _request(0)
    want = [c["tts_speech"] for c in jeng.tts(**req, stream=True)]
    got = _stream(eng, req)
    _hold(want, got, path)
    assert [len(c["speech_tokens"]) for c in got] == [6, 10] + [20] * 5 + [4]
    want_paths = {"recompute": ["recompute"] * 7 + ["finalize-recompute"],
                  "incremental": ["incremental"] * 7 + ["finalize-incremental"],
                  "crossover": ["recompute", "catch-up"] + ["incremental"] * 5 + ["finalize-incremental"]}[path]
    assert _paths(eng) == want_paths
    assert (eng.flow_state_max_bytes > 0) == (path != "recompute")


def test_stream_quantised_lm_matches_jax_engine(quant_engines, monkeypatch):
    """The int4p LM over an int8 arena, crossing to the incremental flow
    mid-stream (request seed 8: 87 tokens): the same chunks as the JAX
    engine's."""
    jeng, eng = quant_engines
    monkeypatch.setattr(jeng, "flow_incr_min_tok", PATHS["crossover"])
    monkeypatch.setattr(eng, "flow_incr_min_tok", PATHS["crossover"])
    req = _request(8)
    want = [c["tts_speech"] for c in jeng.tts(**req, stream=True)]
    got = _stream(eng, req)
    _hold(want, got, "int4p_kv8")
    assert len(got) >= 3 and "catch-up" in _paths(eng)


@pytest.mark.parametrize("seed", [2, 3])
def test_bistream_stream_matches_jax_engine(engines, seed, monkeypatch):
    """`tts(<iterator of text chunks>, stream=True)`: text-in, audio-out
    bi-streaming, against the JAX engine's (which takes its standard path
    for iterator text), crossing to the incremental flow mid-stream (seeds
    whose streams stop before the tiny arena's end: 26 and 130 tokens)."""
    jeng, eng = engines
    monkeypatch.setattr(jeng, "flow_incr_min_tok", PATHS["crossover"])
    monkeypatch.setattr(eng, "flow_incr_min_tok", PATHS["crossover"])
    req = _bistream_request(seed)
    want = [c["tts_speech"] for c in jeng.tts(**{**req, "text_tokens": iter(req["text_tokens"])}, stream=True)]
    got = _stream(eng, {**req, "text_tokens": iter(req["text_tokens"])})
    _hold(want, got, f"bistream seed {seed}")
    assert len(got) >= 3


@pytest.mark.parametrize("path", ["recompute", "crossover"])
def test_odd_prompt_finalize(engines, path, monkeypatch):
    """A 7-row prompt mel for 4 prompt tokens (odd: 7 != 2 * 4). Every chunk
    takes the recompute path (the incremental flow needs an even prompt)
    and the finalize the generic one: the JAX engine's chunks with its
    fused finalize disabled (`_disable_fused_final`, the path its own guard
    would pick). The JAX default finalize, which lacks the guard, drops the
    flow's row past the prompt mel: its last chunk is 480 samples shorter."""
    jeng, eng = engines
    monkeypatch.setattr(jeng, "flow_incr_min_tok", PATHS[path])
    monkeypatch.setattr(eng, "flow_incr_min_tok", PATHS[path])
    req = _request(0)
    req["prompt_speech_feat"] = req["prompt_speech_feat"][:, :7]
    default = [c["tts_speech"] for c in jeng.tts(**req, stream=True)]
    monkeypatch.setattr(jeng, "_disable_fused_final", True, raising=False)
    want = [c["tts_speech"] for c in jeng.tts(**req, stream=True)]
    got = _stream(eng, req)
    _hold(want, got, f"odd prompt, {path}")
    assert _paths(eng) == ["recompute"] * (len(got) - 1) + ["finalize-generic"]
    assert got[-1]["tts_speech"].shape[1] == default[-1].shape[1] + 480
    np.testing.assert_allclose(got[-1]["tts_speech"][:, : default[-1].shape[1] - 480 * 8],
                               default[-1][:, : default[-1].shape[1] - 480 * 8], rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed,path", [(0, "crossover"), (6, "recompute"), (4, "incremental"), (3, "incremental")])
def test_stream_length_equals_offline(engines, seed, path, monkeypatch):
    """The streamed wav's total length is the offline wav's for the same
    tokens, n_tokens * 2 * 480 (seed 6: 29 tokens; 4: 7, fewer than the first
    hop + lookahead, so the finalize alone; 3: 2)."""
    _, eng = engines
    monkeypatch.setattr(eng, "flow_incr_min_tok", PATHS[path])
    req = _request(seed)
    chunks = _stream(eng, req)
    (off,) = list(eng.tts(**req, stream=False))
    tokens = np.concatenate([c["speech_tokens"] for c in chunks])
    np.testing.assert_array_equal(tokens, off["speech_tokens"])
    assert sum(c["tts_speech"].shape[1] for c in chunks) == off["tts_speech"].shape[1] == len(tokens) * 2 * 480


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "lm-prefetch"]


@pytest.mark.parametrize("bistream", [False, True], ids=["text_array", "text_iterator"])
def test_closing_early_frees_the_lm(engines, bistream):
    """A consumer that closes the stream after its first chunk: the LM's
    prefetch thread ends and closes the LM's generator, so the LM takes the
    next request (a second open one would raise). Each request yields many
    more token blocks than the first chunk takes plus what the prefetch
    queue (depth 4) holds twice over (the backlog the stream drains before
    its first chunk, then the queue refilled), so the prefetch thread is
    still decoding or blocked on its full queue at the check, whatever the
    threads' timing: request 0 yields 15 blocks of 8 tokens, bistream
    request 3 yields 15 blocks (130 tokens, the first block of 11), and the
    first chunk takes one block of either."""
    _, eng = engines
    req = _bistream_request(3) if bistream else _request(0)
    if bistream:
        req = {**req, "text_tokens": iter(req["text_tokens"])}
    stream = eng.tts(**req, stream=True)
    first = next(stream)
    assert first["tts_speech"].shape[1] > 0 and len(_prefetch_threads()) == 1
    stream.close()
    assert not _prefetch_threads()
    assert not eng.lm._busy
    (out,) = list(eng.tts(**_request(6), stream=False))
    assert len(out["speech_tokens"]) == 29


def test_prefetcher_reraises_and_stops():
    """The prefetch thread's exception reaches the consumer; close() on a
    blocked producer (full queue) ends it and closes its generator."""
    def failing():
        yield np.arange(3)
        raise RuntimeError("lm failed")

    pf = _Prefetcher(failing())
    assert next(pf).tolist() == [0, 1, 2]
    with pytest.raises(RuntimeError, match="lm failed"):
        next(pf)
    closed = SimpleNamespace(done=False)

    def endless():
        try:
            while True:
                yield np.zeros(1)
        finally:
            closed.done = True

    pf = _Prefetcher(endless(), depth=2)
    next(pf)
    pf.close()
    assert closed.done and not pf._thread.is_alive()


@pytest.mark.cuda
def test_incremental_matches_recompute_on_card():
    """On a card (tiny widths, random weights, a 62-token flow prompt, so the
    first hop is 5 + 3): a stream through the incremental flow
    (flow_incr_min_tok 0) against the same request through the recompute
    path, chunk for chunk, the LM decoding on its own thread and stream
    (its CUDA graphs captured during the first stream) while token->wav
    runs on another; cuDNN deterministic, without TF32."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels and the streams' CUDA streams run only on the GPU")
    from cosyvoice_tpu_torch.models.flow import FlowConfig
    from cosyvoice_tpu_torch.models.flow_decoder import EstimatorConfig
    from cosyvoice_tpu_torch.models.flow_matching import CFMConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine

    qwen = Qwen2Config(hidden_size=384, num_layers=2, num_heads=6, num_kv_heads=2, head_dim=64,
                       intermediate_size=448, vocab_size=1000, max_cache_len=1024)
    flow = FlowConfig(input_size=32, chunk_size=5, attention_heads=2, linear_units=64, num_blocks=2, num_up_blocks=1,
                      estimator=EstimatorConfig(channels=(32,), attention_head_dim=8, n_blocks=1, num_mid_blocks=2,
                                                num_heads=2, static_chunk_size=10), cfm=CFMConfig(n_timesteps=3))
    hift = HiFTConfig(base_channels=32, resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3)),
                      source_resblock_kernel_sizes=(7, 7, 11), source_resblock_dilations=((1,), (1,), (1,)))
    eng = build_random_engine(0, "cuda", LMConfig(qwen=qwen), flow, hift)
    eng.token_bucket, eng.mel_bucket = 16, 8
    rng = np.random.default_rng(0)
    req = dict(text_tokens=rng.integers(0, 1000, 6), prompt_text_tokens=rng.integers(0, 1000, 3),
               llm_prompt_speech_token=rng.integers(0, 6561, 60), flow_prompt_speech_token=rng.integers(0, 6561, 62),
               prompt_speech_feat=rng.standard_normal((1, 124, 80)).astype(np.float32),
               flow_embedding=rng.standard_normal((1, 192)).astype(np.float32))
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.allow_tf32
    cudnn.deterministic, cudnn.allow_tf32 = True, False  # float32 convs, as the tolerance assumes
    runs = {}
    try:
        for name, min_tok in (("incremental", 0), ("recompute", 10**6)):
            eng.flow_incr_min_tok = min_tok
            runs[name] = _stream(eng, req)
            assert [c["path"] for c in eng.stream_log][-1] == f"finalize-{name}"
    finally:
        cudnn.deterministic, cudnn.allow_tf32 = saved
    assert eng.lm.graph_captures > 0 and len(runs["recompute"]) >= 3
    _hold([c["tts_speech"] for c in runs["recompute"]], runs["incremental"], "incremental vs recompute")
