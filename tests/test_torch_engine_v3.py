"""The port's CosyVoice3 engine end to end against the JAX CosyVoice3Engine at
tiny width, float32 (tests/test_engine_v3.py's configs): offline, streamed
over the recomputed prefix and over the incremental DiT flow, bi-streaming
text input, the silent-token squelch, the bucketed cumulative re-vocode and
incremental == recompute.

The LM decodes greedily (top_k=1, RAS resample disabled), its head's special
columns scaled down so that random streams run past min_len. The causal
HiFT source is deterministic once the noise buffer is fixed: the port is
handed the JAX buffer (its own is drawn differently, ROADMAP C4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
from cosyvoice_tpu.runtime.engine import CosyVoice3Engine as JEngine3
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
from cosyvoice_tpu_torch.runtime.engine import CosyVoice3Engine
from tests.test_torch_common import (
    jax_causal_noise,
    jax_dit_flow_cfg,
    jax_hift_cfg_v3,
    jax_lm_cfg_v3,
    np_tree,
    to_port_cfg,
)

torch.set_num_threads(1)

ATOL = 1e-3  # float32 wav in [-1, 1] after LM, DiT flow (2 Euler steps) and causal HiFT
CHUNK = 5
NEVER = 10**9  # flow_incr_min_tok of a recompute-only engine


def _lm_tree(jcfg, scale):
    """The LM's tree with the head's special columns scaled by `scale`."""
    tree = np_tree(JQwen2LM(jcfg).init(jax.random.PRNGKey(0))["params"])
    k = np.array(tree["llm_decoder"]["kernel"])
    k[:, jcfg.speech_token_size :] *= scale
    return {**tree, "llm_decoder": {"kernel": k}}


def _parts(scale):
    K = jax.random.PRNGKey
    lm_cfg = jax_lm_cfg_v3(top_k=1, tau_r=2.0, block_size=CHUNK + 3)
    flow_cfg = jax_dit_flow_cfg(depth=1)
    hift_cfg = jax_hift_cfg_v3()
    jlm, jflow, jhift = JQwen2LM(lm_cfg), JCausalFlow(flow_cfg), JHiFT(hift_cfg)
    lm_t = _lm_tree(lm_cfg, scale)
    flow_p = jflow.init(K(1))
    hift_p = jhift.init(K(2), jnp.zeros((1, 12, 80)), K(3))
    jparams = ({"params": jax.tree.map(jnp.asarray, lm_t)}, flow_p, hift_p)

    lm = Qwen2LM(to_port_cfg(lm_cfg, LMConfig), device="cpu")
    flow = CausalFlow(to_port_cfg(flow_cfg, FlowConfig), device="cpu")
    hift = HiFTGenerator(to_port_cfg(hift_cfg, HiFTConfig), device="cpu")
    load_jax_params(lm.module, lm_t)
    load_jax_params(flow, np_tree(flow_p))
    load_jax_params(hift, np_tree(hift_p["params"]))
    hift.noise_buffer = jax_causal_noise()
    return (jlm, jflow, jhift) + jparams, (lm, flow, hift)


@pytest.fixture(scope="module")
def parts():
    return _parts(0.2)


def _jax_engine(parts, min_tok=0, mel_bucket=8, incremental=True):
    jlm, jflow, jhift, lm_p, flow_p, hift_p = parts[0]
    return JEngine3(jlm, jflow, jhift, lm_p, flow_p, hift_p, token_hop_len=CHUNK, token_bucket=16,
                    mel_bucket=mel_bucket, flow_incr_min_tok=min_tok, incremental_flow=incremental)


def _engine(parts, min_tok=0, mel_bucket=8):
    eng = CosyVoice3Engine(*parts[1], token_bucket=16, mel_bucket=mel_bucket)
    eng.flow_incr_min_tok = min_tok
    return eng


def _request(seed, n_text=6):
    rng = np.random.default_rng(seed)
    return dict(
        text_tokens=rng.integers(0, 100, n_text).astype(np.int32),
        prompt_text_tokens=rng.integers(0, 100, 3).astype(np.int32),
        llm_prompt_speech_token=rng.integers(0, 20, 4).astype(np.int32),
        flow_prompt_speech_token=rng.integers(0, 20, 4).astype(np.int32),
        prompt_speech_feat=rng.random((1, 8, 80)).astype(np.float32),
        flow_embedding=rng.standard_normal((1, 192)).astype(np.float32),
    )


def _cat(outs):
    return np.concatenate([o["tts_speech"] for o in outs], axis=1)


@pytest.mark.parametrize("seed", [0, 3])
def test_offline_matches_jax(parts, seed):
    req = _request(seed)
    want = _cat(_jax_engine(parts).tts(**req, stream=False))
    (out,) = list(_engine(parts).tts(**req, stream=False))
    n_tok = len(out["speech_tokens"])
    assert n_tok > 2 * len(req["text_tokens"])  # past min_len
    assert out["tts_speech"].shape == want.shape == (1, n_tok * 2 * 480)
    assert np.isfinite(out["tts_speech"]).all()
    np.testing.assert_allclose(out["tts_speech"], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("min_tok", [0, 20, NEVER], ids=["incremental", "crossover", "recompute"])
def test_streaming_matches_jax(parts, min_tok):
    """Chunk for chunk against the JAX engine's streaming: every chunk over
    the incremental DiT flow, switching once prompt + body reach 20 tokens
    (one catch-up chunk), or recomputing the prefix; each chunk re-vocodes
    the cumulative mel. The chunks add up to the offline length."""
    req = _request(5, n_text=8)
    want = [o["tts_speech"] for o in _jax_engine(parts, min_tok).tts(**req, stream=True)]
    eng = _engine(parts, min_tok)
    outs = list(eng.tts(**req, stream=True))
    got = [o["tts_speech"] for o in outs]
    assert len(got) == len(want) >= 4
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, f"chunk {i}"
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=f"chunk {i}")
    paths = [c["path"] for c in eng.stream_log]
    if min_tok == 0:
        assert paths[:-1] == ["incremental"] * (len(paths) - 1) and paths[-1] == "finalize-incremental"
    elif min_tok == NEVER:
        assert set(paths[:-1]) == {"recompute"} and paths[-1] == "finalize-recompute"
    else:
        assert "catch-up" in paths and paths[0] == "recompute"
    n_tok = sum(len(o["speech_tokens"]) for o in outs)
    assert sum(g.shape[1] for g in got) == n_tok * 2 * 480
    (off,) = list(eng.tts(**req, stream=False))
    assert off["tts_speech"].shape[1] == n_tok * 2 * 480


def test_incremental_equals_recompute(parts):
    """The incremental DiT flow over carried arenas gives the recompute's
    chunks (the JAX engine's golden test)."""
    req = _request(9, n_text=8)
    incr = [o["tts_speech"] for o in _engine(parts, 0).tts(**req, stream=True)]
    rec = [o["tts_speech"] for o in _engine(parts, NEVER).tts(**req, stream=True)]
    assert len(incr) == len(rec) >= 3
    for i, (a, b) in enumerate(zip(incr, rec)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3, err_msg=f"chunk {i}")


@pytest.mark.parametrize("min_tok", [0, NEVER], ids=["incremental", "recompute"])
def test_stream_equals_one_pass_under_streaming_masks(parts, min_tok):
    """The chunks of a stream, concatenated, equal its tokens synthesised in
    one pass under the streaming masks (token2wav at the finalize over every
    token): the cumulative causal re-vocode emits what one vocode of the
    whole mel does (chip_smoke.py holds the same at full width)."""
    from cosyvoice_tpu_torch.runtime.engine import SessionState

    req = _request(5, n_text=8)
    eng = _engine(parts, min_tok)
    outs = list(eng.tts(**req, stream=True))
    toks = np.concatenate([o["speech_tokens"] for o in outs])
    eng.flow_incr_min_tok = NEVER
    whole = eng.token2wav(SessionState(), toks, req["flow_prompt_speech_token"], req["prompt_speech_feat"],
                          req["flow_embedding"], 0, finalize=True, stream=True)
    np.testing.assert_allclose(_cat(outs), whole, rtol=0, atol=ATOL)


def test_bucketed_cumulative_vocode_is_exact(parts):
    """Chunks below the finalize pad the cumulative mel to mel_bucket with
    LOG_SILENCE and cut the wav back: the emitted samples equal the
    exact-length re-vocode's (mel_bucket 1)."""
    req = _request(2)
    src = np.random.default_rng(2).integers(0, 20, 40).astype(np.int32)
    bucketed = [o["tts_speech"] for o in _engine(parts, NEVER, 8).tts(**req, stream=True, source_speech_token=src)]
    exact = [o["tts_speech"] for o in _engine(parts, NEVER, 1).tts(**req, stream=True, source_speech_token=src)]
    want = [o["tts_speech"] for o in _jax_engine(parts, NEVER).tts(**req, stream=True, source_speech_token=src)]
    assert len(bucketed) == len(exact) == len(want) >= 3
    for i, (b, e, w) in enumerate(zip(bucketed, exact, want)):
        assert b.shape == e.shape == w.shape, f"chunk {i}"
        np.testing.assert_allclose(b, e, rtol=0, atol=1e-5 * max(np.abs(e).max(), 1e-6), err_msg=f"chunk {i}")
        np.testing.assert_allclose(b, w, rtol=0, atol=ATOL, err_msg=f"chunk {i}")


def test_squelch_matches_jax(parts):
    """Runs of more than 5 silent tokens are cut, across block boundaries,
    as the JAX engine's _squelch cuts them; the count of dropped tokens
    is kept; a v2 engine (no silent tokens) passes blocks through."""
    blocks = [np.asarray(b, np.int32) for b in ([1] * 4, [2, 2, 2, 5], [28] * 7 + [3], [1, 1], [29] * 6)]
    want = [b.tolist() for b in _jax_engine(parts)._squelch(iter(blocks))]
    eng = _engine(parts)
    got = [b.tolist() for b in eng._squelch(iter(blocks))]
    assert got == want
    kept = sum(len(b) for b in got)
    assert eng.squelched == sum(len(b) for b in blocks) - kept == 2 + 2 + 3
    from cosyvoice_tpu_torch.runtime.engine import CosyVoice2Engine

    it = iter(blocks)
    assert CosyVoice2Engine._squelch(eng.__class__.__new__(CosyVoice2Engine), it) is it


def test_squelch_applies_to_generate_not_vc(parts, monkeypatch):
    """The engine squelches the LM's stream (a stream of silent tokens is
    cut after 5) and leaves a vc source as it is."""
    req = _request(0)
    eng = _engine(parts)
    monkeypatch.setattr(eng.lm, "generate", lambda *a, **k: iter([np.full(12, 2, np.int32)]))
    (out,) = list(eng.tts(**req, stream=False))
    assert out["speech_tokens"].tolist() == [2] * 5
    src = np.full(9, 2, np.int32)
    (out,) = list(eng.tts(**req, stream=False, source_speech_token=src))
    assert out["speech_tokens"].tolist() == src.tolist()


@pytest.mark.parametrize("speed", [1.0, 1.5])
def test_no_token_and_speed_paths_match_jax(parts, speed):
    """vc with no source token (the generic finalize) and a speed change,
    vocoded at the exact length, as the JAX engine's v3 token2wav."""
    req = _request(4)
    src = np.random.default_rng(4).integers(0, 20, 0 if speed == 1.0 else 11).astype(np.int32)
    req["prompt_speech_feat"] = req["prompt_speech_feat"][:, :7] if speed == 1.0 else req["prompt_speech_feat"]
    want = _cat(_jax_engine(parts).tts(**req, stream=False, speed=speed, source_speech_token=src))
    got = _cat(_engine(parts).tts(**req, stream=False, speed=speed, source_speech_token=src))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _text_chunks(text):
    return [text[i : i + 3] for i in range(0, len(text), 3)]


def test_bistream_matches_jax():
    """Text as an iterator of id chunks (the LM's bistream decode), offline
    and streamed, against the JAX engine. The head as initialised: the final
    drain stops at a stop id well inside the arena (the JAX LM has no
    capacity guard, ROADMAP C4)."""
    parts = _parts(1.0)
    req = _request(6, n_text=11)
    text = req.pop("text_tokens")
    for stream in (False, True):
        want = [o["tts_speech"] for o in _jax_engine(parts).tts(iter(_text_chunks(text)), **req, stream=stream)]
        got = [o["tts_speech"] for o in _engine(parts).tts(iter(_text_chunks(text)), **req, stream=stream)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
        assert sum(g.shape[1] for g in got) > 0


def test_prefetcher_drains_a_plain_iterator():
    """A streamed vc request's blocks are a list iterator, which has no
    close(): the prefetch thread ends it without one."""
    from cosyvoice_tpu_torch.runtime.engine import _Prefetcher

    blocks = [np.arange(3), np.arange(2)]
    pf = _Prefetcher(iter(blocks))
    assert [b.tolist() for b in pf] == [[0, 1, 2], [0, 1]]
    pf.close()


def test_build_random_engine_v3_tiny(parts):
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine_v3
    from cosyvoice_tpu_torch.utils.config import cosyvoice3_configs

    lm, flow, hift = cosyvoice3_configs()
    assert lm.head_size == 6761 and lm.special_in_speech_table and flow.estimator_type == "dit" and hift.causal
    assert flow.dit.dim == 1024 and flow.dit.depth == 22 and flow.dit_lookahead_channels == 1024
    assert cosyvoice3_configs("int4p")[0].qwen.quant == "int4p"
    _, (plm, pflow, phift) = parts
    eng = build_random_engine_v3(0, "cpu", plm.cfg, pflow.cfg, dataclasses.replace(phift.cfg))
    assert isinstance(eng, CosyVoice3Engine) and eng.lm.module.llm_decoder.bias is None
    (out,) = list(eng.tts(**_request(1), stream=False))
    assert out["tts_speech"].shape == (1, len(out["speech_tokens"]) * 960)
    assert np.isfinite(out["tts_speech"]).all()
