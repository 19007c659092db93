"""The port's CosyVoice-300M engine (runtime/engine.py:CosyVoiceV1Engine)
against the JAX CosyVoiceV1Engine at tiny width, float32, CPU: one
seeded model pair (the LM greedy, its eos logit raised so that streams
stop), JAX's flow noise (fold_in(PRNGKey(seed), window)) and HiFT draws
handed to the port (`flow_noise`, `hift.source_draws`). Offline (speed 1
and 1.5), streamed with small hops (each window's chunk, the mel and
speech cross-fades, the (z, mu) and HiFT caches, the finalize), a
zero-token finalize (overlap 0, so the windows use every token), vc from
source tokens, `llm_embedding`, and the vocab guard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow_v1 import MaskedDiffFlow as JFlow
from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.models.llm_v1 import TransformerLM as JTransformerLM
from cosyvoice_tpu.runtime.engine import CosyVoiceV1Engine as JEngine
from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config
from cosyvoice_tpu_torch.models.hift import HiFTConfig
from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config
from cosyvoice_tpu_torch.runtime.engine import CosyVoiceV1Engine, build_random_engine_v1
from tests.test_torch_common import jax_flow_v1_cfg, jax_hift_v1_cfg, jax_lm_v1_cfg, np_tree, to_port_cfg
from tests.test_torch_hift_v1 import jax_draws

torch.set_num_threads(1)

ATOL = 1e-3  # float32 wav after LM, flow (2 Euler steps) and HiFT, as tests/test_torch_engine.py
SEED = 1986
EOS_BIAS = 1.0


def _small(eng, overlap=4):
    """Hops 6 -> 12 tokens, `overlap` tokens, 4 mel rows of overlap and
    cache: tiny streams cross several windows."""
    eng.token_min_hop_len, eng.token_max_hop_len, eng.token_overlap_len = 6, 12, overlap
    eng.mel_overlap_len, eng.mel_cache_len = 4, 4
    eng.source_cache_len = 4 * eng.wav_hop
    if isinstance(eng, JEngine):
        eng.mel_window = np.hamming(8)
        eng.speech_window = np.hamming(2 * eng.source_cache_len)


@pytest.fixture(scope="module")
def engines():
    jlm_cfg, jflow_cfg, jhift_cfg = jax_lm_v1_cfg(top_k=1, tau_r=2.0), jax_flow_v1_cfg(), jax_hift_v1_cfg()
    jlm, jflow, jhift = JTransformerLM(jlm_cfg), JFlow(jflow_cfg), JHiFT(jhift_cfg)
    lm_tree = np_tree(jlm.init(jax.random.PRNGKey(0))["params"])
    lm_tree["llm_decoder"]["bias"] = lm_tree["llm_decoder"]["bias"].copy()
    lm_tree["llm_decoder"]["bias"][jlm_cfg.speech_token_size] += EOS_BIAS
    flow_p = jflow.init(jax.random.PRNGKey(1))
    hift_p = jhift.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 80)), jax.random.PRNGKey(3))
    jeng = JEngine(jlm, jflow, jhift, {"params": jax.tree.map(jnp.asarray, lm_tree)}, flow_p, hift_p, seed=SEED)
    eng = build_random_engine_v1(0, "cpu", to_port_cfg(jlm_cfg, LMv1Config), to_port_cfg(jflow_cfg, FlowV1Config),
                                 to_port_cfg(jhift_cfg, HiFTConfig),
                                 trees={"lm": lm_tree, "flow": np_tree(flow_p), "hift": np_tree(hift_p["params"])})
    eng.flow_noise = lambda i, T: torch.from_numpy(
        np.array(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(SEED), i), (1, T, 80))))
    eng.hift.source_draws = lambda L: jax_draws(jax.random.PRNGKey(SEED), L)
    return jeng, eng


def _inputs(seed=0, n_text=5):
    rng = np.random.default_rng(seed)
    return dict(
        text_tokens=rng.integers(0, 100, n_text).astype(np.int32),
        prompt_text_tokens=rng.integers(0, 100, 2).astype(np.int32),
        llm_prompt_speech_token=rng.integers(0, 30, 3).astype(np.int32),
        flow_prompt_speech_token=rng.integers(0, 30, 3).astype(np.int32),
        prompt_speech_feat=rng.random((1, 5, 80)).astype(np.float32),
        flow_embedding=rng.standard_normal((1, 192)).astype(np.float32),
    )


def _assert_chunks(got, want):
    assert [g["tts_speech"].shape for g in got] == [w["tts_speech"].shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["tts_speech"], w["tts_speech"], rtol=0, atol=ATOL, err_msg=f"chunk {i}")


@pytest.mark.parametrize("speed", [1.0, 1.5])
def test_offline_matches_jax(engines, speed):
    jeng, eng = engines
    inputs = _inputs(0, n_text=8)
    want = list(jeng.tts(**inputs, stream=False, speed=speed))
    got = list(eng.tts(**inputs, stream=False, speed=speed))
    assert len(got) == 1 and got[0]["speech_tokens"].size > 0
    _assert_chunks(got, want)
    assert eng.stream_log[-1]["path"] == "finalize"


# seed 0: two windows (the hop doubling 6 -> 12) and the finalize; seed 2
# stops early: one window and the finalize
@pytest.mark.parametrize("seed,n_text,n_chunks", [(0, 8, 3), (2, 6, 2)])
def test_streamed_chunks_match_jax(engines, seed, n_text, n_chunks):
    jeng, eng = engines
    _small(jeng), _small(eng)
    inputs = _inputs(seed, n_text)
    want = list(jeng.tts(**inputs, stream=True))
    got = list(eng.tts(**inputs, stream=True))
    assert len(got) >= n_chunks
    _assert_chunks(got, want)
    assert [c["path"] for c in eng.stream_log] == ["window"] * (len(got) - 1) + ["finalize"]
    assert [len(g["speech_tokens"]) for g in got[:-1]] == [min(6 * 2**i, 12) for i in range(len(got) - 1)]
    # the chunks' tokens are the offline request's, and so is its length in samples
    off = list(eng.tts(**inputs, stream=False))[0]
    np.testing.assert_array_equal(np.concatenate([g["speech_tokens"] for g in got]), off["speech_tokens"])


def test_zero_token_finalize_and_vc_match_jax(engines):
    """vc from 18 source tokens with no overlap: windows of 6 and 12 use every
    token, so the finalize has none and emits the held-back mel."""
    jeng, eng = engines
    _small(jeng, overlap=0), _small(eng, overlap=0)
    inputs = _inputs(3)
    src = np.random.default_rng(9).integers(0, 30, 18).astype(np.int32)
    want = list(jeng.tts(**inputs, stream=True, source_speech_token=src))
    got = list(eng.tts(**inputs, stream=True, source_speech_token=src))
    _assert_chunks(got, want)
    assert len(got[-1]["speech_tokens"]) == 0 and got[-1]["tts_speech"].shape[1] > 0
    want = list(jeng.tts(**inputs, stream=False, source_speech_token=src))
    _assert_chunks(list(eng.tts(**inputs, stream=False, source_speech_token=src)), want)
    # no token at all: an empty wav on both sides
    empty = np.zeros(0, np.int32)
    assert list(eng.tts(**inputs, source_speech_token=empty))[0]["tts_speech"].shape == (1, 0)
    assert list(jeng.tts(**inputs, source_speech_token=empty))[0]["tts_speech"].shape == (1, 0)


def test_llm_embedding_conditions_the_lm(engines):
    jeng, eng = engines
    inputs = _inputs(4)
    llm_emb = np.zeros((1, 192), np.float32)  # the instruct mode's zero speaker row
    want = list(jeng.tts(**inputs, llm_embedding=llm_emb))
    got = list(eng.tts(**inputs, llm_embedding=llm_emb))
    _assert_chunks(got, want)
    plain = list(eng.tts(**inputs))[0]["speech_tokens"]
    assert not np.array_equal(plain, got[0]["speech_tokens"])


def test_vocab_guard_and_stream_speed_raise(engines):
    _, eng = engines
    inputs = _inputs(0)
    with pytest.raises(ValueError, match="codec vocab"):
        list(eng.tts(**{**inputs, "llm_prompt_speech_token": np.array([30], np.int32)}))
    with pytest.raises(ValueError, match="non-stream"):
        list(eng.tts(**inputs, stream=True, speed=1.5))


def test_flow_noise_is_seeded_per_window(engines):
    """Without handed-in noise the flow draws window i's z from flow_seed(i):
    two runs agree, and the streamed chunks stay finite."""
    _, eng = engines
    saved, eng.flow_noise = eng.flow_noise, None
    try:
        inputs = _inputs(5)
        a = list(eng.tts(**inputs))[0]["tts_speech"]
        b = list(eng.tts(**inputs))[0]["tts_speech"]
        np.testing.assert_array_equal(a, b)
        assert eng.flow_seed(1) != eng.flow_seed(0)
    finally:
        eng.flow_noise = saved
