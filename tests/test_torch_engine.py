"""The port's offline engine end to end against the JAX engine at tiny width,
float32: `tts(stream=False)` from ids and features to the waveform, with the
text as an array and as an iterator of chunks (bi-streaming text input).

The LM decodes greedily (top_k=1, RAS resample disabled) so both engines
draw the same tokens. The HiFT source is pinned by configuration, without
injecting tensors: all samples voiced (threshold -1), no source noise
(sigma 0) and a merge layer that reads only the fundamental, whose phase
starts at 0 (`test_torch_hift.py` holds the random parts by distribution).
The flow noise is the shared fixed buffer. The quantised engines (int4p
weights with an int8 KV arena, and with a bf16 arena, whose decode steps run
K7) run both LMs from one tree quantised by the JAX package's
quantize_lm_params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT, Qwen2LM as JQwen2LM
from cosyvoice_tpu.runtime.engine import CosyVoice2Engine as JEngine
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
from cosyvoice_tpu_torch.runtime.engine import CosyVoice2Engine
from tests.test_torch_common import jax_flow_cfg, jax_hift_cfg, jax_lm_cfg, jax_lm_cfg_quant, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 1e-3  # float32 wav in [-1, 1] after LM, flow (3 Euler steps) and HiFT


def _engines(lm_cfg, quantize=False):
    K = jax.random.PRNGKey
    flow_cfg = jax_flow_cfg()
    hift_cfg = jax_hift_cfg(nsf_sigma=0.0, nsf_voiced_threshold=-1.0)
    jlm, jflow, jhift = JQwen2LM(lm_cfg), JCausalFlow(flow_cfg), JHiFT(hift_cfg)
    if quantize:
        from cosyvoice_tpu.ops.quant import quantize_lm_params

        fp_cfg = jax_lm_cfg_quant(quant=False, kv_quant=False)
        lm_p = {"params": quantize_lm_params(np_tree(JQwen2LM(fp_cfg).init(K(0))["params"]), lm_cfg.qwen.quant)}
        lm_p = jax.tree.map(jnp.asarray, lm_p)
    else:
        lm_p = jlm.init(K(0))
    flow_p = jflow.init(K(1))
    hift_p = np_tree(jhift.init(K(2), jnp.zeros((1, 8, 80)), K(3)))
    w = hift_p["params"]["m_source"]["l_linear"]["kernel"].copy()
    w[0, 0], w[1:, 0] = 1.5, 0.0
    hift_p["params"]["m_source"]["l_linear"]["kernel"] = w
    jeng = JEngine(jlm, jflow, jhift, lm_p, flow_p, jax.tree.map(jnp.asarray, hift_p), token_hop_len=5,
                   token_bucket=16, mel_bucket=8)

    lm = Qwen2LM(to_port_cfg(lm_cfg, LMConfig), device="cpu")
    flow = CausalFlow(to_port_cfg(flow_cfg, FlowConfig), device="cpu")
    hift = HiFTGenerator(to_port_cfg(hift_cfg, HiFTConfig), device="cpu")
    load_jax_params(lm.module, np_tree(lm_p["params"]))
    load_jax_params(flow, np_tree(flow_p))
    load_jax_params(hift, hift_p["params"])
    return jeng, CosyVoice2Engine(lm, flow, hift, token_bucket=16, mel_bucket=8)


@pytest.fixture(scope="module")
def engines():
    return _engines(jax_lm_cfg(top_k=1, tau_r=2.0))


@pytest.fixture(scope="module", params=[True, False], ids=["int4p_kv8", "int4p_bf16_arena"])
def quant_engines(request):
    return _engines(jax_lm_cfg_quant(quant="int4p", kv_quant=request.param, top_k=1, tau_r=2.0), quantize=True)


def _request(seed):
    rng = np.random.default_rng(seed)
    return dict(
        text_tokens=rng.integers(0, 100, 6).astype(np.int32),
        prompt_text_tokens=rng.integers(0, 100, 3).astype(np.int32),
        llm_prompt_speech_token=rng.integers(0, 20, 4).astype(np.int32),
        flow_prompt_speech_token=rng.integers(0, 20, 4).astype(np.int32),
        prompt_speech_feat=rng.standard_normal((1, 8, 80)).astype(np.float32),
        flow_embedding=rng.standard_normal((1, 192)).astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_offline_tts_matches_jax_engine(engines, seed):
    jeng, eng = engines
    req = _request(seed)
    want = np.concatenate([c["tts_speech"] for c in jeng.tts(**req, stream=False)], axis=1)
    (out,) = list(eng.tts(**req, stream=False))
    n_tok = len(out["speech_tokens"])
    assert n_tok > 0
    assert out["tts_speech"].shape == want.shape == (1, n_tok * 2 * 480)
    assert np.isfinite(out["tts_speech"]).all()
    np.testing.assert_allclose(out["tts_speech"], want, rtol=0, atol=ATOL)
    assert eng.lm.decode_steps % eng.lm.cfg.block_size == 0


@pytest.mark.parametrize("seed", [0, 3])
def test_offline_tts_quantised_lm_matches_jax_engine(quant_engines, seed, monkeypatch):
    """int4p weights with an int8 KV arena, and with a bf16 arena: the same
    tokens (greedy), and the wav within the float32 engine's limit. With the
    int8 arena the LMs' logits agree to ~1e-6 when no int8 KV step flips;
    with the bf16 arena every decode step is the fused one (the JAX LM's
    Pallas kernel in interpret mode under COSY_INT4_BLOCK=force, the port's
    K7 plain version), whose logits agree to bf16 level
    (tests/test_torch_lm.py): these prompts have no near tie."""
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    jeng, eng = quant_engines
    steps, fused = eng.lm.decode_steps, eng.lm.fused_steps
    req = _request(seed)
    wav = np.concatenate([c["tts_speech"] for c in jeng.tts(**req, stream=False)], axis=1)
    (out,) = list(eng.tts(**req, stream=False))
    # the JAX engine yields only the wav: draw its LM's tokens from the same prompt
    c = eng.lm.cfg
    text = np.concatenate([req["prompt_text_tokens"], req["text_tokens"]])
    ids = np.concatenate([[c.sos_id], text, [c.task_id], req["llm_prompt_speech_token"]]).astype(np.int32)
    types = np.concatenate([[TYPE_SPECIAL], np.full(len(text), TYPE_TEXT), [TYPE_SPECIAL],
                            np.full(len(req["llm_prompt_speech_token"]), TYPE_SPEECH)]).astype(np.int32)
    n_text = len(req["text_tokens"])
    want_tokens = np.concatenate(list(jeng.lm.generate(jeng.lm_params, ids, types, jax.random.PRNGKey(0),
                                                       2 * n_text, 20 * n_text)))
    np.testing.assert_array_equal(out["speech_tokens"], want_tokens)
    n_tok = len(out["speech_tokens"])
    assert n_tok > 0
    assert out["tts_speech"].shape == wav.shape == (1, n_tok * 2 * 480)
    assert np.isfinite(out["tts_speech"]).all()
    np.testing.assert_allclose(out["tts_speech"], wav, rtol=0, atol=ATOL)
    kv_quant = eng.lm.cfg.qwen.kv_quant
    assert eng.lm.fused_steps - fused == (0 if kv_quant else eng.lm.decode_steps - steps)


def _bistream_request(seed):
    """_request(seed) with 14 text ids streamed as uneven chunks (an empty
    one among them); seeds whose greedy streams stop before the tiny arena's
    end."""
    from tests.test_torch_bistream import _chunks

    req = _request(seed)
    req["text_tokens"] = _chunks(np.random.default_rng(100 + seed).integers(0, 100, 14).astype(np.int32))
    return req


def _check_bistream_tts(jeng, eng, seed):
    req = _bistream_request(seed)
    want = np.concatenate([c["tts_speech"] for c in jeng.tts(**{**req, "text_tokens": iter(req["text_tokens"])},
                                                             stream=False)], axis=1)
    (out,) = list(eng.tts(**{**req, "text_tokens": iter(req["text_tokens"])}, stream=False))
    n_tok = len(out["speech_tokens"])
    assert n_tok > 0
    assert out["tts_speech"].shape == want.shape == (1, n_tok * 2 * 480)
    assert np.isfinite(out["tts_speech"]).all()
    np.testing.assert_allclose(out["tts_speech"], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [2, 4])
def test_bistream_tts_matches_jax_engine(engines, seed):
    """`tts` with an iterator of text chunks (bi-streaming text input): the
    same wav as the JAX engine's bistream route."""
    _check_bistream_tts(*engines, seed)


@pytest.mark.parametrize("seed", [2, 4])
def test_bistream_tts_quantised_lm_matches_jax_engine(quant_engines, seed, monkeypatch):
    """The same for int4p weights over an int8 and over a bf16 arena (the
    latter's spans through K7, the JAX LM's Pallas kernel under
    COSY_INT4_BLOCK=force); these requests have no near tie."""
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    _check_bistream_tts(*quant_engines, seed)


@pytest.mark.parametrize("pm,rows", [(5, 3), (8, 0)], ids=["odd_prompt", "even_prompt"])
def test_no_generated_token_matches_jax_engine(engines, pm, rows):
    """`synthesize_offline` with no token (a bistream drain can get there):
    the JAX engine's token2wav route, the flow over the 4 prompt tokens and
    the mel rows from pm to 2 * 4 vocoded. A 5-row prompt mel leaves 3 rows,
    1440 samples; an 8-row one none, an empty wav."""
    jeng, eng = engines
    req = _request(0)
    prompt_token, emb = req["flow_prompt_speech_token"], req["flow_embedding"]
    feat = req["prompt_speech_feat"][:, :pm]
    none = np.zeros(0, np.int32)
    want = jeng.synthesize_offline(none, prompt_token, feat, emb)
    got = eng.synthesize_offline(none, prompt_token, feat, emb)
    assert got.shape == want.shape == (1, rows * 480)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if rows:
        assert np.abs(got).max() > 0


def test_streaming_is_refused_not_faked(engines):
    """Streaming was refused until it was ported; now it must be real, not
    the offline wav in one piece: several chunks, the first of them the
    prompt pad + first hop of tokens, whose wav adds up to the offline
    wav's length for the same tokens (tests/test_torch_stream.py holds the
    chunks against the JAX engine's)."""
    _, eng = engines
    chunks = list(eng.tts(**_request(1), stream=True))
    (off,) = list(eng.tts(**_request(1), stream=False))
    assert len(chunks) >= 2
    assert len(chunks[0]["speech_tokens"]) == 5 + 1  # hop 5, plus the pad of the 4-token prompt to 5
    np.testing.assert_array_equal(np.concatenate([c["speech_tokens"] for c in chunks]), off["speech_tokens"])
    assert sum(c["tts_speech"].shape[1] for c in chunks) == off["tts_speech"].shape[1]
