"""The port's offline engine end to end against the JAX engine at tiny width,
float32: `tts(stream=False)` from ids and features to the waveform.

The LM decodes greedily (top_k=1, RAS resample disabled) so both engines
draw the same tokens. The HiFT source is pinned by configuration, without
injecting tensors: all samples voiced (threshold -1), no source noise
(sigma 0) and a merge layer that reads only the fundamental, whose phase
starts at 0 (`test_torch_hift.py` holds the random parts by distribution).
The flow noise is the shared fixed buffer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
from cosyvoice_tpu.runtime.engine import CosyVoice2Engine as JEngine
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
from cosyvoice_tpu_torch.runtime.engine import CosyVoice2Engine
from tests.test_torch_common import jax_flow_cfg, jax_hift_cfg, jax_lm_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 1e-3  # float32 wav in [-1, 1] after LM, flow (3 Euler steps) and HiFT


@pytest.fixture(scope="module")
def engines():
    K = jax.random.PRNGKey
    lm_cfg, flow_cfg = jax_lm_cfg(top_k=1, tau_r=2.0), jax_flow_cfg()
    hift_cfg = jax_hift_cfg(nsf_sigma=0.0, nsf_voiced_threshold=-1.0)
    jlm, jflow, jhift = JQwen2LM(lm_cfg), JCausalFlow(flow_cfg), JHiFT(hift_cfg)
    lm_p, flow_p = jlm.init(K(0)), jflow.init(K(1))
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
    return jeng, CosyVoice2Engine(lm, flow, hift, token_bucket=16)


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


def test_streaming_is_refused_not_faked(engines):
    _, eng = engines
    with pytest.raises(NotImplementedError):
        next(eng.tts(**_request(1), stream=True))
