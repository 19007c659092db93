"""The port's CosyVoice-300M (v1) flow against the JAX package at tiny width,
float32, CPU: the non-causal multi-level U-Net estimator
(models/flow_decoder.py:ConditionalDecoder with Block1D / GroupNorm
resnets, Downsample1D, Upsample1DTranspose), offline and under chunk masks,
over a batch with padded frames and odd lengths; `regulate_inference`'s
head / middle / tail split; and `MaskedDiffFlow.inference` with JAX's
noise z handed over, first window and a window pinned by the (z, mu)
cache, including a finalize window shorter than the cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow_decoder import ConditionalDecoder as JDecoder
from cosyvoice_tpu.models.flow_decoder import EstimatorConfig as JEstimatorConfig
from cosyvoice_tpu.models.flow_v1 import MaskedDiffFlow as JFlow
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.flow_decoder import ConditionalDecoder, EstimatorConfig
from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config, MaskedDiffFlow
from tests.test_torch_checkpoint import assert_same_tree
from tests.test_torch_common import jax_flow_v1_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 1e-4  # float32 vector field / mel through the U-Net and (for the flow) 2 Euler steps


@pytest.mark.parametrize("channels", [(16, 16), (16, 24, 24)], ids=["two_levels", "three_levels"])
@pytest.mark.parametrize("streaming", [False, True])
def test_noncausal_unet_matches_jax_with_padded_frames(channels, streaming):
    """Rows of 23 and 17 valid frames in a 23-frame batch (odd lengths: the
    downsampled mask and the upsampled skip are cut as in JAX); the field
    is compared on every frame (zero past the mask on both sides)."""
    jcfg = JEstimatorConfig(in_channels=320, channels=channels, attention_head_dim=8, n_blocks=1, num_mid_blocks=2,
                            num_heads=2, static_chunk_size=6, causal=False)
    rng = np.random.default_rng(0)
    B, T = 2, 23
    x, mu, cond = (rng.standard_normal((B, T, 80)).astype(np.float32) for _ in range(3))
    mask = (np.arange(T)[None] < np.array([[23], [17]])).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    spks = rng.standard_normal((B, 80)).astype(np.float32)
    jdec = JDecoder(jcfg)
    args = [jnp.asarray(a) for a in (x, mask, mu, t, spks, cond)]
    params = jdec.init(jax.random.PRNGKey(0), *args)
    # non-trivial GroupNorm affine parameters
    tree = jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1,
                        np_tree(params["params"]))
    want = np.asarray(jdec.apply({"params": tree}, *args, streaming))
    dec = load_jax_params(ConditionalDecoder(to_port_cfg(jcfg, EstimatorConfig)), tree)
    with torch.no_grad():
        got = dec(*[torch.from_numpy(a) for a in (x, mask, mu, t, spks, cond)], streaming).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert_same_tree(export_params(dec)["params"], tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_flow_v1_cfg()
    jflow = JFlow(jcfg)
    params = jflow.init(jax.random.PRNGKey(1))
    flow = MaskedDiffFlow(to_port_cfg(jcfg, FlowV1Config), device="cpu")
    load_jax_params(flow, np_tree(params))
    return jflow, params, flow


def _inputs(seed, n_tok, n_prompt=4, prompt_mel=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 30, (1, n_prompt + n_tok)).astype(np.int32),
            rng.random((1, prompt_mel, 80)).astype(np.float32), rng.standard_normal((1, 192)).astype(np.float32))


def _both(jflow, params, flow, tok, n_prompt, pf, emb, key, jcache=None, cache=None):
    jmel, jnew = jflow.inference(params, key, jnp.asarray(tok), n_prompt, jnp.asarray(pf), jnp.asarray(emb),
                                 cache=jcache)
    T = pf.shape[1] + flow.cfg.mel_len(tok.shape[1] - n_prompt)
    z = torch.from_numpy(np.array(jax.random.normal(key, (1, T, 80))))
    mel, new = flow.inference(torch.from_numpy(tok).long(), n_prompt, torch.from_numpy(pf), torch.from_numpy(emb),
                              None, cache=cache, noise=z)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), rtol=0, atol=ATOL)
    for g, w in zip(new, jnew):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    return jnew, new


@pytest.mark.parametrize("n_tok", [6, 40, 70], ids=["short", "at_the_split", "head_mid_tail"])
def test_inference_matches_jax(pair, n_tok):
    jflow, params, flow = pair
    tok, pf, emb = _inputs(n_tok, n_tok)
    _both(jflow, params, flow, tok, 4, pf, emb, jax.random.PRNGKey(0))


def test_cached_windows_match_jax(pair):
    """Three windows: a first one, a longer one pinned by its cache, and a
    finalize window shorter than the cache."""
    jflow, params, flow = pair
    jcache = cache = None
    for i, n_tok in enumerate([30, 60, 8]):
        tok, pf, emb = _inputs(0, n_tok)
        jcache, cache = _both(jflow, params, flow, tok, 4, pf, emb, jax.random.fold_in(jax.random.PRNGKey(1986), i),
                              jcache, cache)
    # a window of T = 20 rows < 34: z[:, T - 34:] is a negative start, its last 14 rows, in both
    assert cache[0].shape == tuple(jcache[0].shape) == (1, 7 + 14, 80)


def test_inference_draws_from_the_generator(pair):
    _, _, flow = pair
    tok, pf, emb = _inputs(1, 12)
    args = (torch.from_numpy(tok).long(), 4, torch.from_numpy(pf), torch.from_numpy(emb))
    a, _ = flow.inference(*args, torch.Generator().manual_seed(3))
    b, _ = flow.inference(*args, torch.Generator().manual_seed(3))
    c, _ = flow.inference(*args, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
