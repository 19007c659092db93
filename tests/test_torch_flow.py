"""The port's CosyVoice2 flow against the JAX package at tiny width, float32:
the upsample-conformer encoder, the causal U-Net estimator and the whole
offline `CausalFlow.inference`, with the same fixed noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu.models.flow_matching import fixed_noise_buffer as j_noise
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.flow_matching import fixed_noise_buffer, t_span_cosine
from tests.test_torch_common import jax_flow_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 2e-4  # float32; mel values O(1) after 3 Euler steps, different summation orders


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_flow_cfg()
    jflow = JCausalFlow(jcfg)
    params = jflow.init(jax.random.PRNGKey(1))
    flow = CausalFlow(to_port_cfg(jcfg, FlowConfig), device="cpu")
    load_jax_params(flow, np_tree(params))
    return jflow, params, flow


def _inputs(seed, L=12, n=9, prompt_mel=6):
    rng = np.random.default_rng(seed)
    tok = np.zeros((1, L), np.int32)
    tok[0, :n] = rng.integers(0, 50, n)
    conds = np.zeros((1, 2 * L, 80), np.float32)
    conds[0, :prompt_mel] = rng.standard_normal((prompt_mel, 80))
    emb = rng.standard_normal((1, 192)).astype(np.float32)
    return tok, np.asarray([n], np.int32), conds, emb


def test_noise_buffer_and_time_span_are_the_jax_ones():
    np.testing.assert_array_equal(fixed_noise_buffer(), j_noise())
    np.testing.assert_allclose(t_span_cosine(10)[[0, 5, 10]], [0.0, 1 - np.cos(np.pi / 4), 1.0], atol=1e-6)


def test_encoder_mu_matches(pair):
    jflow, params, flow = pair
    tok, tl, _, emb = _inputs(0)
    jmu, jmask = jflow.encoder.apply(params["encoder"], jnp.asarray(tok), jnp.asarray(tl))
    with torch.inference_mode():
        mu, mask = flow.encoder(torch.from_numpy(tok).long(), torch.from_numpy(tl))
        spk = flow.encoder.project_spk(torch.from_numpy(emb))
    jspk = jflow.encoder.apply(params["encoder"], jnp.asarray(emb), method="project_spk")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(spk.numpy(), np.asarray(jspk), rtol=0, atol=ATOL)


@pytest.mark.parametrize("padded", [False, True])
def test_estimator_field_matches(pair, padded):
    jflow, params, flow = pair
    rng = np.random.default_rng(3)
    T = 24
    x, mu, cond = (rng.standard_normal((2, T, 80)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, T), np.float32)
    if padded:
        mask[1, 17:] = 0
    t = np.asarray([0.3, 0.8], np.float32)
    spks = rng.standard_normal((2, 80)).astype(np.float32)
    want = jflow.estimator.apply(params["estimator"], *map(jnp.asarray, (x, mask, mu, t, spks, cond)), False)
    with torch.inference_mode():
        got = flow.estimator(*map(torch.from_numpy, (x, mask, mu, t, spks, cond)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed,n", [(1, 9), (2, 12)])
def test_inference_mel_matches(pair, seed, n):
    jflow, params, flow = pair
    tok, tl, conds, emb = _inputs(seed, n=n)
    want = jflow.inference(params, jnp.asarray(tok), jnp.asarray(tl), jnp.asarray(conds), jnp.asarray(emb))
    got = flow.inference(torch.from_numpy(tok).long(), torch.from_numpy(tl), torch.from_numpy(conds), torch.from_numpy(emb))
    assert got.shape == (1, 24, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert np.all(got.numpy()[0, 2 * tl[0] :] == 0)
