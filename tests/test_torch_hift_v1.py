"""The port's 22.05 kHz HiFT (CosyVoice-300M: SineGen1 source, upsampling
(8, 8), hop 256) against the JAX package at tiny width, float32, CPU:
`sine_source_v1` with JAX's initial phases and noise handed over (voiced
and unvoiced samples), its phase accumulated modulo 1 against a float64
reference over 40 s of audio (where a plain float32 cumulative sum drifts),
and `HiFTGenerator.inference` with JAX's draws (`source_draws`), with and
without a source cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT, sine_source_v1 as j_sine_source_v1
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator, sine_source_v1, v1_hift_config
from tests.test_torch_common import jax_hift_v1_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 1e-4  # float32 conv stacks, different summation orders


def jax_draws(key, L, B=1, H=9):
    """JAX sine_source_v1's (phase, noise) for a source of L samples."""
    k_phase, k_noise = jax.random.split(key)
    phase = jax.random.uniform(k_phase, (B, 1, H), minval=-np.pi, maxval=np.pi).at[:, :, 0].set(0.0)
    return torch.from_numpy(np.array(phase)), torch.from_numpy(np.array(jax.random.normal(k_noise, (B, L, H))))


def test_v1_config_matches_the_jax_api():
    from cosyvoice_tpu.models.hift import HiFTConfig as JHiFTConfig

    want = JHiFTConfig(sampling_rate=22050, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                       source_resblock_kernel_sizes=(7, 11), source_resblock_dilations=((1, 3, 5), (1, 3, 5)))
    cfg = v1_hift_config()
    assert cfg == to_port_cfg(want, HiFTConfig) and cfg.hop_total == 256 and cfg.sinegen_type == "1"
    assert HiFTConfig().sinegen_type == "2"


def test_sine_source_v1_matches_jax():
    cfg = to_port_cfg(jax_hift_v1_cfg(), HiFTConfig)
    rng = np.random.default_rng(0)
    L = 4096
    f0 = np.where(rng.random((2, L)) < 0.7, rng.uniform(80, 400, (2, L)), 0.0).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want, wuv = j_sine_source_v1(key, jnp.asarray(f0), jax_hift_v1_cfg())
    phase, noise = jax_draws(key, L, B=2)
    got, uv = sine_source_v1(torch.from_numpy(f0), cfg, None, phase, noise)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(wuv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    # drawn from a generator: the same seed, the same source; the fundamental starts at phase 0
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    a, _ = sine_source_v1(torch.from_numpy(f0), cfg, gen())
    b, _ = sine_source_v1(torch.from_numpy(f0), cfg, gen())
    assert torch.equal(a, b)


def test_phase_stays_exact_over_long_audio():
    """40 s of a steady 441 Hz f0 at 22.05 kHz: every harmonic's sine
    against the phase of the same float32 per-sample increments summed in
    float64, noise off. The modulo-1 sum stays within 1e-5 of it; a float32
    cumulative sum of the increments is off by far more at the 9th
    harmonic by then."""
    cfg = to_port_cfg(jax_hift_v1_cfg(nsf_sigma=0.0), HiFTConfig)
    L = 40 * 22050
    f0 = torch.full((1, L), 441.0)
    H = cfg.nb_harmonics + 1
    phase = torch.zeros((1, 1, H))
    got, _ = sine_source_v1(f0, cfg, None, phase, torch.zeros((1, L, H)))
    inc = (np.float32(441.0) * np.arange(1, H + 1, dtype=np.float32) / np.float32(22050)).astype(np.float64)
    n = np.arange(1, L + 1, dtype=np.float64)[:, None]
    want = cfg.nsf_alpha * np.sin(2 * np.pi * np.mod(n * inc, 1.0))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-5)
    naive = cfg.nsf_alpha * torch.sin(2 * np.pi * torch.cumsum(f0[..., None] * torch.arange(1, H + 1) / 22050, dim=1))
    assert np.abs(naive[0, -22050:, -1].numpy() - want[-22050:, -1]).max() > 1e-3


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_hift_v1_cfg()
    jh = JHiFT(jcfg)
    params = jh.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 80)), jax.random.PRNGKey(3))
    h = HiFTGenerator(to_port_cfg(jcfg, HiFTConfig), device="cpu")
    load_jax_params(h, np_tree(params["params"]))
    return jh, params, h


@pytest.mark.parametrize("cached", [False, True])
def test_inference_matches_jax_with_its_draws(pair, cached):
    jh, params, h = pair
    rng = np.random.default_rng(1)
    T = 12
    mel = rng.standard_normal((1, T, 80)).astype(np.float32)
    cache = (0.1 * rng.standard_normal((1, 4 * 256))).astype(np.float32) if cached else np.zeros((1, 0), np.float32)
    key = jax.random.PRNGKey(1986)
    jwav, jsrc = jh.apply(params, jnp.asarray(mel), key, jnp.asarray(cache), method="inference")
    h.source_draws = lambda L: jax_draws(key, L)
    try:
        wav, src = h.inference(torch.from_numpy(mel), None, torch.from_numpy(cache))
    finally:
        h.source_draws = None
    assert wav.shape == (1, T * 256)
    np.testing.assert_allclose(src.numpy(), np.asarray(jsrc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), rtol=0, atol=ATOL)
