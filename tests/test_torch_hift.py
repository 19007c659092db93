"""The port's HiFT vocoder against the JAX package at tiny width, float32:
STFT/iSTFT and linear resampling, the F0 predictor, `decode(mel, s)` with one
injected source, and the SineGen2 source by its distribution (the two
frameworks draw different random numbers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT, sine_source as j_sine_source
from cosyvoice_tpu.ops.resample import interpolate_linear as j_interp
from cosyvoice_tpu.ops.stft import hann_window as j_hann, istft as j_istft, stft as j_stft
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator, sine_source
from cosyvoice_tpu_torch.ops.resample import interpolate_linear
from cosyvoice_tpu_torch.ops.stft import hann_window, istft, stft
from tests.test_torch_common import jax_hift_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 1e-4  # float32 conv stacks, different summation orders


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_hift_cfg()
    jh = JHiFT(jcfg)
    params = jh.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 80)), jax.random.PRNGKey(3))
    h = HiFTGenerator(to_port_cfg(jcfg, HiFTConfig), device="cpu")
    load_jax_params(h, np_tree(params["params"]))
    return jh, params, h


def test_stft_istft_and_resample_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 400)).astype(np.float32)
    spec = stft(torch.from_numpy(x), 16, 4, hann_window(16))
    jspec = np.asarray(j_stft(jnp.asarray(x), 16, 4, j_hann(16)))
    np.testing.assert_allclose(spec.numpy(), jspec, rtol=0, atol=1e-4)
    back = istft(spec, 16, 4, hann_window(16))
    np.testing.assert_allclose(back.numpy(), np.asarray(j_istft(jnp.asarray(jspec), 16, 4, j_hann(16))), atol=1e-4)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)  # perfect reconstruction
    y = rng.standard_normal((2, 3, 37)).astype(np.float32)
    for out_len in (5, 37, 480):
        np.testing.assert_allclose(
            interpolate_linear(torch.from_numpy(y), out_len).numpy(), np.asarray(j_interp(jnp.asarray(y), out_len)),
            rtol=0, atol=1e-5,
        )


def test_f0_and_decode_with_injected_source(pair):
    jh, params, h = pair
    rng = np.random.default_rng(1)
    T = 10
    mel = rng.standard_normal((1, T, 80)).astype(np.float32)
    s = (0.1 * rng.standard_normal((1, T * 480))).astype(np.float32)
    jf0 = jh.apply(params, jnp.asarray(mel), method="predict_f0")
    jwav = jh.apply(params, jnp.asarray(mel), jnp.asarray(s), method="decode")
    with torch.inference_mode():
        f0 = h.predict_f0(torch.from_numpy(mel))
        wav = h.decode(torch.from_numpy(mel), torch.from_numpy(s))
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), rtol=0, atol=ATOL)
    assert wav.shape == (1, T * 480)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), rtol=0, atol=ATOL)


def _source_stats(sw, f0, sr=24000):
    """Per harmonic: dominant frequency (Hz) and amplitude of the sine part;
    and the residual std after removing it."""
    n = sw.shape[0]
    spec = np.fft.rfft(sw, axis=0)
    peak = np.argmax(np.abs(spec[1:]), axis=0) + 1
    freqs = peak * sr / n
    amps = 2 * np.abs(spec[peak, np.arange(sw.shape[1])]) / n
    return freqs, amps


def test_sine_source_distribution_matches_jax():
    """Voiced (f0 = 200 Hz): harmonic h sits at (h+1)*f0 with amplitude alpha
    and noise std sigma; unvoiced (f0 = 0): Gaussian noise of std alpha/3.
    Both frameworks' sources show the same statistics."""
    cfg = to_port_cfg(jax_hift_cfg(), HiFTConfig)
    L = 48 * 480
    voiced = np.full((2, L), 200.0, np.float32)
    unvoiced = np.zeros((2, L), np.float32)
    gen = torch.Generator().manual_seed(0)
    for f0 in (voiced, unvoiced):
        sw, uv = sine_source(torch.from_numpy(f0), cfg, gen)
        jsw, juv = j_sine_source(jax.random.PRNGKey(0), jnp.asarray(f0), jax_hift_cfg())
        sw, jsw = sw.numpy(), np.asarray(jsw)
        np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
        assert sw.shape == jsw.shape == (2, L, 9)
        for w in (sw, jsw):
            if f0[0, 0] > 0:
                freqs, amps = _source_stats(w[0], 200.0)
                np.testing.assert_allclose(freqs, 200.0 * np.arange(1, 10), rtol=0.01)
                np.testing.assert_allclose(amps, cfg.nsf_alpha, rtol=0.05)
            else:
                assert abs(w.std() - cfg.nsf_alpha / 3) < 0.002 and abs(w.mean()) < 0.002
    # phase starts at 0: the per-harmonic random initial phase is added at
    # sample 0, which the frame-rate linear downsampling never samples
    sw, _ = sine_source(torch.from_numpy(voiced), cfg, gen)
    assert sw[:, 0, :].abs().max().item() < 0.02


def test_inference_shapes_and_finite(pair):
    _, _, h = pair
    mel = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 6, 80)).astype(np.float32))
    wav, s = h.inference(mel, torch.Generator().manual_seed(0))
    assert wav.shape == s.shape == (1, 6 * 480) and torch.isfinite(wav).all()
    assert wav.abs().max() <= 0.99
