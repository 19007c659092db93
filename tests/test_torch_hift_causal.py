"""The port's causal HiFT (CosyVoice3) against the JAX package at tiny width,
float32: the causal convolutions, the f0 predictor and `inference` with
finalize True and False, with the JAX noise buffer handed in; the port's
own noise buffer (in [0, 1), prefix-stable by construction) and the
cumulative re-vocode's prefix stability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.nn.conv import (
    CausalConv1d as JCausalConv1d,
    CausalConv1dDownSample as JDown,
    CausalConv1dUpsample as JUp,
)
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.hift import (
    CAUSAL_NOISE_SAMPLES,
    HiFTConfig,
    HiFTGenerator,
    causal_noise_buffer,
)
from cosyvoice_tpu_torch.nn.conv import CausalConv1d, CausalConv1dDownSample, CausalConv1dUpsample
from tests.test_torch_common import jax_causal_noise, jax_hift_cfg_v3, np_tree, to_port_cfg

torch.set_num_threads(1)

ATOL = 1e-4  # float32 conv stacks, different summation orders


@pytest.fixture(scope="module")
def pair():
    # some samples unvoiced, so that the noise buffer reaches the wav
    jcfg = jax_hift_cfg_v3(nsf_voiced_threshold=0.05)
    jh = JHiFT(jcfg)
    params = jh.init(jax.random.PRNGKey(2), jnp.zeros((1, 12, 80)), jax.random.PRNGKey(3))
    h = HiFTGenerator(to_port_cfg(jcfg, HiFTConfig), device="cpu")
    load_jax_params(h, np_tree(params["params"]))
    h.noise_buffer = jax_causal_noise()
    return jh, params, h


# (name, JAX module, port module, frames of the cache, or None: no cache form)
CONVS = [
    ("left_wn_dilated", lambda: JCausalConv1d(6, 3, dilation=2, weight_norm=True),
     lambda: CausalConv1d(4, 6, 3, dilation=2, weight_norm=True), 4),
    ("right_wn", lambda: JCausalConv1d(6, 4, causal_type="right", weight_norm=True),
     lambda: CausalConv1d(4, 6, 4, causal_type="right", weight_norm=True), 3),
    ("left_plain", lambda: JCausalConv1d(8, 5), lambda: CausalConv1d(4, 8, 5), 4),
    ("down", lambda: JDown(6, 6, 3, weight_norm=False), lambda: CausalConv1dDownSample(4, 6, 6, 3, weight_norm=False),
     None),
    ("up", lambda: JUp(6, 5, 3), lambda: CausalConv1dUpsample(4, 6, 5, 3), None),
]


CASES = [(c, cached) for c in CONVS for cached in (False, True) if not (cached and c[3] is None)]


@pytest.mark.parametrize("jmod,pmod,pad,cached", [c[1:] + (cached,) for c, cached in CASES],
                         ids=[f"{c[0]}-{'cached' if cached else 'zeros'}" for c, cached in CASES])
def test_causal_convs_match_jax(jmod, pmod, pad, cached):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4)).astype(np.float32)
    cache = rng.standard_normal((2, pad, 4)).astype(np.float32) if cached else None
    jm = jmod()
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(4), a.shape), p)  # biases and g too
    m = pmod()
    load_jax_params(m, np_tree(p["params"]))
    want = jm.apply(p, jnp.asarray(x), *([] if cache is None else [jnp.asarray(cache)]))
    got = m(torch.from_numpy(x), *([] if cache is None else [torch.from_numpy(cache)]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_causal_hift_names_round_trip(pair):
    _, params, h = pair
    a = dict(jax.tree_util.tree_leaves_with_path(np_tree(params["params"])))
    b = dict(jax.tree_util.tree_leaves_with_path(export_params(h)["params"]))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("finalize", [True, False])
def test_causal_hift_inference_matches_jax(pair, finalize):
    jh, params, h = pair
    rng = np.random.default_rng(1)
    T = 20
    mel = (rng.standard_normal((1, T, 80)) * 0.5).astype(np.float32)
    jf0 = jh.apply(params, jnp.asarray(mel), finalize, method="predict_f0")
    jwav, jsrc = jh.apply(params, jnp.asarray(mel), jax.random.PRNGKey(5), finalize=finalize, method="inference")
    with torch.inference_mode():
        f0 = h.predict_f0(torch.from_numpy(mel), finalize)
        wav, src = h.inference(torch.from_numpy(mel), torch.Generator().manual_seed(0), finalize=finalize)
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), rtol=0, atol=ATOL)
    assert (f0.numpy() < 0.05).any() and (f0.numpy() > 0.05).any()  # voiced and unvoiced frames
    np.testing.assert_allclose(src.numpy(), np.asarray(jsrc), rtol=0, atol=ATOL)
    want_len = T * 480 if finalize else (T - 3 - 4 - 1) * 480
    assert wav.shape == jwav.shape == (1, want_len)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), rtol=0, atol=ATOL)


def test_port_noise_buffer_is_fixed_uniform_and_prefix_stable(pair):
    """The port's own buffer: uniform in [0, 1), one draw per device from
    a seeded generator (the same values wherever it is made), and indexed
    by sample position, so a longer source starts with the shorter one."""
    buf = causal_noise_buffer(9, "cpu")
    assert buf.shape == (CAUSAL_NOISE_SAMPLES, 9) and buf.dtype == torch.float32
    assert float(buf.min()) >= 0.0 and float(buf.max()) < 1.0
    assert abs(float(buf.mean()) - 0.5) < 1e-3
    assert causal_noise_buffer(9, "cpu") is buf
    jh, params, h = pair
    h2 = HiFTGenerator(h.cfg, device="cpu")
    h2.load_state_dict(h.state_dict())
    f0 = torch.full((1, 30), 0.01)  # unvoiced: the source is noise
    with torch.inference_mode():
        long = h2.source_from_f0(f0, None)
        short = h2.source_from_f0(f0[:, :11], None)
    np.testing.assert_array_equal(long[:, : short.shape[1]].numpy(), short.numpy())
    assert long.std() > 0


def test_cumulative_revocode_prefix_is_stable(pair):
    """The emitted samples of a causal re-vocode do not change as the mel
    grows (the invariant of the engine's cumulative scheme)."""
    _, _, h = pair
    mel = np.random.default_rng(0).standard_normal((1, 32, 80)).astype(np.float32)
    gen = torch.Generator()
    with torch.inference_mode():
        short, _ = h.inference(torch.from_numpy(mel[:, :16]), gen, finalize=False)
        full, _ = h.inference(torch.from_numpy(mel), gen, finalize=False)
    n = short.shape[1]
    assert n == (16 - 8) * 480
    np.testing.assert_allclose(full[:, :n].numpy(), short.numpy(), rtol=0, atol=1e-5)
