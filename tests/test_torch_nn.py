"""Leaf modules of the PyTorch port against the JAX package, float32, tiny
widths: positional encodings, masks, activations, the 1D conv family (with
weights carried across by the port's converter), rel-pos attention and the
conformer/U-Net blocks the flow is built from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.nn import activation as ja, attention as jatt, conformer as jconf, conv as jconv
from cosyvoice_tpu.nn import embedding as jemb, unet as junet
from cosyvoice_tpu.ops import masks as jmasks
from cosyvoice_tpu_torch.convert import load_jax_params, port_name
from cosyvoice_tpu_torch.nn import activation as ta, attention as tatt, conformer as tconf, conv as tconv
from cosyvoice_tpu_torch.nn import embedding as temb, unet as tunet
from cosyvoice_tpu_torch.ops import masks as tmasks

torch.set_num_threads(1)

ATOL = 1e-5  # float32, small modules


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(jmod, tmod, *args, **kw):
    """Init the flax module on numpy args, carry its params into the torch
    module; returns (torch output, jax output)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    params = jmod.init(jax.random.PRNGKey(0), *jargs, **kw)
    load_jax_params(tmod, jax.tree.map(np.asarray, params["params"]))
    want = jmod.apply(params, *jargs, **kw)
    targs = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a for a in args]
    with torch.inference_mode():
        got = tmod(*targs, **kw)
    return got, want


def _close(got, want, atol=ATOL):
    want = want[0] if isinstance(want, tuple) else want
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_port_name_maps_flax_lists_and_leaves():
    assert port_name(("params", "llm", "layers_3", "mlp", "down_proj", "kernel")) == "llm.layers.3.mlp.down_proj.weight"
    assert port_name(("estimator", "params", "mid_tf_2_1", "norm1", "scale")) == "estimator.mid_tf.2.1.norm1.weight"
    assert port_name(("time_mlp", "linear_1", "bias")) == "time_mlp.linear_1.bias"
    assert port_name(("resblocks_4", "act1_2", "alpha")) == "resblocks.4.act1.2.alpha"


def test_converter_rejects_leftover_and_unset():
    m = tconv.Conv1d(4, 6, 3)
    good = {"kernel": _x(3, 4, 6), "bias": _x(6)}
    load_jax_params(m, good)
    with pytest.raises(KeyError):
        load_jax_params(m, {**good, "extra": _x(2)})
    with pytest.raises(KeyError):
        load_jax_params(m, {"kernel": _x(3, 4, 6)})
    with pytest.raises(ValueError):
        load_jax_params(m, {"kernel": _x(3, 6, 4), "bias": _x(6)})


def test_positional_encodings():
    cos, sin = temb.rope_frequencies(16, 40, 1e6)
    jcos, jsin = jemb.rope_frequencies(16, 40, 1e6)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    x = _x(2, 5, 3, 16)
    np.testing.assert_allclose(
        temb.apply_rope(torch.from_numpy(x), cos[:5], sin[:5]).numpy(),
        np.asarray(jemb.apply_rope(jnp.asarray(x), jcos[:5], jsin[:5])), atol=ATOL,
    )
    pos = np.asarray([[3], [7]])
    np.testing.assert_allclose(
        temb.apply_rope(torch.from_numpy(x[:, :1]), cos[pos], sin[pos]).numpy(),
        np.asarray(jemb.apply_rope_batched(jnp.asarray(x[:, :1]), jcos[pos], jsin[pos])), atol=ATOL,
    )
    pe, jpe = temb.EspnetRelPositionalEncoding(8, 16), jemb.EspnetRelPositionalEncoding(8, 16)
    for size in (5, 9, 40):  # 40 > max_len: the table grows
        np.testing.assert_allclose(pe.position_encoding(size).numpy(), np.asarray(jpe.position_encoding(0, size)))
    t = np.asarray([0.0, 0.37, 1.0], np.float32)
    np.testing.assert_allclose(
        temb.SinusoidalPosEmb(32)(torch.from_numpy(t)).numpy(), np.asarray(jemb.SinusoidalPosEmb(32)(jnp.asarray(t))),
        atol=1e-4,
    )


@pytest.mark.parametrize("chunk", [0, 3])
def test_masks(chunk):
    lens = np.asarray([7, 3], np.int32)
    m = tmasks.make_non_pad_mask(torch.from_numpy(lens), 9)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmasks.make_non_pad_mask(jnp.asarray(lens), 9)))
    np.testing.assert_array_equal(
        tmasks.add_optional_chunk_mask(m[:, None], chunk).numpy(),
        np.asarray(jmasks.add_optional_chunk_mask(jnp.asarray(m.numpy())[:, None], chunk)),
    )
    np.testing.assert_array_equal(tmasks.mask_to_bias(m).numpy(), np.asarray(jmasks.mask_to_bias(jnp.asarray(m.numpy()))))


def test_activations():
    x = _x(3, 6)
    np.testing.assert_allclose(ta.mish(torch.from_numpy(x)).numpy(), np.asarray(ja.mish(jnp.asarray(x))), atol=ATOL)
    _close(*_pair(ja.Snake(6), ta.Snake(6), x))


@pytest.mark.parametrize(
    "jmod,tmod",
    [
        (jconv.Conv1d(6, 3, padding=1), tconv.Conv1d(4, 6, 3, padding=1)),
        (jconv.Conv1d(8, 4, stride=2, padding=1, groups=2), tconv.Conv1d(4, 8, 4, stride=2, padding=1, groups=2)),
        (jconv.WNConv1d(6, 3, padding=3, dilation=3), tconv.WNConv1d(4, 6, 3, padding=3, dilation=3)),
        (jconv.WNConvTranspose1d(5, 11, 5, padding=3), tconv.WNConvTranspose1d(4, 5, 11, 5, padding=3)),
        (jconv.WNConvTranspose1d(3, 16, 8, padding=4), tconv.WNConvTranspose1d(4, 3, 16, 8, padding=4)),
        (jconv.CausalConv1d(6, 3), tconv.CausalConv1d(4, 6, 3)),
        (jconv.Conv1d(6, 1), tconv.Conv1d(4, 6, 1)),
        (jconv.ConvolutionModule(4, 5), tconv.ConvolutionModule(4, 5)),
        (jconv.ConvolutionModule(4, 5, causal=True), tconv.ConvolutionModule(4, 5, causal=True)),
    ],
    ids=["conv", "conv_strided_grouped", "wn_dilated", "wn_transpose_5", "wn_transpose_8", "causal_left",
         "pointwise", "conformer_conv", "conformer_conv_causal"],
)
def test_conv_family(jmod, tmod):
    _close(*_pair(jmod, tmod, _x(2, 13, 4)))


def test_rel_position_attention_and_conformer_layer():
    x = _x(2, 7, 8)
    mask = np.ones((2, 7, 7), bool)
    mask[1, :, 5:] = False
    pe = jemb.EspnetRelPositionalEncoding(8)
    pos = np.asarray(pe.position_encoding(0, 7))
    _close(*_pair(jatt.RelPositionMultiHeadAttention(2, 8), tatt.RelPositionMultiHeadAttention(2, 8),
                  x, x, x, mask, pos), atol=1e-4)
    got, want = _pair(jconf.ConformerEncoderLayer(8, 2, 16, selfattention_layer_type="rel_selfattn"),
                      tconf.ConformerEncoderLayer(8, 2, 16), x, mask, pos)
    _close(got, want, atol=1e-4)
    _close(*_pair(jconf.PreLookaheadLayer(8, 3), tconf.PreLookaheadLayer(8, 8, 3), x))


def test_unet_blocks():
    x = _x(2, 9, 6)
    mask = np.ones((2, 9), np.float32)
    mask[1, 6:] = 0
    t_emb = _x(2, 12, seed=1)
    _close(*_pair(junet.ResnetBlock1D(5, causal=True), tunet.ResnetBlock1D(6, 5, 12), x, mask, t_emb), atol=1e-4)
    bias = np.asarray(jmasks.mask_to_bias(jnp.asarray(mask > 0.5)[:, None, :].repeat(9, axis=1)))
    _close(*_pair(junet.BasicTransformerBlock(2, 4), tunet.BasicTransformerBlock(6, 2, 4), x, bias), atol=1e-4)
