"""The port's host-side quantisers against the JAX package, bit for bit: the
int4p packers, `quantize_lm_params("int4p")` on an fp LM tree (modes "int8"
and "int4": tests/test_torch_quant_modes.py), and the int8
KV-row quantiser; and the converter carrying a quantised tree both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
from cosyvoice_tpu.ops import decode_attention as jda, int4_fused as jint4, quant as jquant
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
from cosyvoice_tpu_torch.ops import decode_attention as tda, int4_fused as tint4, quant as tquant
from tests.test_torch_common import jax_lm_cfg_quant, np_tree, to_port_cfg

torch.set_num_threads(1)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_identical(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg="/".join(path))


@pytest.mark.parametrize(
    "pack,shape",
    [("pack_gemv_int4", (896, 1152)), ("pack_gemv_int4", (256, 128)), ("pack_gate_up_int4", (384, 896)),
     ("pack_down_int4", (448, 384)), ("quantize_tensor_int4_blocked", (64, 128))],
)
def test_packers_are_bit_identical(pack, shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 0.05
    w[0, :3] = 0.0  # an all-but-zero column block keeps the 1e-12 scale floor honest
    (gp, gs), (wp, ws) = getattr(tint4, pack)(w), getattr(jint4, pack)(w)
    assert gp.dtype == wp.dtype == np.int8 and gs.dtype == ws.dtype == np.float32
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gs, ws)


def test_unpack_matches_jax():
    p, s = jint4.pack_gemv_int4(np.random.default_rng(1).standard_normal((384, 256)).astype(np.float32))
    want = np.asarray(jint4.unpack_int4_blocked(jnp.asarray(p), jnp.asarray(s)))
    got = tint4.unpack_int4_blocked(torch.from_numpy(p), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)
    raw = tint4.unpack_int4_blocked(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(raw, np.asarray(jint4.unpack_int4_blocked(jnp.asarray(p))))
    assert raw.min() >= -7 and raw.max() <= 7


@pytest.fixture(scope="module")
def fp_tree():
    jcfg = jax_lm_cfg_quant(quant=False, kv_quant=False)
    return np_tree(JQwen2LM(jcfg).init(jax.random.PRNGKey(0))["params"])


def test_quantize_lm_params_int4p_is_bit_identical(fp_tree):
    got = tquant.quantize_lm_params(fp_tree, "int4p")
    want = jquant.quantize_lm_params(fp_tree, "int4p")
    _assert_trees_identical(got, want)
    assert set(got["llm_decoder"]) == {"kernel_q", "scale", "bias"}
    assert set(got["llm"]["layers_0"]["mlp"]["gate_up_proj"]) == {"kernel_q4b", "scale4"}
    with pytest.raises(ValueError):  # "int8" and "int4" are ported too (tests/test_torch_quant_modes.py)
        tquant.quantize_lm_params(fp_tree, "int2")


def test_quantized_tree_round_trips_through_the_converter(fp_tree):
    """load_jax_params carries the quantised leaves under their own names
    (kernel_q4b, scale4 as they are; the head's kernel_q/scale into the
    QuantDense layout) and export_params gives back the same tree."""
    tree = jquant.quantize_lm_params(fp_tree, "int4p")
    m = Qwen2LMModule(to_port_cfg(jax_lm_cfg_quant(), LMConfig))
    load_jax_params(m, tree)
    assert m.llm_decoder.kernel_q.shape == tree["llm_decoder"]["kernel_q"].shape[::-1]
    assert m.llm_decoder.scale.shape == (tree["llm_decoder"]["scale"].shape[1],)
    _assert_trees_identical(export_params(m)["params"], tree)


def test_converter_rejects_extra_and_missing_quantized_leaves(fp_tree):
    tree = jquant.quantize_lm_params(fp_tree, "int4p")
    m = Qwen2LMModule(to_port_cfg(jax_lm_cfg_quant(), LMConfig))
    head = tree["llm_decoder"]
    with pytest.raises(KeyError, match="no port parameter"):
        load_jax_params(m, {**tree, "llm_decoder": {**head, "kernel": head["kernel_q"]}})
    with pytest.raises(KeyError, match="left unset"):
        load_jax_params(m, {**tree, "llm_decoder": {k: v for k, v in head.items() if k != "scale"}})
    with pytest.raises(KeyError, match="no port parameter"):  # an fp layer where the int4p layout is expected
        load_jax_params(m, {**tree, "llm": {**tree["llm"], "layers_0": fp_tree["llm"]["layers_0"]}})


def test_fp_tree_round_trips_through_the_converter(fp_tree):
    m = Qwen2LMModule(to_port_cfg(jax_lm_cfg_quant(False, False), LMConfig))
    load_jax_params(m, fp_tree)
    _assert_trees_identical(export_params(m)["params"], fp_tree)


def test_quantize_kv_rows_matches_jax_exactly():
    """Inputs built away from .5 ties: x = (k + u) * s with integer k and
    |u| <= 0.4, and each row's absmax exactly 127 * s, so the two
    frameworks' float32 division cannot round to different integers."""
    rng = np.random.default_rng(3)
    B, S, Hkv, d = 2, 5, 2, 64
    s = rng.uniform(0.01, 2.0, (B, S, 1, 1)).astype(np.float32)
    k = rng.integers(-120, 121, (B, S, Hkv, d))
    k[:, :, 0, 0] = np.where(rng.random((B, S)) < 0.5, 127, -127)
    x = ((k + rng.uniform(-0.4, 0.4, k.shape) * (np.abs(k) != 127)) * s).astype(np.float32)
    jq, js = map(np.asarray, jda.quantize_kv_rows(jnp.asarray(x)))
    tq, ts = tda.quantize_kv_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tq.numpy(), k)  # the integers the inputs were built from
    want = np.asarray(jda.dequantize_kv_arena(jnp.asarray(jq), jnp.asarray(js), jnp.float32))
    np.testing.assert_array_equal(tda.dequantize_kv_arena(tq, ts, torch.float32).numpy(), want)
