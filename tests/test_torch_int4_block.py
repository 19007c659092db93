"""K7 (the whole int4p decode step) of the PyTorch port against the JAX
package at tiny width: the plain version (what the wrapper runs on CPU
tensors) against the XLA reference `int4_decode_layers_reference` and the
Pallas kernel in interpret mode, the stacked weight layouts, and the
wrapper's checks. The CUDA kernel runs only on a GPU
(tests/test_torch_cuda_kernels.py; chip_smoke.py at full width)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.ops import int4_block as jblock, int4_fused as jint4
from cosyvoice_tpu_torch.ops import int4_block as tblock

torch.set_num_threads(1)

# the widths of tests/test_torch_common.py:jax_lm_cfg_quant (qkv 640, Hkv*d 128)
L, HID, NH, NKV, D, INTER, A = 2, 384, 6, 2, 64, 448, 64
NQ, LANES = NH * D, NKV * D
NQKV = NQ + 2 * LANES
KEYS = ("nw1", "nw2", "qkv_p", "qkv_s", "qkv_b", "o_p", "o_s", "gu_p", "gu_s", "d_p", "d_s")
# float32 against the float32 XLA reference: the same block products and the
# same bf16 rounding points, float32 sums in another order (measured <= 1.2e-7)
ATOL_F32 = 1e-5


def _case(seed):
    """Stacked int4 weights packed by the JAX packers, an input row, rope at
    some angle and a float32 arena."""
    rng = np.random.default_rng(seed)
    w = {k: [] for k in KEYS}
    for _ in range(L):
        qp, qs = jint4.pack_gemv_int4(rng.standard_normal((HID, NQKV)).astype(np.float32) * 0.05)
        op, osc = jint4.pack_gemv_int4(rng.standard_normal((NQ, HID)).astype(np.float32) * 0.05)
        gp, gs = jint4.pack_gate_up_int4(rng.standard_normal((HID, 2 * INTER)).astype(np.float32) * 0.05)
        dp, ds = jint4.pack_down_int4(rng.standard_normal((INTER, HID)).astype(np.float32) * 0.05)
        norms = [(1.0 + 0.1 * rng.standard_normal(HID)).astype(np.float32) for _ in range(2)]
        bias = (rng.standard_normal(NQKV) * 0.05).astype(np.float32)
        for k, v in zip(KEYS, (*norms, qp, qs, bias, op, osc, gp, gs, dp, ds)):
            w[k].append(v)
    w = {k: np.stack(v) for k, v in w.items()}
    x = (rng.standard_normal((1, HID)) * 0.5).astype(np.float32)
    ang = rng.standard_normal((1, D // 2))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    ka = (rng.standard_normal((L, A, LANES)) * 0.5).astype(np.float32)
    va = (rng.standard_normal((L, A, LANES)) * 0.5).astype(np.float32)
    return x, cos, sin, ka, va, w


def _dead(arena, pos, value):
    """The arena with every row >= pos (the stale row AT pos included) set to value."""
    out = arena.copy()
    out[:, pos:] = value
    return out


def _plain(x, cos, sin, pos, ka, va, w, **kw):
    t = torch.from_numpy
    return tblock.int4_decode_layers_plain(
        t(x), t(cos), t(sin), pos, t(ka), t(va), **{k: t(v) for k, v in w.items()}, eps=1e-6,
        out_dtype=torch.float32, **kw,
    )


def _jax(fn, x, cos, sin, pos, ka, va, w, **kw):
    j = jnp.asarray
    return fn(j(x), j(cos), j(sin), pos, j(ka), j(va), **{k: j(v) for k, v in w.items()}, eps=1e-6,
              out_dtype=jnp.float32, **kw)


POSITIONS = [0, 1, 7, A - 1]


@pytest.mark.parametrize("pos", POSITIONS)
def test_plain_matches_xla_reference(pos):
    """Finite garbage in the dead rows and a changed row at pos: neither may
    reach the outputs of either version."""
    x, cos, sin, ka, va, w = _case(0)
    ka, va = _dead(ka, pos, 37.0), _dead(va, pos, -37.0)
    want = _jax(jblock.int4_decode_layers_reference, x, cos, sin, pos, ka, va, w)
    got = _plain(x, cos, sin, pos, ka, va, w)
    for g, r, what in zip(got, want, ("x_out", "k_new", "v_new")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL_F32, err_msg=what)


@pytest.mark.parametrize("pos", POSITIONS)
def test_plain_matches_pallas_interpret(pos):
    """Against the Pallas kernel (interpret mode), which rounds x to bf16 on
    entry, rounds q and p to bf16 for its MXU dots and decodes the nibbles by
    the "fold" scheme: bf16-level differences, compounded over the layers.
    Measured (these widths): one bf16 ulp of x_out (3.1e-2 at |x| ~4-6) and
    <= 1.8e-2 in k_new/v_new. Limit: 2**-5 of each output's largest
    |value|, four bf16 ulps there."""
    x, cos, sin, ka, va, w = _case(1)
    ka, va = _dead(ka, pos, 37.0), _dead(va, pos, -37.0)
    want = _jax(jblock.int4_decode_layers, x, cos, sin, pos, ka, va, w, interpret=True)
    got = _plain(x, cos, sin, pos, ka, va, w)
    for g, r, what in zip(got, want, ("x_out", "k_new", "v_new")):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2**-5 * np.abs(r).max(), err_msg=what)


@pytest.mark.parametrize("pos", [0, 7])
def test_plain_is_nan_safe(pos):
    """NaN in every row >= pos gives the bits of finite garbage there: the
    plain version masks keys AND values before the products (p = 0 times a
    NaN value is still NaN)."""
    x, cos, sin, ka, va, w = _case(2)
    garbage = _plain(x, cos, sin, pos, _dead(ka, pos, 5.0), _dead(va, pos, -5.0), w)
    nan = _plain(x, cos, sin, pos, _dead(ka, pos, np.nan), _dead(va, pos, np.nan), w)
    for g, n in zip(garbage, nan):
        assert torch.isfinite(n).all()
        assert torch.equal(g, n)


def test_plain_rounds_where_asked():
    """round_dtype=float32 is the same function without the bf16 roundings:
    it moves the result by bf16-level amounts, and only then."""
    x, cos, sin, ka, va, w = _case(3)
    bf = _plain(x, cos, sin, 9, ka, va, w)
    f32 = _plain(x, cos, sin, 9, ka, va, w, round_dtype=torch.float32)
    diff = (bf[0] - f32[0]).abs().max().item()
    assert 0 < diff <= 2**-5 * f32[0].abs().max().item()


def test_stack_decode_params_matches_jax_on_the_converted_tree():
    """The port's stack of its loaded layers equals, bit for bit, the JAX
    stack of the layer trees it was loaded from."""
    from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
    from cosyvoice_tpu.ops.quant import quantize_lm_params
    from cosyvoice_tpu_torch.convert import load_jax_params
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
    from tests.test_torch_common import jax_lm_cfg_quant, np_tree, to_port_cfg

    fp = JQwen2LM(jax_lm_cfg_quant(quant=False, kv_quant=False)).init(jax.random.PRNGKey(4))
    tree = quantize_lm_params(np_tree(fp["params"]), "int4p")
    lm = Qwen2LM(to_port_cfg(jax_lm_cfg_quant(quant="int4p", kv_quant=False), LMConfig), device="cpu")
    load_jax_params(lm.module, tree)
    want = jblock.stack_decode_params([tree["llm"][f"layers_{i}"] for i in range(L)])
    got = tblock.stack_decode_params(lm.module.llm.layers)
    assert set(got) == set(want)
    for k in KEYS:
        w = np.asarray(want[k])
        assert got[k].dtype == {np.dtype(np.int8): torch.int8, np.dtype(np.float32): torch.float32}[w.dtype], k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def _torch_args(seed, pos=5):
    x, cos, sin, ka, va, w = _case(seed)
    t = torch.from_numpy
    return (t(x), t(cos), t(sin), torch.tensor([pos], dtype=torch.int32), t(ka), t(va)), {k: t(v) for k, v in w.items()}


def test_cpu_wrapper_is_plain_and_uncounted():
    args, w = _torch_args(5)
    before = tblock.int4_decode_layers.launches
    got = tblock.int4_decode_layers(*args, **w, out_dtype=torch.float32)
    want = tblock.int4_decode_layers_plain(*args, **w, out_dtype=torch.float32)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    assert tblock.int4_decode_layers.launches == before


def test_wrapper_checks_shapes_dtypes_and_devices(monkeypatch):
    (x, cos, sin, pos, ka, va), w = _torch_args(6)
    with pytest.raises(ValueError):
        tblock.int4_decode_layers(x[:, :128], cos, sin, pos, ka, va, **w)
    with pytest.raises(ValueError):
        tblock.int4_decode_layers(x, cos, sin, pos, ka, va[:, :8], **w)
    with pytest.raises(ValueError):
        tblock.int4_decode_layers(x, cos, sin, pos, ka, va, **{**w, "d_s": w["d_s"][..., :128]})
    with pytest.raises(TypeError):
        tblock.int4_decode_layers(x, cos, sin, pos, ka.to(torch.int8), va.to(torch.int8), **w)
    monkeypatch.setattr(tblock, "MAX_FUSED_ARENA", A - 1)
    with pytest.raises(ValueError, match="MAX_FUSED_ARENA"):
        tblock.int4_decode_layers(x, cos, sin, pos, ka, va, **w)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no kernel"):
        tblock.int4_decode_layers(*(t.to("meta") for t in (x, cos, sin, pos, ka, va)),
                                  **{k: v.to("meta") for k, v in w.items()})


# K7's geometry: (A, H, n_kv, nbq, half_q, nqkv, nbo, half_o, nb_in, half_in,
# inter_p, nd, half_d) at full width (an arena of 2048 rows) and at these
# tests' widths
PLAN_SHAPES = {"full": (2048, 896, 2, 4, 128, 1152, 4, 128, 4, 128, 5120, 10, 256),
               "tiny": (A, HID, NKV, 2, 128, NQKV, 2, 128, 2, 128, 512, 1, 256)}
H100_SMEM_OPTIN = 232448  # bytes of shared memory one block may use on an H100


@pytest.mark.parametrize("grid", [132, 16])
@pytest.mark.parametrize("width", ["full", "tiny"])
def test_decode_layers_plan_covers_every_item_once(width, grid):
    """K7's plan: every unit of qkv, o_proj and down (64 columns, a split of
    the scale blocks) and of gate|up (64 columns, whole input) on exactly
    one block, every (column tile, scale block) of the split weights
    exactly once, the per-phase counts within one of each other; every
    attention item (KV head, chunk of the largest live range) on one block
    within its kv_items; every block with work where there are as many units
    as blocks (full width; the tests' widths on 16 blocks)."""
    Ar, H, n_kv, nbq, half_q, nqkv, nbo, half_o, nb_in, half_in, inter, nd, half_d = PLAN_SHAPES[width]
    plan = tblock.decode_layers_plan(grid, *PLAN_SHAPES[width])
    splits = (plan["kq"], plan["ko"], 1, plan["kd"])
    tiles = (nqkv // 64, H // 64, inter // 64, H // 64)
    nbs = (nbq, nbo, nb_in, nd)
    busy = np.zeros(grid, bool)
    for k, ph in enumerate(plan["plan"]):
        assert sorted(u for blk in ph for u in blk) == list(range(tiles[k] * splits[k]))
        sizes = [len(blk) for blk in ph]
        assert max(sizes) - min(sizes) <= 1
        busy |= np.asarray(sizes) > 0
        for b, ids in enumerate(ph):
            assert plan["table"][b, k, 0] == len(ids) and list(plan["table"][b, k, 1 : 1 + len(ids)]) == ids
        cover = np.zeros((nbs[k], tiles[k]), int)
        for blk in ph:
            for u in blk:
                s, tile = divmod(u, tiles[k])
                cover[s * (nbs[k] // splits[k]) : (s + 1) * (nbs[k] // splits[k]), tile] += 1
        assert (cover == 1).all()
    items = n_kv * -(-Ar // tblock.ATTN_CHUNK)
    owners = [i % grid for i in range(items)]
    assert max(owners.count(b) for b in range(grid)) <= plan["kv_items"]
    if width == "full" or grid <= sum(tiles[k] * splits[k] for k in range(4)):
        assert busy.all()
    assert plan["xs_bytes"] >= 2 * max(nbq * 2 * half_q, nbo * 2 * half_o, nb_in * 2 * half_in, inter)


def test_decode_layers_plan_at_full_width():
    """Full width on an H100 (132 SMs): qkv and o_proj split by scale block
    (72 and 56 units of one), down in 5 splits of two (70 units), 80
    gate|up units; one unit of each kind per block at most, one attention
    item per block at 2048 rows (128 items), and a ring of one layer's
    share that fits a block's shared memory; a size the card cannot give is
    refused."""
    plan = tblock.decode_layers_plan(132, *PLAN_SHAPES["full"])
    assert (plan["kq"], plan["ko"], plan["kd"], plan["kv_items"]) == (4, 4, 5, 1)
    assert [int(plan["table"][:, k, 0].max()) for k in range(4)] == [1, 1, 1, 1]
    need = plan["xs_bytes"] + plan["slot_bytes"]
    tblock.check_shared_memory("int4_decode_layers", need, tblock.K7_STATIC_SMEM, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        tblock.check_shared_memory("int4_decode_layers", need, tblock.K7_STATIC_SMEM, need)
