"""K4 (int4 GEMV), K5 (fused int4 MLP) and K6 (fused int4 layer tail) of the
PyTorch port against the JAX package: the plain versions (what the wrappers
run on CPU tensors) against the XLA references in float32, and against the
Pallas kernels in interpret mode, as tests/test_int4_fused.py runs them. The
CUDA kernels run only on a GPU (tests/test_torch_cuda_kernels.py;
chip_smoke.py at full width)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.ops import int4_fused as jint4
from cosyvoice_tpu_torch.ops import int4_fused as tint4

torch.set_num_threads(1)

# float32 against the float32 XLA references: the same block products, the
# plain version's float32 sums in another order
ATOL_F32 = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _gemv_case(seed, B, n_in, n_out):
    rng = _rng(seed)
    p, s = jint4.pack_gemv_int4(rng.standard_normal((n_in, n_out)).astype(np.float32) * 0.05)
    return rng.standard_normal((B, n_in)).astype(np.float32), p, s


def _tail_case(seed, B, hid=384, inter=448):
    rng = _rng(seed)
    w = lambda *sh: rng.standard_normal(sh).astype(np.float32) * 0.05  # noqa: E731
    op, osc = jint4.pack_gemv_int4(w(hid, hid))
    gup, gus = jint4.pack_gate_up_int4(w(hid, 2 * inter))
    dp, ds = jint4.pack_down_int4(w(inter, hid))
    attn, x = rng.standard_normal((B, hid)).astype(np.float32), rng.standard_normal((B, hid)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(hid)).astype(np.float32)
    return attn, x, nw, op, osc, gup, gus, dp, ds


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


# n_in 896 pads to 1024 (the last block's high half is all padding), as the
# full-width qkv and o projections do
GEMV_SHAPES = [(1, 896, 1152), (5, 256, 128), (16, 384, 640)]


@pytest.mark.parametrize("B,n_in,n_out", GEMV_SHAPES)
def test_gemv_plain_matches_xla_reference(B, n_in, n_out):
    x, p, s = _gemv_case(0, B, n_in, n_out)
    want = np.asarray(jint4.int4_matmul_blocked(*_j((x, p, s)), jnp.float32))
    got = tint4.int4_gemv_plain(*_t((x, p, s))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)
    blocked = tint4.int4_matmul_blocked(*_t((x, p, s)), torch.float32).numpy()
    np.testing.assert_allclose(blocked, want, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("B,n_in,n_out", GEMV_SHAPES)
def test_gemv_plain_matches_pallas_interpret(B, n_in, n_out):
    """The Pallas kernel rounds x to bf16 on entry and, in its default "fold"
    scheme, dots bf16(x_lo - x_hi/16) with the low nibbles: two bf16
    roundings of each activation term, each within 2**-8 of it. Limit per
    output: 2**-7 * sum_k |x_k| |W_k,o| (W dequantised)."""
    x, p, s = _gemv_case(1, B, n_in, n_out)
    want = np.asarray(jint4.int4_gemv(*_j((x, p, s)), out_dtype=jnp.float32, interpret=True))
    got = tint4.int4_gemv_plain(*_t((x, p, s))).numpy()
    wd = tint4.unpack_int4_blocked(*_t((p, s))).numpy()[:n_in]
    limit = 2**-7 * (np.abs(x) @ np.abs(wd)) + 1e-6
    assert (np.abs(got - want) <= limit).all(), np.max(np.abs(got - want) / limit)


# K6's rows: the B=1 decode step, an odd count, the batched step (4), the limit
O_MLP_ROWS = [1, 3, 4, 16]


@pytest.mark.parametrize("B", O_MLP_ROWS)
def test_o_mlp_plain_matches_xla_reference(B):
    args = _tail_case(2, B)
    want = np.asarray(jint4.int4_o_mlp_reference(*_j(args), eps=1e-6, dtype=jnp.float32))
    got = tint4.int4_o_mlp_plain(*_t(args), eps=1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)
    # and the unfused prefill path it stands for: o, residual, norm, MLP, residual
    attn, x, nw, op, osc, gup, gus, dp, ds = _t(args)
    x2 = x + tint4.int4_matmul_blocked(attn, op, osc, torch.float32)
    h2 = x2 * torch.rsqrt(x2.square().mean(-1, keepdim=True) + 1e-6) * nw
    unfused = x2 + tint4.int4_mlp_reference(h2, gup, gus, dp, ds, torch.float32)
    np.testing.assert_allclose(got, unfused.numpy(), rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("B", O_MLP_ROWS)
def test_o_mlp_plain_matches_pallas_interpret(B):
    """Against the Pallas kernel (interpret mode, block_inter 512), which
    rounds the attention input, h2 and silu(g)*u to bf16 and uses the fold
    scheme in every product: the plain version in float32 differs by
    bf16-level roundings compounded through o, the norm, gate/up and down.
    Limit: 2**-5 of the output's largest |value|, four bf16 ulps there."""
    args = _tail_case(3, B)
    want = np.asarray(jint4.int4_o_mlp(*_j(args), eps=1e-6, out_dtype=jnp.float32, block_inter=512, interpret=True))
    got = tint4.int4_o_mlp_plain(*_t(args), eps=1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2**-5 * np.abs(want).max())


def _mlp_case(seed, B, hid=384, inter=448):
    """x [B, hid] and gate|up, down weights; intermediate 448 pads to 512."""
    rng = _rng(seed)
    w = lambda *sh: rng.standard_normal(sh).astype(np.float32) * 0.05  # noqa: E731
    gup, gus = jint4.pack_gate_up_int4(w(hid, 2 * inter))
    dp, ds = jint4.pack_down_int4(w(inter, hid))
    return rng.standard_normal((B, hid)).astype(np.float32), gup, gus, dp, ds


# the row counts of the bistream extends K5 serves: 1, a 5-token text feed, 16
MLP_ROWS = [1, 5, 16]


@pytest.mark.parametrize("B", MLP_ROWS)
def test_mlp_plain_matches_xla_reference(B):
    args = _mlp_case(8, B)
    want = np.asarray(jint4.int4_mlp_reference(*_j(args), dtype=jnp.float32))
    got = tint4.int4_mlp_plain(*_t(args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("B", MLP_ROWS)
def test_mlp_plain_matches_pallas_interpret(B):
    """Against the Pallas kernel in interpret mode (one 512-column cell),
    which rounds x and silu(g)*u to bf16 and uses the fold scheme in every
    product: bf16-level roundings compounded through gate/up and down.
    Measured 0.28 %, 0.79 % and 1.3 % of the output's largest |value| at
    B = 1, 5, 16. Limit: 2**-5 of it, four bf16 ulps there, as for K6."""
    args = _mlp_case(9, B)
    want = np.asarray(jint4.int4_mlp(*_j(args), out_dtype=jnp.float32, interpret=True))
    got = tint4.int4_mlp_plain(*_t(args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2**-5 * np.abs(want).max())


def test_mlp_cpu_wrapper_is_plain_uncounted_and_checks_shapes():
    x, gup, gus, dp, ds = _t(_mlp_case(10, 5))
    n5 = tint4.int4_mlp.launches
    assert torch.equal(tint4.int4_mlp(x, gup, gus, dp, ds), tint4.int4_mlp_plain(x, gup, gus, dp, ds))
    assert tint4.int4_mlp.launches == n5
    with pytest.raises(ValueError):
        tint4.int4_mlp(torch.zeros(5, 640), gup, gus, dp, ds)  # more inputs than packed rows
    with pytest.raises(ValueError):
        tint4.int4_mlp(x, gup, gus[:, :, :256], dp, ds)
    with pytest.raises(ValueError):
        tint4.int4_mlp(x, gup, gus, dp[:, :128], ds)  # down takes fewer rows than the intermediate
    with pytest.raises(ValueError, match="no kernel"):
        tint4.int4_mlp(*(t.to("meta") for t in (x, gup, gus, dp, ds)))


def test_cpu_wrappers_are_plain_and_uncounted():
    x, p, s = _t(_gemv_case(4, 2, 384, 256))
    n4, n6 = tint4.int4_gemv.launches, tint4.int4_o_mlp.launches
    assert torch.equal(tint4.int4_gemv(x, p, s), tint4.int4_gemv_plain(x, p, s))
    args = _t(_tail_case(5, 2))
    assert torch.equal(tint4.int4_o_mlp(*args), tint4.int4_o_mlp_plain(*args))
    assert (tint4.int4_gemv.launches, tint4.int4_o_mlp.launches) == (n4, n6)


def test_wrappers_check_shapes_and_devices():
    x, p, s = _t(_gemv_case(6, 2, 384, 256))
    with pytest.raises(ValueError):
        tint4.int4_gemv(x, p, s[:, :128])
    with pytest.raises(ValueError):
        tint4.int4_gemv(torch.zeros(2, 1024), p, s)  # more inputs than packed rows
    with pytest.raises(ValueError, match="no kernel"):
        tint4.int4_gemv(x.to("meta"), p.to("meta"), s.to("meta"))
    attn, xr, nw, *w = _t(_tail_case(7, 2))
    with pytest.raises(ValueError):
        tint4.int4_o_mlp(attn, xr[:, :128], nw, *w)
    with pytest.raises(ValueError, match="no kernel"):
        tint4.int4_o_mlp(*(t.to("meta") for t in (attn, xr, nw, *w)))


# (nb, O): the qkv and o_proj projections of Qwen2-0.5B, the small widths of
# these tests (nb = 1, 2), and scale-block counts past one cluster
PLAN_SHAPES = [(4, 1152), (4, 896), (1, 128), (2, 640), (1, 1152), (12, 896), (16, 64), (3, 48)]


@pytest.mark.parametrize("nb,O", PLAN_SHAPES)
def test_gemv_plan_covers_every_column_and_scale_block_once(nb, O):
    """K4 geometry: the tiles of gemv_plan cover every output column once,
    and the ranks of a cluster take every scale block once per tile; the
    cluster is portable (<= 8 blocks) and, the grid being (cluster, tiles),
    divides the block count."""
    tiles, cluster = tint4.gemv_plan(nb, O)
    assert 1 <= cluster <= min(nb, tint4.K4_MAX_CLUSTER)
    cover = np.zeros(O, int)
    for t in range(tiles):
        cover[t * tint4.K4_COLS : min((t + 1) * tint4.K4_COLS, O)] += 1
    assert (cover == 1).all() and (tiles - 1) * tint4.K4_COLS < O
    blocks = sorted(b for rank in range(cluster) for b in tint4.gemv_scale_blocks(rank, cluster, nb))
    assert blocks == list(range(nb))


@pytest.mark.parametrize("B,bucket", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 16), (16, 16)])
def test_gemv_rows_bucket_fits_the_staging(B, bucket):
    """K4's row bucket covers B, and its staged inputs (bucket x one scale
    block of 256 rows) fit the kernel's shared-memory buffer."""
    assert tint4.gemv_rows(B) == bucket
    assert bucket * tint4.GEMV_IN_ALIGN <= tint4.K4_X_ELEMS


def test_gemv_plan_at_the_lm_shapes():
    """qkv: 36 tiles of 32 columns in clusters of 4 (nb = 4), 144 blocks for
    132 SMs; o_proj: 28 tiles, 112 blocks."""
    assert tint4.gemv_plan(4, 1152) == (36, 4)
    assert tint4.gemv_plan(4, 896) == (28, 4)


# K6 (int4_o_mlp_resident_kernel at B=1, int4_o_mlp_rows_kernel at B > 1):
# (H, nb_o, half_o, nb_in, half_in, inter_p, nd, half_d) at full width and at
# these tests' widths (hidden 384, intermediate 448 -> 512)
O_MLP_SHAPES = {"full": (896, 4, 128, 4, 128, 5120, 10, 256), "tiny": (384, 2, 128, 2, 128, 512, 1, 256)}
H100_SMEM_OPTIN = 232448  # bytes of shared memory one block may use on an H100


def _check_resident_plan(plan, counts, grid, every_block):
    """Every unit of every phase on exactly one block, per-phase counts
    within one of each other, and (where asked) every block with work."""
    busy = np.zeros(grid, bool)
    for ph, n in zip(plan, counts):
        assert len(ph) == grid
        ids = sorted(u for blk in ph for u in blk)
        assert ids == list(range(n))
        sizes = [len(blk) for blk in ph]
        assert max(sizes) - min(sizes) <= 1
        busy |= np.asarray(sizes) > 0
    if every_block:
        assert busy.all()


def _cover_splits(plan_phase, tiles, nb, splits):
    """[nb, tiles] count of the (scale block, column tile) pairs that the
    units (id = split * tiles + tile, nb / splits scale blocks each) cover."""
    cover = np.zeros((nb, tiles), int)
    for blk in plan_phase:
        for u in blk:
            s, tile = divmod(u, tiles)
            cover[s * (nb // splits) : (s + 1) * (nb // splits), tile] += 1
    return cover


@pytest.mark.parametrize("grid", [132, 16])
@pytest.mark.parametrize("width", ["full", "tiny"])
def test_o_mlp_plan_covers_every_unit_once(width, grid):
    """K6's plan: every unit of o_proj (64 columns, a split of the scale
    blocks), gate|up (64 columns, whole input) and down on one block, every
    (column tile, scale block) of o_proj and down exactly once; the table
    the kernel reads says the same; each unit's items fit the kernel's
    buffer; the staged activations fit xs."""
    H, nb_o, half_o, nb_in, half_in, inter, nd, half_d = O_MLP_SHAPES[width]
    plan = tint4.o_mlp_plan(grid, *O_MLP_SHAPES[width])
    tiles, ko, kd = H // 64, plan["ko"], plan["kd"]
    counts = (tiles * ko, inter // 64, tiles * kd)
    _check_resident_plan(plan["plan"], counts, grid, every_block=width == "full" or grid <= sum(counts))
    assert (_cover_splits(plan["plan"][0], tiles, nb_o, ko) == 1).all()
    assert (_cover_splits(plan["plan"][2], tiles, nd, kd) == 1).all()
    table = plan["table"]
    for k, ph in enumerate(plan["plan"]):
        for b, ids in enumerate(ph):
            assert table[b, k, 0] == len(ids) and list(table[b, k, 1 : 1 + len(ids)]) == ids
    for (planes, nb, half), parts in zip(((1, nb_o // ko, half_o), (2, nb_in, half_in), (1, nd // kd, half_d)),
                                         plan["parts"]):
        assert (half // parts) % 8 == 0 and planes * nb * parts <= tint4.RES_MAX_ITEMS
    assert plan["xs_bytes"] >= 2 * max(nb_o * 2 * half_o, nb_in * 2 * half_in, inter) and plan["xs_bytes"] % 128 == 0


def test_o_mlp_units_compute_the_tail_products():
    """The plan's units, each 64 columns of a weight over a split of its
    scale blocks, summed per column in split order give the three products
    of K6 (the kernel's unit decomposition, mirrored on the host)."""
    attn, x, nw, op, osc, gup, gus, dp, ds = _t(_tail_case(11, 1))
    plan = tint4.o_mlp_plan(16, 384, *op.shape[:2], *gup.shape[1:], *dp.shape[:2])
    splits = (plan["ko"], 1, plan["kd"])
    weights = ((op, osc), (gup[0], gus[0]), (dp, ds))
    for (p, s), ph, k in zip(weights, plan["plan"], splits):
        nb, half, n_out = p.shape
        xin = torch.randn(1, nb * 2 * half)
        parts = torch.zeros(k, n_out)
        for blk in ph:
            for u in blk:
                sp, tile = divmod(u, n_out // 64)
                rows, cols = slice(sp * nb // k, (sp + 1) * nb // k), slice(64 * tile, 64 * tile + 64)
                xs = xin[:, sp * (nb // k) * 2 * half : (sp + 1) * (nb // k) * 2 * half]
                parts[sp, cols] = tint4.int4_matmul_blocked(xs, p[rows, :, cols], s[rows, cols], torch.float32)[0]
        np.testing.assert_allclose(parts.sum(0).numpy(), tint4.int4_matmul_blocked(xin, p, s, torch.float32)[0].numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("B", [2, 4, 8, 9, 16])
@pytest.mark.parametrize("width,grid", [("full", 132), ("full", 114), ("tiny", 16), ("tiny", 4)])
def test_o_mlp_rows_plan_covers_every_unit_once(width, grid, B):
    """K6's plan at B > 1 (int4_o_mlp_rows_kernel): the same units as at
    B=1, every unit of every phase on exactly one block, every (column
    tile, scale block) of o_proj and down once; the table the kernel reads
    says the same; each unit's items fit K5's item buffer; the staged rows
    (each o unit's split of attn, h2, each down unit's split of act) fit
    xs; the items' sums and x2 [B, H] in f32 fit red."""
    H, nb_o, half_o, nb_in, half_in, inter, nd, half_d = O_MLP_SHAPES[width]
    plan = tint4.o_mlp_plan(grid, *O_MLP_SHAPES[width], B)
    one = tint4.o_mlp_plan(grid, *O_MLP_SHAPES[width])
    assert plan["plan"] == one["plan"] and (plan["ko"], plan["kd"], plan["img_bytes"]) == (one["ko"], one["kd"],
                                                                                          one["img_bytes"])
    tiles, ko, kd, rows = H // 64, plan["ko"], plan["kd"], plan["rows"]
    assert rows == (8 if B <= 8 else 16) and rows >= B
    counts = (tiles * ko, inter // 64, tiles * kd)
    _check_resident_plan(plan["plan"], counts, grid, every_block=width == "full" or grid <= sum(counts))
    assert (_cover_splits(plan["plan"][0], tiles, nb_o, ko) == 1).all()
    assert (_cover_splits(plan["plan"][2], tiles, nd, kd) == 1).all()
    table = plan["table"]
    for k, ph in enumerate(plan["plan"]):
        for b, ids in enumerate(ph):
            assert table[b, k, 0] == len(ids) and list(table[b, k, 1 : 1 + len(ids)]) == ids
    shapes = ((1, nb_o // ko, half_o), (2, nb_in, half_in), (1, nd // kd, half_d))
    for (planes, nb, half), parts in zip(shapes, plan["parts"]):
        assert (half // parts) % 8 == 0 and planes * nb * parts <= tint4.MLP_MAX_ITEMS
    maxu = plan["maxu"]
    need = max(maxu * rows * (nb_o // ko * 2 * half_o + 8), rows * (nb_in * 2 * half_in + 8),
               maxu * rows * (nd // kd * 2 * half_d + 8)) * 2
    assert plan["xs_bytes"] >= need and plan["xs_bytes"] % 128 == 0
    assert plan["red_bytes"] >= max(tint4.MLP_MAX_ITEMS * 2 * rows * 32 * 4, B * H * 4) and plan["red_bytes"] % 128 == 0


def test_o_mlp_rows_plan_fits_an_h100_block_at_16_rows():
    """At full width on 132 SMs, 16 rows: o_proj in 4 splits (56 units of
    one scale block, 16 items of 8 rows), gate|up 80 units, down in 5 splits
    (70 units), at most one unit of each phase per block; the block's
    dynamic and static shared memory fit an H100 block, and a size the card
    cannot give is refused."""
    plan = tint4.o_mlp_plan(132, *O_MLP_SHAPES["full"], 16)
    assert (plan["ko"], plan["kd"], plan["maxu"], plan["parts"]) == (4, 5, 1, (16, 2, 8))
    assert [sum(1 for ids in ph if ids) for ph in plan["plan"]] == [56, 80, 70]
    need = plan["xs_bytes"] + plan["red_bytes"] + plan["img_bytes"]
    tint4.check_shared_memory("int4_o_mlp", need, tint4.K6_ROWS_STATIC_SMEM, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        tint4.check_shared_memory("int4_o_mlp", need, tint4.K6_ROWS_STATIC_SMEM, need)


def _units_product(xs, p, s, blocks, half, parts, cols):
    """One plane of a unit as int4_o_mlp_rows_kernel sums it: items (scale
    block, part of its rows), each times the block's scales, in item order;
    xs [B, len(blocks) * 2 * half]."""
    out, rows = 0, half // parts
    for b in blocks:
        for part in range(parts):
            r = slice(part * rows, (part + 1) * rows)
            xb = xs[:, (b - blocks[0]) * 2 * half :]
            y = xb[:, r] @ ((p[b, r, cols] & 15) - 8).float() + xb[:, half:][:, r] @ (p[b, r, cols] >> 4).float()
            out = out + y * s[b, cols]
    return out


def _o_mlp_by_units(attn, x, nw, op, osc, gup, gus, dp, ds, grid=16, eps=1e-6):
    """K6's unit decomposition at B > 1 on the host, as the kernel computes
    it: o units write f32 partials per split; x2 = x + the partials summed
    in split order; h2 = bf16(rmsnorm(x2) * w); gate|up units give act =
    bf16(silu(g) * u); down units write partials per split; out = bf16(x2 +
    the partials summed in split order). Returns (out, (the o product, the
    gate and up products, the down product) as the units sum them)."""
    B, H = x.shape
    nb_o, half_o, _ = op.shape
    _, nb_in, half_in, inter = gup.shape
    nd, half_d, _ = dp.shape
    plan = tint4.o_mlp_plan(grid, H, nb_o, half_o, nb_in, half_in, inter, nd, half_d, B)
    ko, kd, (parts_o, parts_g, parts_d), tiles = plan["ko"], plan["kd"], plan["parts"], H // 64

    def splits(ph, p, s, xin, k, parts, half):
        nbu, part = p.shape[0] // k, torch.zeros(k, B, H)
        for blk in ph:
            for uid in blk:
                sp, tile = divmod(uid, tiles)
                cols = slice(64 * tile, 64 * tile + 64)
                xs = xin[:, sp * nbu * 2 * half : (sp + 1) * nbu * 2 * half]
                part[sp, :, cols] = _units_product(xs, p, s, range(sp * nbu, (sp + 1) * nbu), half, parts, cols)
        total = part[0]
        for sp in range(1, k):
            total = total + part[sp]
        return total

    a = torch.nn.functional.pad(attn.to(torch.bfloat16).float(), (0, nb_o * 2 * half_o - attn.shape[1]))
    o = splits(plan["plan"][0], op, osc, a, ko, parts_o, half_o)
    x2 = x.float() + o
    h2 = (x2 * torch.rsqrt(x2.square().mean(-1, keepdim=True) + eps) * nw).to(torch.bfloat16).float()
    h2 = torch.nn.functional.pad(h2, (0, nb_in * 2 * half_in - H))
    gate, up = torch.zeros(B, inter), torch.zeros(B, inter)
    for blk in plan["plan"][1]:
        for tile in blk:
            cols = slice(64 * tile, 64 * tile + 64)
            gate[:, cols], up[:, cols] = (_units_product(h2, gup[pl], gus[pl], range(nb_in), half_in, parts_g, cols)
                                          for pl in (0, 1))
    act = (torch.nn.functional.silu(gate) * up).to(torch.bfloat16).float()
    down = splits(plan["plan"][2], dp, ds, act, kd, parts_d, half_d)
    return (x2 + down).to(torch.bfloat16), (o, gate, up, down)


@pytest.mark.parametrize("B", [4, 16])
def test_o_mlp_rows_units_compute_the_tail(B):
    """The plan's units at B > 1 (64 columns over a split of the scale
    blocks, items of K5's size summed in item order, splits in split order)
    give K6's three products within 1e-5 of int4_matmul_blocked on the same
    inputs, and the tail with the kernel's rounding points within two bf16
    ulps at the largest |reference| of int4_o_mlp_plain."""
    attn, x, nw, op, osc, gup, gus, dp, ds = _t(_tail_case(13, B))
    xb = x.to(torch.bfloat16)
    out, (o, gate, up, down) = _o_mlp_by_units(attn, xb, nw, op, osc, gup, gus, dp, ds)
    a = attn.to(torch.bfloat16).float()
    np.testing.assert_allclose(o.numpy(), tint4.int4_matmul_blocked(a, op, osc, torch.float32).numpy(), rtol=0,
                               atol=1e-5)
    x2 = xb.float() + o
    h2 = (x2 * torch.rsqrt(x2.square().mean(-1, keepdim=True) + 1e-6) * nw).to(torch.bfloat16).float()
    for got, pl in ((gate, 0), (up, 1)):
        want = tint4.int4_matmul_blocked(h2, gup[pl], gus[pl], torch.float32)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    act = (torch.nn.functional.silu(gate) * up).to(torch.bfloat16).float()
    np.testing.assert_allclose(down.numpy(), tint4.int4_matmul_blocked(act, dp, ds, torch.float32).numpy(), rtol=0,
                               atol=1e-5)
    plain = tint4.int4_o_mlp_plain(attn, xb, nw, op, osc, gup, gus, dp, ds).float()
    np.testing.assert_allclose(out.float().numpy(), plain.numpy(), rtol=0, atol=2**-6 * plain.abs().max().item())


def test_item_parts_and_shared_memory_limit():
    """Items per scale block keep a unit within the kernel's item buffer and
    rows per item a multiple of 8; K6 at full width fits an H100 block's
    shared memory, and a size the card cannot give is refused."""
    assert tint4.item_parts(1, 1, 1, 128) == 16  # a qkv / o_proj unit of one scale block: one item per warp
    assert tint4.item_parts(1, 2, 4, 128) == 2  # a gate|up unit: 16 items of 64 rows
    assert tint4.item_parts(1, 1, 2, 256) == 8  # a down unit of two scale blocks: 16 items of 32 rows
    with pytest.raises(ValueError):
        tint4.item_parts(1, 2, 40, 128)
    assert (tint4.input_splits(4, 14, 132), tint4.input_splits(10, 14, 132), tint4.input_splits(1, 6, 16)) == (4, 5, 1)
    plan = tint4.o_mlp_plan(132, *O_MLP_SHAPES["full"])
    need = plan["xs_bytes"] + plan["img_bytes"]
    tint4.check_shared_memory("int4_o_mlp", need, tint4.K6_STATIC_SMEM, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        tint4.check_shared_memory("int4_o_mlp", need, tint4.K6_STATIC_SMEM, need)


# K5 (int4_mlp_kernel): (H, nb_in, half_in, inter_p, nd, half_d) at full
# width and at these tests' widths (hidden 384, intermediate 448 -> 512)
MLP_SHAPES = {"full": (896, 4, 128, 5120, 10, 256), "tiny": (384, 2, 128, 512, 1, 256)}


@pytest.mark.parametrize("B", [5, 16])
@pytest.mark.parametrize("width,grid", [("full", 132), ("full", 114), ("tiny", 132), ("tiny", 4)])
def test_mlp_plan_covers_every_unit_once(width, grid, B):
    """K5's plan: every gate|up unit (64 columns, both planes, whole input)
    and every down unit (64 columns, a split of the scale blocks) on exactly
    one block, per-phase counts within one of each other, every (column
    tile, scale block) of down once; the table the kernel reads says the
    same; each unit's items fit the kernel's item buffer; the staged rows of
    x and of each down unit's split of act fit xs; the whole fits an H100
    block's shared memory."""
    H, nb_in, half_in, inter, nd, half_d = MLP_SHAPES[width]
    plan = tint4.mlp_plan(grid, *MLP_SHAPES[width], B)
    tiles, kd, rows = H // 64, plan["kd"], plan["rows"]
    assert rows == (8 if B <= 8 else 16) and rows >= B
    counts = (inter // 64, tiles * kd)
    _check_resident_plan(plan["plan"], counts, grid, every_block=False)
    assert (_cover_splits(plan["plan"][1], tiles, nd, kd) == 1).all()
    table = plan["table"]
    for k, ph in enumerate(plan["plan"]):
        for b, ids in enumerate(ph):
            assert table[b, k, 0] == len(ids) and list(table[b, k, 1 : 1 + len(ids)]) == ids
    for (planes, nb, half), parts in zip(((2, nb_in, half_in), (1, nd // kd, half_d)), plan["parts"]):
        assert (half // parts) % 8 == 0 and planes * nb * parts <= tint4.MLP_MAX_ITEMS
    maxd = max(len(ids) for ids in plan["plan"][1])
    need = max(rows * (nb_in * 2 * half_in + 8), maxd * rows * (nd // kd * 2 * half_d + 8)) * 2
    assert plan["xs_bytes"] >= need and plan["xs_bytes"] % 128 == 0
    assert plan["red_bytes"] == tint4.MLP_MAX_ITEMS * 2 * rows * 32 * 4
    sizes = [tint4.unit_bytes(2, nb_in, half_in), tint4.unit_bytes(1, nd // kd, half_d)]
    assert plan["img_bytes"] == max(sum(len(ph[b]) * n for ph, n in zip(plan["plan"], sizes)) for b in range(grid))
    dyn = plan["xs_bytes"] + plan["red_bytes"] + plan["img_bytes"]
    tint4.check_shared_memory("int4_mlp", dyn, tint4.K5_STATIC_SMEM, H100_SMEM_OPTIN)


def test_mlp_plan_at_full_width_and_refusals():
    """At full width on 132 SMs: 80 gate|up units on 80 blocks, down in 5
    splits of two scale blocks (70 units on 70 blocks), 16 items per unit;
    a block needs ~147 KB at 5 rows and ~195 KB at 16. A size the card
    cannot give is refused, and so is a unit with more items than the
    kernel's buffer."""
    for B, dyn_max in ((5, 151_000), (16, 200_000)):
        plan = tint4.mlp_plan(132, *MLP_SHAPES["full"], B)
        assert plan["kd"] == 5 and plan["parts"] == (2, 8) and plan["maxu"] == 1
        assert [sum(1 for ids in ph if ids) for ph in plan["plan"]] == [80, 70]
        need = plan["xs_bytes"] + plan["red_bytes"] + plan["img_bytes"]
        assert need + tint4.K5_STATIC_SMEM <= dyn_max
        with pytest.raises(ValueError, match="shared memory"):
            tint4.check_shared_memory("int4_mlp", need, tint4.K5_STATIC_SMEM, need)
    with pytest.raises(ValueError):
        tint4.item_parts(1, 2, 9, 128, max_items=tint4.MLP_MAX_ITEMS)  # 18 items of whole scale blocks


def _mlp_by_units(x, gup, gus, dp, ds, grid=16):
    """K5's unit decomposition on the host, as the kernel computes it: each
    gate|up unit (64 columns, both planes) sums its items (a part of one
    scale block's rows, times the block's scales) in item order per plane,
    then act = bf16(silu(g) * u); each down unit sums its items over its
    split's scale blocks into a partial; each column tile's partials are
    summed in split order and rounded once to bf16."""
    B = x.shape[0]
    _, nb_in, half_in, inter = gup.shape
    nd, half_d, H = dp.shape
    plan = tint4.mlp_plan(grid, H, nb_in, half_in, inter, nd, half_d, B)
    kd, (parts_g, parts_d), tiles = plan["kd"], plan["parts"], H // 64
    xin = torch.nn.functional.pad(x.float(), (0, nb_in * 2 * half_in - x.shape[1]))

    def unit(xs, p, s, blocks, half, parts, cols):
        """Items of one plane: (scale block, part of its rows), each times
        the block's scales, summed in item order."""
        out, rows = 0, half // parts
        for b in blocks:
            for part in range(parts):
                r = slice(part * rows, (part + 1) * rows)
                xb = xs[:, (b - blocks[0]) * 2 * half :]
                y = xb[:, r] @ ((p[b, r, cols] & 15) - 8).float() + xb[:, half:][:, r] @ (p[b, r, cols] >> 4).float()
                out = out + y * s[b, cols]
        return out

    act = torch.zeros(B, inter)
    for blk in plan["plan"][0]:
        for tile in blk:
            cols = slice(64 * tile, 64 * tile + 64)
            g, u = (unit(xin, gup[pl], gus[pl], range(nb_in), half_in, parts_g, cols) for pl in (0, 1))
            act[:, cols] = torch.nn.functional.silu(g) * u
    act = act.to(torch.bfloat16).float()
    part = torch.zeros(kd, B, H)
    nbu = nd // kd
    for blk in plan["plan"][1]:
        for uid in blk:
            sp, tile = divmod(uid, tiles)
            cols = slice(64 * tile, 64 * tile + 64)
            xs = act[:, sp * nbu * 2 * half_d : (sp + 1) * nbu * 2 * half_d]
            part[sp, :, cols] = unit(xs, dp, ds, range(sp * nbu, (sp + 1) * nbu), half_d, parts_d, cols)
    out = part[0]
    for sp in range(1, kd):
        out = out + part[sp]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("B", MLP_ROWS)
def test_mlp_units_compute_the_mlp(B):
    """The plan's units summed as the kernel sums them give K5's function:
    within two bf16 ulps at the largest |reference| of int4_mlp_plain (both
    round act and the output to bf16, the sums run in another order), and
    within 2**-5 of it of the JAX int4_mlp_reference in float32 (act is not
    rounded there: the rounding moves the output by about 0.5 % of its
    largest |value| at these widths)."""
    x, gup, gus, dp, ds = _mlp_case(12, B)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w = _t((gup, gus, dp, ds))
    got = _mlp_by_units(xb, *w).float().numpy()
    plain = tint4.int4_mlp_plain(xb, *w).float().numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=2**-6 * np.abs(plain).max())
    ref = np.asarray(jint4.int4_mlp_reference(*_j((xb.float().numpy(), gup, gus, dp, ds)), dtype=jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2**-5 * np.abs(ref).max())
