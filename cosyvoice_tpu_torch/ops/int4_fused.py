"""int4 weight-only decode: blocked half-split packing, plain versions, kernels K4, K5 and K6.

Counterpart of `cosyvoice_tpu/ops/int4_fused.py`. The port keeps its own
copy of the numpy packers, bit-identical to the JAX package's:

- a weight [n_in, n_out] is stored as packed [nb, half, n_out] int8 with
  per-(scale block, column) f32 scales [nb, n_out]. Block b packs input row
  b*2*half + i in the LOW nibble, offset-binary (q + 8), and row
  b*2*half + half + i in the HIGH nibble, signed; q is in [-7, 7];
- gemv weights (qkv, o) and gate|up have input rows zero-padded to a
  multiple of GEMV_IN_ALIGN (256, so half = 128); the intermediate dim is
  zero-padded to a multiple of MLP_INTER_ALIGN (512), and down uses scale
  blocks of 512 rows (half = 256).

Plain PyTorch versions (`int4_matmul_blocked`, `int4_mlp_reference`, the
prefill path, as the JAX package runs XLA there) and two kernels, each beside
its plain version:

- K4 `int4_gemv`: y = x @ dequant(W) for at most 16 rows (csrc/int4_fused.cu:
  one thread-block cluster per 32-column tile over its scale blocks,
  geometry from `gemv_plan`). Replaces the Pallas `_gemv_kernel`.
- K5 `int4_mlp`: the SwiGLU MLP, down(silu(x @ Wg) * (x @ Wu)), for at most
  16 rows in one cooperative launch (csrc/int4_fused.cu), one block per SM
  with a fixed share of the gate|up and down units (`mlp_plan`), whose
  weights it copies into shared memory at launch and decodes once for all
  rows on the tensor cores. Replaces the Pallas `_mlp_kernel`.
- K6 `int4_o_mlp`: the layer's whole post-attention tail, o_proj + residual
  + RMSNorm + SwiGLU MLP + residual, in one cooperative launch
  (csrc/int4_fused.cu). Replaces the Pallas `_o_mlp_kernel`. One block
  per SM, each with a fixed share of the units of every phase
  (`resident_plan`, `o_mlp_plan`), whose weights it copies into shared
  memory at launch; at 2..16 rows the units run on the tensor cores as
  K5's do, every decoded weight serving all rows.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises. `int4_gemv.launches`, `int4_mlp.launches` and
`int4_o_mlp.launches` count kernel launches.
"""

import functools
from typing import Tuple

import numpy as np
import torch
from torch.nn import functional as F

from cosyvoice_tpu_torch.ops.decode_attention import _check_cuda, _counters, _raise_on

NB = 8  # default block count of quantize_tensor_int4_blocked
MLP_INTER_ALIGN = 512
GEMV_IN_ALIGN = 256
MAX_ROWS = 16  # rows the decode kernels take (the JAX package's Pallas route: <= 16)
K4_X_ELEMS = 16 * 256  # bf16 inputs a K4 block stages: row bucket * 2 * half
K4_COLS = 32  # output columns of a K4 tile
K4_MAX_CLUSTER = 8  # portable thread-block cluster size


def _pad_to(n: int, align: int) -> int:
    return ((n + align - 1) // align) * align


# ---------------------------------------------------------------------------
# packing (numpy, on the host; bit-identical to the JAX package)
# ---------------------------------------------------------------------------


def quantize_tensor_int4_blocked(w: np.ndarray, nb: int = NB) -> Tuple[np.ndarray, np.ndarray]:
    """w [n_in, n_out] -> (packed [nb, half, n_out] int8, scale [nb, n_out] f32)."""
    w = np.asarray(w, np.float32)
    n_in, n_out = w.shape
    assert n_in % (2 * nb) == 0, n_in
    g = n_in // nb
    half = g // 2
    blocks = w.reshape(nb, g, n_out)
    scale = np.max(np.abs(blocks), axis=1, keepdims=True) / 7.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(blocks / scale), -7, 7).astype(np.int8)
    packed = ((q[:, :half] + 8) & 0x0F) | (q[:, half:] << 4)
    return packed.astype(np.int8), scale[:, 0, :].astype(np.float32)


def pack_gemv_int4(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Gemv weight [n_in, n_out] -> (packed [nb, 128, n_out], scale [nb, n_out]),
    input rows zero-padded to a GEMV_IN_ALIGN multiple."""
    w = np.asarray(w, np.float32)
    n_in, n_out = w.shape
    n_in_p = _pad_to(n_in, GEMV_IN_ALIGN)
    wp = np.zeros((n_in_p, n_out), np.float32)
    wp[:n_in] = w
    return quantize_tensor_int4_blocked(wp, nb=n_in_p // GEMV_IN_ALIGN)


def pack_gate_up_int4(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fused gate|up kernel [n_in, 2*inter] -> (packed [2, nb, 128, inter_p],
    scale [2, nb, inter_p]); input rows padded to GEMV_IN_ALIGN, intermediate
    columns to MLP_INTER_ALIGN."""
    w = np.asarray(w, np.float32)
    n_in, n2 = w.shape
    inter = n2 // 2
    inter_p = _pad_to(inter, MLP_INTER_ALIGN)
    n_in_p = _pad_to(n_in, GEMV_IN_ALIGN)
    packs, scales = [], []
    for plane in (w[:, :inter], w[:, inter:]):
        wp = np.zeros((n_in_p, inter_p), np.float32)
        wp[:n_in, :inter] = plane
        p, s = quantize_tensor_int4_blocked(wp, nb=n_in_p // GEMV_IN_ALIGN)
        packs.append(p)
        scales.append(s)
    return np.stack(packs), np.stack(scales)


def pack_down_int4(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """down kernel [inter, n_out] -> (packed [inter_p/512, 256, n_out],
    scale [inter_p/512, n_out]), input rows padded to MLP_INTER_ALIGN."""
    w = np.asarray(w, np.float32)
    inter, n_out = w.shape
    inter_p = _pad_to(inter, MLP_INTER_ALIGN)
    wp = np.zeros((inter_p, n_out), np.float32)
    wp[:inter] = w
    return quantize_tensor_int4_blocked(wp, nb=inter_p // MLP_INTER_ALIGN)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _planes(packed, dtype):
    """packed int8 [..., half, O] -> (low plane q, high plane q) in dtype."""
    return ((packed & 15) - 8).to(dtype), (packed >> 4).to(dtype)


def unpack_int4_blocked(packed, scale=None, dtype=torch.float32):
    """packed [nb, half, O] -> dequantized (or raw int4 values if scale is
    None) [nb * 2 * half, O]."""
    lo, hi = _planes(packed, dtype)
    w = torch.cat([lo, hi], dim=1)
    if scale is not None:
        w = w * scale[:, None, :].to(dtype)
    return w.reshape(-1, packed.shape[-1])


def int4_matmul_blocked(x, packed, scale, dtype=torch.bfloat16):
    """y = x @ dequant(packed, scale) in `dtype`: one product per scale block,
    the scale on the block's output (the JAX package's XLA path). x [..., n_in]
    is zero-padded to the packed rows."""
    nb, half, _ = packed.shape
    g = 2 * half
    pad = nb * g - x.shape[-1]
    if pad:
        x = F.pad(x, (0, pad))
    xd = x.to(dtype)
    lo, hi = _planes(packed, dtype)
    y = 0
    for b in range(nb):
        xb = xd[..., b * g : (b + 1) * g]
        part = xb[..., :half] @ lo[b] + xb[..., half:] @ hi[b]
        y = y + part * scale[b].to(dtype)
    return y


def int4_mlp_reference(x, gu_packed, gu_scale, down_packed, down_scale, dtype=torch.bfloat16):
    """down(silu(x @ Wg) * (x @ Wu)) over the padded int4 layouts, in `dtype`."""
    gate = int4_matmul_blocked(x, gu_packed[0], gu_scale[0], dtype)
    up = int4_matmul_blocked(x, gu_packed[1], gu_scale[1], dtype)
    act = (F.silu(gate.float()) * up.float()).to(dtype)
    return int4_matmul_blocked(act, down_packed, down_scale, dtype)


def int4_gemv_plain(x, packed, scale):
    """K4's plain version: `int4_matmul_blocked` accumulated in float32,
    rounded once to x.dtype."""
    return int4_matmul_blocked(x.float(), packed, scale, torch.float32).to(x.dtype)


def int4_mlp_plain(x, gu_packed, gu_scale, down_packed, down_scale):
    """K5's plain version (the JAX `int4_mlp_reference` accumulated in
    float32). It rounds where the kernel rounds, to x.dtype: silu(g)*u before
    the down product, and the output once."""
    dt = x.dtype
    f32 = torch.float32
    a = x.float()
    gate = int4_matmul_blocked(a, gu_packed[0], gu_scale[0], f32)
    up = int4_matmul_blocked(a, gu_packed[1], gu_scale[1], f32)
    act = (F.silu(gate) * up).to(dt).float()
    return int4_matmul_blocked(act, down_packed, down_scale, f32).to(dt)


def int4_o_mlp_plain(attn, x, norm_w, o_packed, o_scale, gu_packed, gu_scale, down_packed, down_scale, eps=1e-6):
    """K6's plain version (the JAX `int4_o_mlp_reference` accumulated in
    float32). It rounds where the kernel rounds, to x.dtype: the attention
    input, h2 = rmsnorm(x2) and silu(g)*u before their products, and the
    output; x2 = x + attn @ Wo stays float32."""
    dt = x.dtype
    f32 = torch.float32
    a = attn.to(dt).float()
    x2 = x.float() + int4_matmul_blocked(a, o_packed, o_scale, f32)
    h2 = x2 * torch.rsqrt(x2.square().mean(-1, keepdim=True) + eps) * norm_w.float()
    h2 = h2.to(dt).float()
    gate = int4_matmul_blocked(h2, gu_packed[0], gu_scale[0], f32)
    up = int4_matmul_blocked(h2, gu_packed[1], gu_scale[1], f32)
    act = (F.silu(gate) * up).to(dt).float()
    return (x2 + int4_matmul_blocked(act, down_packed, down_scale, f32)).to(dt)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_weights(name, packed, scale, device):
    _check_cuda(f"{name} packed", packed, torch.int8, device)
    _check_cuda(f"{name} scale", scale, torch.float32, device)
    if packed.shape[-1] % 16 or packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(
            f"{name}: the kernels read 16 columns per 16-byte load: n_out={packed.shape[-1]} must be a "
            "multiple of 16 and packed/scale 16-byte aligned"
        )


def gemv_rows(B: int) -> int:
    """K4's row bucket: B rounded up to 1, 2, 4, 8 or 16 (one instantiation
    each; the columns a thread owns narrow as it grows)."""
    return next(r for r in (1, 2, 4, 8, 16) if B <= r)


def gemv_plan(nb: int, O: int) -> tuple:
    """K4's geometry, (tiles, cluster): one cluster of min(nb, 8) blocks, the
    tile's scale blocks, per tile of K4_COLS output columns (qkv of
    Qwen2-0.5B: 36 tiles x 4 = 144 blocks on 132 SMs; o_proj 28 x 4). On an
    H100 32-column tiles took less time than 16-column ones (which would
    fill every SM for o_proj) at 1, 2, 5 and 16 rows of both shapes
    (scripts/decode_gemv_ablation.py)."""
    return -(-O // K4_COLS), min(nb, K4_MAX_CLUSTER)


def gemv_scale_blocks(rank: int, cluster: int, nb: int) -> range:
    """The scale blocks that the block of cluster rank `rank` sums (the
    kernel's loop, mirrored for the tests)."""
    return range(rank, nb, cluster)


# ---------------------------------------------------------------------------
# plans of the kernels whose weights stream into shared memory (K5, K6, K7;
# csrc/int4_resident.cuh)
# ---------------------------------------------------------------------------

UNIT_COLS = 64  # output columns of a unit
RES_WARPS = 16  # warps of a block
RES_MAX_ITEMS = 32  # items of one batch of units (csrc: kMaxItems)
RES_MAX_HIDDEN = 2048  # hidden size the kernels stage in static shared memory
RES_MAX_SPLITS = 10  # f32 partials per output a reader of the kernels sums (csrc: kMaxSplits)
MLP_MAX_ITEMS = 16  # K5's items of one batch of units (csrc: kMlpMaxItems)


def unit_bytes(planes: int, nb: int, half: int) -> int:
    """Bytes of a unit's image in shared memory: 64 bytes per packed row of
    each plane, then 64 f32 scales per (plane, scale block)."""
    return planes * nb * half * UNIT_COLS + planes * nb * UNIT_COLS * 4


def input_splits(nb: int, tiles: int, grid: int) -> int:
    """Parts of a weight's scale blocks that its units split (f32 partials,
    summed in a fixed order by their reader): the divisor of nb whose busiest
    block reads the fewest scale blocks of one column tile, then the fewest
    parts. Full width on 132 blocks: qkv 4 (72 units), o_proj 4 (56), down 5
    (70 units of 2 scale blocks)."""
    return min((d for d in range(1, min(nb, RES_MAX_SPLITS) + 1) if nb % d == 0),
               key=lambda d: (-(-tiles * d // grid) * (nb // d), d))


def resident_plan(grid: int, phases) -> list:
    """Every unit of every phase on one of `grid` blocks, fixed before the
    launch. phases: [(n_units, unit_bytes)] in the kernel's phase order.
    Returns, per phase, a list of `grid` lists of unit ids (ascending).

    Within a phase the blocks' unit counts differ by at most one (a phase
    takes as long as its busiest block); among the blocks with the fewest
    units of the phase a unit goes to the one holding the fewest bytes so far
    (then the lowest index), phases with larger units first, so that the
    shares of shared memory and of the weight stream stay even too."""
    out = [[[] for _ in range(grid)] for _ in phases]
    total = [0] * grid
    for ph in sorted(range(len(phases)), key=lambda i: -phases[i][1]):
        n, nbytes = phases[ph]
        count = [0] * grid
        for u in range(n):
            b = min(range(grid), key=lambda b: (count[b], total[b], b))
            out[ph][b].append(u)
            count[b] += 1
            total[b] += nbytes
    return out


def item_parts(max_units: int, planes: int, nb: int, half: int, max_items: int = RES_MAX_ITEMS) -> int:
    """Items per (plane, scale block) of a unit: the divisor p of half / 8
    (a warp reads 8 rows at a time) that keeps a unit's items within
    max_items (the kernel takes a phase's units in batches that fit) and
    least takes the busiest warp of a block with max_units units (item rounds
    times rows per lane, plus two rows' worth for each item's reduction)."""
    best = None
    for p in (d for d in range(1, half // 8 + 1) if (half // 8) % d == 0):
        if planes * nb * p > max_items:
            break
        cost = -(-max(max_units, 1) * planes * nb * p // RES_WARPS) * (half // p // 8 + 2)
        if best is None or cost < best[0]:
            best = (cost, p)
    if best is None:
        raise ValueError(f"a unit of {planes} x {nb} scale blocks has more items than {max_items}")
    return best[1]


def plan_table(plan) -> np.ndarray:
    """The per-block plan as the kernels read it: int32 [grid, phases,
    1 + maxu], each row the unit count then the unit ids (zero-padded)."""
    grid, maxu = len(plan[0]), max(len(ids) for ph in plan for ids in ph)
    table = np.zeros((grid, len(plan), 1 + maxu), np.int32)
    for k, ph in enumerate(plan):
        for b, ids in enumerate(ph):
            table[b, k, 0] = len(ids)
            table[b, k, 1 : 1 + len(ids)] = ids
    return table


def _round(n: int, align: int) -> int:
    return -(-n // align) * align


@functools.lru_cache(maxsize=None)
def o_mlp_plan(grid: int, H: int, nb_o: int, half_o: int, nb_in: int, half_in: int, inter: int, nd: int,
               half_d: int, B: int = 1) -> dict:
    """K6's geometry on `grid` blocks for B rows: units of 64 columns of
    o_proj (ko splits of its scale blocks), gate|up (both planes, whole
    input) and down (kd splits), unit id = split * tiles + tile, placed by
    resident_plan; the units are the same at every B. Returns {"plan" (per
    phase, per block unit ids), "table", "maxu", "ko", "kd", "parts" (o,
    gate|up, down), "xs_bytes" (the staged activations), "img_bytes" (the
    largest block's images and norm weight)}; at B > 1 also "rows" (B padded
    to 8 or 16, as K5's) and "red_bytes" (the items' sums, and x2 [B, H] in
    f32 before them).

    At B=1 (int4_o_mlp_resident_kernel) xs holds one phase's activation
    vector. At B > 1 (int4_o_mlp_rows_kernel) it holds, per phase, each o
    unit's split of attn, h2, or each down unit's split of act, all rows
    (each row 16 bytes longer than its inputs), and a unit's items are at
    most MLP_MAX_ITEMS, as K5's."""
    tiles_h, tiles_i = H // UNIT_COLS, inter // UNIT_COLS
    ko, kd = input_splits(nb_o, tiles_h, grid), input_splits(nd, tiles_h, grid)
    shapes = ((1, nb_o // ko, half_o), (2, nb_in, half_in), (1, nd // kd, half_d))
    sizes = [unit_bytes(*s) for s in shapes]
    plan = resident_plan(grid, list(zip((tiles_h * ko, tiles_i, tiles_h * kd), sizes)))
    maxu = [max(len(ids) for ids in ph) for ph in plan]
    img = max(len(plan[0][b]) * sizes[0] + H * 4 + len(plan[1][b]) * sizes[1] + len(plan[2][b]) * sizes[2]
              for b in range(grid))
    out = {"plan": plan, "table": plan_table(plan), "maxu": max(maxu), "ko": ko, "kd": kd, "img_bytes": img}
    if B == 1:
        return {**out, "parts": tuple(item_parts(m, *s) for m, s in zip(maxu, shapes)),
                "xs_bytes": _round(2 * max(nb_o * 2 * half_o, nb_in * 2 * half_in, inter), 128)}
    rows = mlp_rows(B)
    stage = max(max(maxu) * rows * (k * 2 * half + 8) for k, half in ((nb_o // ko, half_o), (nd // kd, half_d)))
    return {**out, "rows": rows,
            "parts": tuple(item_parts(m, *s, max_items=MLP_MAX_ITEMS) for m, s in zip(maxu, shapes)),
            "xs_bytes": _round(2 * max(stage, rows * (nb_in * 2 * half_in + 8)), 128),
            "red_bytes": _round(max(MLP_MAX_ITEMS * 2 * rows * 32 * 4, rows * H * 4), 128)}


def mlp_rows(B: int) -> int:
    """K5's rows: B padded to 8 or 16, one or two tensor-core products of 8
    rows per weight fragment."""
    return 8 if B <= 8 else 16


@functools.lru_cache(maxsize=None)
def mlp_plan(grid: int, H: int, nb_in: int, half_in: int, inter: int, nd: int, half_d: int, B: int) -> dict:
    """K5's geometry on `grid` blocks for B rows: units of 64 columns of
    gate|up (both planes, the whole input: unit id = tile) and of down (kd
    splits of its scale blocks: unit id = split * tiles + tile), placed by
    resident_plan. Returns {"plan" (per phase, per block unit ids), "table",
    "maxu", "kd", "parts" (gate|up, down), "rows" (B padded to 8 or 16),
    "xs_bytes" (the staged activations: x for gate|up, each down unit's split
    of act), "red_bytes" (the items' sums), "img_bytes" (the largest block's
    images)}.

    Gate|up is not split over its input: the split partials would be summed
    again by each of the down units that read the same split of act."""
    tiles_h, tiles_i = H // UNIT_COLS, inter // UNIT_COLS
    kd = input_splits(nd, tiles_h, grid)
    shapes = ((2, nb_in, half_in), (1, nd // kd, half_d))
    sizes = [unit_bytes(*sh) for sh in shapes]
    plan = resident_plan(grid, list(zip((tiles_i, tiles_h * kd), sizes)))
    maxu = [max(len(ids) for ids in ph) for ph in plan]
    rows = mlp_rows(B)
    stage = max(rows * (nb_in * 2 * half_in + 8), maxu[1] * rows * (nd // kd * 2 * half_d + 8))
    img = max(len(plan[0][b]) * sizes[0] + len(plan[1][b]) * sizes[1] for b in range(grid))
    return {"plan": plan, "table": plan_table(plan), "maxu": max(maxu), "kd": kd, "rows": rows,
            "parts": tuple(item_parts(m, *sh, max_items=MLP_MAX_ITEMS) for m, sh in zip(maxu, shapes)),
            "xs_bytes": _round(2 * stage, 128), "red_bytes": MLP_MAX_ITEMS * 2 * rows * 32 * 4, "img_bytes": img}


# static shared memory of the kernels beside their dynamic share (csrc), plus
# 128 bytes for alignment: K5 (a flag, 2 mbarriers), K6 at B=1 (x2, the
# items' sums, a block sum, a flag, 3 mbarriers), K6 at B > 1 (each row's
# norm, a flag, 3 mbarriers) and K7 (the residual, x2,
# the items' sums, a block sum, the attention item's q/k/v, the merge
# weights, rope, 5 mbarriers)
K5_STATIC_SMEM = 4 + 2 * 8 + 128
K6_STATIC_SMEM = RES_MAX_HIDDEN * 4 + RES_MAX_ITEMS * UNIT_COLS * 4 + RES_WARPS * 4 + 4 + 3 * 8 + 128
K6_ROWS_STATIC_SMEM = MAX_ROWS * 4 + 4 + 3 * 8 + 128
K7_STATIC_SMEM = (2 * RES_MAX_HIDDEN * 4 + RES_MAX_ITEMS * UNIT_COLS * 4 + RES_WARPS * 4 + 10 * 64 * 4
                  + RES_WARPS * 32 * 4 + 64 * 4 + 5 * 8 + 128)

_PLANS = {}  # (device, plan key) -> the plan table on the device


def _plan_on(device, key, table: np.ndarray):
    t = _PLANS.get((device, key))
    if t is None:
        t = _PLANS[device, key] = torch.from_numpy(table).to(device)
    return t


def grid_of(device) -> int:
    """The grid of the resident kernels: one block per SM of the card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_shared_memory(name: str, dynamic: int, static: int, limit: int):
    """Raises if a block needs more shared memory than the card gives one
    block (`limit`, its opt-in maximum)."""
    if dynamic + static > limit:
        raise ValueError(
            f"{name}: a block needs {dynamic} B of dynamic + {static} B of static shared memory, more than the "
            f"{limit} B the card gives one block"
        )


def smem_limit(device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def int4_gemv(x, packed, scale):
    """y[B, O] = x[B, n_in] @ dequant(packed [nb, half, O], scale [nb, O]) (K4).

    Decode-shaped: B <= 16. Accumulates in float32 and rounds once to x.dtype."""
    B, n_in = x.shape
    nb, half, n_out = packed.shape
    if scale.shape != (nb, n_out):
        raise ValueError(f"scale must be {(nb, n_out)}, got {tuple(scale.shape)}")
    if n_in > nb * 2 * half:
        raise ValueError(f"x has {n_in} inputs, the packed weight {nb * 2 * half} rows")
    if x.device.type == "cpu":
        return int4_gemv_plain(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda("x", x, torch.bfloat16, x.device)
    _check_weights("int4_gemv", packed, scale, x.device)
    if not 1 <= B <= MAX_ROWS or gemv_rows(B) * 2 * half > K4_X_ELEMS or half % 8:
        raise ValueError(
            f"kernel takes 1..{MAX_ROWS} rows with row bucket * scale-block rows <= {K4_X_ELEMS} and half a "
            f"multiple of 8, got B={B}, half={half}"
        )
    from cosyvoice_tpu_torch.ops._build import load_library

    out = torch.empty((B, n_out), device=x.device, dtype=x.dtype)
    rc = load_library().cvt_int4_gemv(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), B, n_in, nb, half, n_out,
        *gemv_plan(nb, n_out), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(rc, "int4_gemv")
    int4_gemv.launches += 1
    return out


int4_gemv.launches = 0


def _check_mlp_shapes(B, H, gu_packed, gu_scale, down_packed, down_scale):
    """(nb_in, half_in, inter_p, n_down, half_d, n_out) of the gate|up and
    down layouts; raises if they do not fit together or take H inputs."""
    two, nb_in, half_in, inter_p = gu_packed.shape
    n_down, half_d, n_out = down_packed.shape
    if (
        two != 2 or H > nb_in * 2 * half_in or n_down * 2 * half_d != inter_p
        or gu_scale.shape != (2, nb_in, inter_p) or down_scale.shape != (n_down, n_out)
    ):
        raise ValueError(
            f"MLP shapes do not fit: x [{B}, {H}], gate_up {tuple(gu_packed.shape)} / {tuple(gu_scale.shape)}, "
            f"down {tuple(down_packed.shape)} / {tuple(down_scale.shape)}"
        )
    return nb_in, half_in, inter_p, n_down, half_d, n_out


def int4_mlp(x, gu_packed, gu_scale, down_packed, down_scale):
    """out = (silu(x @ Wg) * (x @ Wu)) @ Wd in one launch (K5).

    x [B, H] (B <= 16) in bf16; gate|up in the layout of pack_gate_up_int4,
    down in that of pack_down_int4. Accumulates in float32, rounds
    silu(g)*u and the output [B, n_out] to x.dtype."""
    B, H = x.shape
    nb_in, half_in, inter_p, n_down, half_d, n_out = _check_mlp_shapes(
        B, H, gu_packed, gu_scale, down_packed, down_scale
    )
    if x.device.type == "cpu":
        return int4_mlp_plain(x, gu_packed, gu_scale, down_packed, down_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    dev = x.device
    _check_cuda("x", x, torch.bfloat16, dev)
    for name, p, s in (("gate_up", gu_packed, gu_scale), ("down", down_packed, down_scale)):
        _check_weights(name, p, s, dev)
    if (
        not 1 <= B <= MAX_ROWS or H % 8 or x.data_ptr() % 16 or n_out % UNIT_COLS or inter_p % UNIT_COLS
        or max(half_in, half_d) > 256 or min(half_in, half_d) % 8
    ):
        raise ValueError(
            f"kernel takes 1..{MAX_ROWS} rows of a 16-byte aligned x with a multiple of 8 inputs, widths that are "
            f"multiples of {UNIT_COLS} and scale blocks of 16..512 rows, got B={B}, H={H}, n_out={n_out}, "
            f"inter={inter_p}, half {half_in}/{half_d}"
        )
    from cosyvoice_tpu_torch.ops._build import load_library

    grid = grid_of(dev)
    key = ("mlp", grid, n_out, nb_in, half_in, inter_p, n_down, half_d, mlp_rows(B))
    plan = mlp_plan(*key[1:])
    check_shared_memory("int4_mlp", plan["xs_bytes"] + plan["red_bytes"] + plan["img_bytes"], K5_STATIC_SMEM,
                        smem_limit(dev))
    # one f32 workspace: down partials [kd, B, n_out], then act [B, inter_p] bf16
    work = torch.empty(plan["kd"] * B * n_out + B * inter_p // 2, device=dev, dtype=torch.float32)
    out = torch.empty((B, n_out), device=dev, dtype=x.dtype)
    rc = load_library().cvt_int4_mlp(
        x.data_ptr(), gu_packed.data_ptr(), gu_scale.data_ptr(), down_packed.data_ptr(), down_scale.data_ptr(),
        work.data_ptr(), out.data_ptr(), _counters(dev, 2 + n_out // UNIT_COLS).data_ptr(),
        _plan_on(dev, key, plan["table"]).data_ptr(), B, H, nb_in, half_in, inter_p, n_down, half_d, n_out,
        plan["kd"], plan["maxu"], *plan["parts"], plan["xs_bytes"], plan["red_bytes"], plan["img_bytes"], grid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "int4_mlp")
    int4_mlp.launches += 1
    return out


int4_mlp.launches = 0


def int4_o_mlp(attn, x, norm_w, o_packed, o_scale, gu_packed, gu_scale, down_packed, down_scale, eps=1e-6):
    """The layer's post-attention tail in one launch (K6):

        x2  = x + attn @ Wo
        h2  = rmsnorm(x2) * norm_w
        out = x2 + (silu(h2 @ Wg) * (h2 @ Wu)) @ Wd

    attn [B, n_attn] (f32 or x.dtype), the pre-o_proj attention output; x
    [B, H] the layer's residual input; norm_w [H] f32; weights in the layouts
    of pack_gemv_int4 / pack_gate_up_int4 / pack_down_int4. Returns [B, H] in
    x.dtype."""
    B, n_attn = attn.shape
    H = x.shape[-1]
    nb_o, half_o, n_out_o = o_packed.shape
    nb_in, half_in, inter_p, n_down, half_d, n_out_d = _check_mlp_shapes(
        B, H, gu_packed, gu_scale, down_packed, down_scale
    )
    if (
        x.shape != (B, H) or norm_w.shape != (H,) or n_out_o != H or n_out_d != H
        or n_attn > nb_o * 2 * half_o or o_scale.shape != (nb_o, H)
    ):
        raise ValueError(
            f"int4_o_mlp shapes do not fit: attn {tuple(attn.shape)}, x {tuple(x.shape)}, o {tuple(o_packed.shape)}, "
            f"gate_up {tuple(gu_packed.shape)}, down {tuple(down_packed.shape)}"
        )
    if x.device.type == "cpu":
        return int4_o_mlp_plain(attn, x, norm_w, o_packed, o_scale, gu_packed, gu_scale, down_packed, down_scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if attn.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn must be float32 or bfloat16, got {attn.dtype}")
    _check_cuda("attn", attn, attn.dtype, x.device)
    _check_cuda("x", x, torch.bfloat16, x.device)
    _check_cuda("norm_w", norm_w, torch.float32, x.device)
    for name, p, s in (("o", o_packed, o_scale), ("gate_up", gu_packed, gu_scale), ("down", down_packed, down_scale)):
        _check_weights(name, p, s, x.device)
    if not 1 <= B <= MAX_ROWS:
        raise ValueError(f"kernel takes 1..{MAX_ROWS} rows, got B={B}")
    tail = _o_mlp_resident if B == 1 else _o_mlp_rows
    out = tail(attn, x, norm_w, o_packed, o_scale, gu_packed, gu_scale, down_packed, down_scale, eps)
    int4_o_mlp.launches += 1
    return out


int4_o_mlp.launches = 0


def _o_mlp_resident(attn, x, norm_w, o_packed, o_scale, gu_packed, gu_scale, down_packed, down_scale, eps):
    """K6 at B=1 (int4_o_mlp_resident_kernel): one block per SM, the plan of
    o_mlp_plan."""
    from cosyvoice_tpu_torch.ops._build import load_library

    H, dev = x.shape[-1], x.device
    nb_o, half_o, _ = o_packed.shape
    _, nb_in, half_in, inter_p = gu_packed.shape
    n_down, half_d, _ = down_packed.shape
    if H > RES_MAX_HIDDEN or H % UNIT_COLS or min(half_o, half_in, half_d) % 8 or norm_w.data_ptr() % 16:
        raise ValueError(
            f"kernel takes H <= {RES_MAX_HIDDEN} and a multiple of {UNIT_COLS}, scale blocks of a multiple of 16 rows "
            f"and a 16-byte aligned norm weight at B=1, got H={H}, half {half_o}/{half_in}/{half_d}"
        )
    grid = grid_of(dev)
    key = ("o_mlp", grid, H, nb_o, half_o, nb_in, half_in, inter_p, n_down, half_d)
    plan = o_mlp_plan(*key[1:])
    check_shared_memory("int4_o_mlp", plan["xs_bytes"] + plan["img_bytes"], K6_STATIC_SMEM, smem_limit(dev))
    # one f32 workspace: o partials [ko, H], down partials [kd, H], then act [inter_p] bf16
    work = torch.empty((plan["ko"] + plan["kd"]) * H + inter_p // 2, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    rc = load_library().cvt_int4_o_mlp_resident(
        attn.data_ptr(), int(attn.dtype == torch.bfloat16), x.data_ptr(), norm_w.data_ptr(), o_packed.data_ptr(),
        o_scale.data_ptr(), gu_packed.data_ptr(), gu_scale.data_ptr(), down_packed.data_ptr(), down_scale.data_ptr(),
        work.data_ptr(), out.data_ptr(), _counters(dev, 2 + H // UNIT_COLS).data_ptr(),
        _plan_on(dev, key, plan["table"]).data_ptr(), attn.shape[1], H, nb_o, half_o, nb_in, half_in, inter_p,
        n_down, half_d, plan["ko"], plan["kd"], plan["maxu"], *plan["parts"], plan["xs_bytes"], plan["img_bytes"],
        grid, float(eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "int4_o_mlp")
    return out


def _o_mlp_rows(attn, x, norm_w, o_packed, o_scale, gu_packed, gu_scale, down_packed, down_scale, eps):
    """K6 at B = 2..16 (int4_o_mlp_rows_kernel): one block per SM, the plan
    of o_mlp_plan(..., B), tensor-core products over all rows."""
    from cosyvoice_tpu_torch.ops._build import load_library

    (B, n_attn), H, dev = attn.shape, x.shape[-1], x.device
    nb_o, half_o, _ = o_packed.shape
    _, nb_in, half_in, inter_p = gu_packed.shape
    n_down, half_d, _ = down_packed.shape
    if (
        H % UNIT_COLS or inter_p % UNIT_COLS or n_attn % 8 or max(half_o, half_in, half_d) > 256
        or min(half_o, half_in, half_d) % 8 or any(t.data_ptr() % 16 for t in (attn, x, norm_w))
    ):
        raise ValueError(
            f"kernel takes widths that are multiples of {UNIT_COLS}, a multiple of 8 attention inputs, scale blocks "
            f"of 16..512 rows and 16-byte aligned attn, x and norm weight at B > 1, got H={H}, inter={inter_p}, "
            f"n_attn={n_attn}, half {half_o}/{half_in}/{half_d}"
        )
    grid = grid_of(dev)
    key = ("o_mlp_rows", grid, H, nb_o, half_o, nb_in, half_in, inter_p, n_down, half_d, B)
    plan = o_mlp_plan(*key[1:])
    check_shared_memory("int4_o_mlp", plan["xs_bytes"] + plan["red_bytes"] + plan["img_bytes"], K6_ROWS_STATIC_SMEM,
                        smem_limit(dev))
    # one f32 workspace: o partials [ko, B, H], down partials [kd, B, H], then act [B, inter_p] bf16
    work = torch.empty((plan["ko"] + plan["kd"]) * B * H + B * inter_p // 2, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    rc = load_library().cvt_int4_o_mlp_rows(
        attn.data_ptr(), int(attn.dtype == torch.bfloat16), x.data_ptr(), norm_w.data_ptr(), o_packed.data_ptr(),
        o_scale.data_ptr(), gu_packed.data_ptr(), gu_scale.data_ptr(), down_packed.data_ptr(), down_scale.data_ptr(),
        work.data_ptr(), out.data_ptr(), _counters(dev, 2 + H // UNIT_COLS).data_ptr(),
        _plan_on(dev, key, plan["table"]).data_ptr(), B, n_attn, H, nb_o, half_o, nb_in, half_in, inter_p, n_down,
        half_d, plan["ko"], plan["kd"], plan["maxu"], *plan["parts"], plan["xs_bytes"], plan["red_bytes"],
        plan["img_bytes"], grid, float(eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "int4_o_mlp")
    return out
