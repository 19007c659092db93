"""Whole-decode-step int4p kernel K7: every layer of one B=1 decode step in one launch.

Counterpart of `cosyvoice_tpu/ops/int4_block.py`. The int4p LM with a bf16
KV arena takes this route at B=1 while its arena holds at most
MAX_FUSED_ARENA rows (`models/llm.py:Qwen2LM._decode_pack`); past that its
decode step is K4 + K1 + K6, layer by layer.

- `stack_decode_params(layers)`: the port's per-layer int4p weights stacked
  into the layouts the kernel takes, bit for bit those of the JAX
  `stack_decode_params`.
- `int4_decode_layers_plain(...)`: the plain PyTorch version, the JAX
  `int4_decode_layers_reference` with the same rounding points (hnorm, the
  attention row, h2 and silu(g)*u rounded to bf16; the f32 residual rounded
  to bf16 at each layer boundary), made safe against NaN in dead arena rows.
- `int4_decode_layers(...)`: the K7 wrapper (csrc/int4_block.cu). Given CPU
  tensors it computes the plain version; given CUDA tensors it launches the
  kernel or raises. `int4_decode_layers.launches` counts kernel launches.
- `decode_layers_plan(...)`: K7's geometry on a grid of one block per SM:
  each block's units of every phase (`int4_fused.resident_plan`), whose
  weights it streams into a ring in shared memory, a layer ahead.

Semantics, as in the JAX function: the arena [L, A, Hkv*d] is read-only;
keys at positions < pos are visible; the row AT pos is stale and never read:
the step's own (k, v) enter attention fresh, in float32. The new rows come
back as k_new, v_new [L, Hkv*d] for the caller to commit (kernel K2).
"""

import functools
import math

import torch
from torch.nn import functional as F

from cosyvoice_tpu_torch.ops.decode_attention import NEG_INF, _check_cuda, _counters, _raise_on
from cosyvoice_tpu_torch.ops.int4_fused import (
    K7_STATIC_SMEM,
    UNIT_COLS,
    _check_weights,
    _plan_on,
    _round,
    check_shared_memory,
    grid_of,
    int4_matmul_blocked,
    input_splits,
    item_parts,
    plan_table,
    resident_plan,
    smem_limit,
    unit_bytes,
)

# arena rows the fused step takes (the JAX package's VMEM-driven gate, kept so
# that both packages route each block alike); read at call time
MAX_FUSED_ARENA = 2048
HEAD_DIM = 64  # the kernel's head_dim
MAX_REP = 8  # query heads per KV head the kernel takes
MAX_HIDDEN = 2048  # hidden size the kernel stages
ATTN_CHUNK = 32  # arena keys per attention work item of the kernel (one per lane)
MAX_CHUNKS = 64  # attention items per KV head the kernel merges

_STACKED = {
    "nw1": ("input_layernorm", "weight"),
    "nw2": ("post_attention_layernorm", "weight"),
    "qkv_p": ("self_attn", "qkv_proj", "kernel_q4b"),
    "qkv_s": ("self_attn", "qkv_proj", "scale4"),
    "qkv_b": ("self_attn", "qkv_proj", "bias"),
    "o_p": ("self_attn", "o_proj", "kernel_q4b"),
    "o_s": ("self_attn", "o_proj", "scale4"),
    "gu_p": ("mlp", "gate_up_proj", "kernel_q4b"),
    "gu_s": ("mlp", "gate_up_proj", "scale4"),
    "d_p": ("mlp", "down_proj", "kernel_q4b"),
    "d_s": ("mlp", "down_proj", "scale4"),
}


def stack_decode_params(layers):
    """[port Qwen2Layer with quant='int4p'] -> the stacked keyword arguments
    of int4_decode_layers (a new copy on the layers' device):
    nw1/nw2 [L, H]; qkv_p [L, nbq, 128, nqkv], qkv_s [L, nbq, nqkv], qkv_b
    [L, nqkv]; o_p [L, nbo, 128, H], o_s [L, nbo, H]; gu_p [L, 2, nb, 128, I],
    gu_s [L, 2, nb, I]; d_p [L, nd, 256, H], d_s [L, nd, H]."""

    def get(layer, path):
        for name in path:
            layer = getattr(layer, name)
        return layer.detach()

    return {key: torch.stack([get(layer, path) for layer in layers]) for key, path in _STACKED.items()}


ITEM_BYTES = ATTN_CHUNK * 2 * HEAD_DIM * 2 + (MAX_REP + 2) * HEAD_DIM * 4  # K, V rows and the group's bias


@functools.lru_cache(maxsize=None)
def decode_layers_plan(grid: int, A: int, H: int, n_kv: int, nbq: int, half_q: int, nqkv: int, nbo: int,
                       half_o: int, nb_in: int, half_in: int, inter: int, nd: int, half_d: int) -> dict:
    """K7's geometry on `grid` blocks: units of 64 columns of qkv, o_proj and
    down (kq, ko, kd splits of their scale blocks; unit id = split * tiles +
    tile) and of gate|up (both planes, whole input), placed by
    resident_plan; attention item i (KV head i % n_kv, chunk i // n_kv of
    ATTN_CHUNK keys) on block i % grid. Returns {"plan", "table", "maxu",
    "kq", "ko", "kd", "kv_items" (attention items per block at most),
    "parts" (qkv, o, gate|up, down), "xs_bytes", "slot_bytes" (the largest
    block's share of one layer, the kernel's ring of one stage per phase)};
    the ring's layout is the kernel's Layout, mirrored."""
    tq, th, ti = nqkv // UNIT_COLS, H // UNIT_COLS, inter // UNIT_COLS
    # o_proj by scale block: a unit's input is 4 whole heads, whose partials it merges itself
    kq, ko, kd = input_splits(nbq, tq, grid), nbo, input_splits(nd, th, grid)
    shapes = ((1, nbq // kq, half_q), (1, nbo // ko, half_o), (2, nb_in, half_in), (1, nd // kd, half_d))
    sizes = [unit_bytes(*s) for s in shapes]
    plan = resident_plan(grid, list(zip((tq * kq, th * ko, ti, th * kd), sizes)))
    maxu = [max(len(ids) for ids in ph) for ph in plan]
    kv_items = -(-n_kv * -(-A // ATTN_CHUNK) // grid)
    slot = max(2 * H * 4 + kv_items * ITEM_BYTES + sum(len(plan[k][b]) * sizes[k] for k in range(4))
               for b in range(grid))
    return {"plan": plan, "table": plan_table(plan), "maxu": max(maxu), "kq": kq, "ko": ko, "kd": kd,
            "kv_items": kv_items, "parts": tuple(item_parts(m, *s) for m, s in zip(maxu, shapes)),
            "xs_bytes": _round(2 * max(nbq * 2 * half_q, nbo * 2 * half_o, nb_in * 2 * half_in, inter), 128),
            "slot_bytes": slot}


def _dims(cos, k_arena, qkv_p):
    L, A, lanes = k_arena.shape
    d = 2 * cos.shape[-1]
    n_kv = lanes // d
    n_heads = (qkv_p.shape[-1] - 2 * lanes) // d
    return L, A, lanes, d, n_kv, n_heads


def int4_decode_layers_plain(
    x, cos, sin, pos, k_arena, v_arena, nw1, nw2, qkv_p, qkv_s, qkv_b, o_p, o_s, gu_p, gu_s, d_p, d_s,
    eps=1e-6, out_dtype=torch.bfloat16, round_dtype=torch.bfloat16,
):
    """K7's plain version: the JAX `int4_decode_layers_reference`, rounding to
    `round_dtype` where it rounds to bf16 (float32 gives the same function
    without those roundings, the floor of a kernel comparison). Keys and
    values at positions >= pos are masked out before any product, so NaN
    there never reaches the outputs. pos: int or a one-element int tensor.
    Returns (x_out [1, H] in out_dtype, k_new [L, Hkv*d], v_new [L, Hkv*d]
    in the arena's dtype)."""
    L, A, lanes, d, n_kv, n_heads = _dims(cos, k_arena, qkv_p)
    rep, nq, d2 = n_heads // n_kv, n_heads * d, d // 2
    f32 = torch.float32
    cos, sin = cos.float(), sin.float()

    def rnd(t):
        return t.to(round_dtype).float()

    def rope(t):  # [heads, d], the half-split rotation
        t1, t2 = t[:, :d2], t[:, d2:]
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1)

    def rmsnorm(t, w):
        return t * torch.rsqrt(t.square().mean(-1, keepdim=True) + eps) * w.float()

    live = torch.arange(A, device=k_arena.device) < torch.as_tensor(pos, device=k_arena.device).reshape(-1)[0]
    h = x.float()
    kns, vns = [], []
    for l in range(L):
        qkv = int4_matmul_blocked(rnd(rmsnorm(h, nw1[l])), qkv_p[l], qkv_s[l], f32)[0] + qkv_b[l].float()
        q = rope(qkv[:nq].view(n_heads, d)) / math.sqrt(d)
        kn = rope(qkv[nq : nq + lanes].view(n_kv, d))
        vn = qkv[nq + lanes :].view(n_kv, d)
        kns.append(kn.reshape(lanes))
        vns.append(vn.reshape(lanes))
        ka = torch.where(live[:, None], k_arena[l].float(), 0.0).view(A, n_kv, d)
        va = torch.where(live[:, None], v_arena[l].float(), 0.0).view(A, n_kv, d)
        qg = q.view(n_kv, rep, d)
        sc = torch.einsum("grd,agd->gra", qg, ka).masked_fill(~live, NEG_INF)
        s_self = (qg * kn[:, None]).sum(-1, keepdim=True)  # [Hkv, rep, 1]
        m = torch.maximum(sc.amax(-1, keepdim=True), s_self)
        p = torch.where(live, torch.exp(sc - m), 0.0)
        p_self = torch.exp(s_self - m)
        o = (torch.einsum("gra,agd->grd", p, va) + p_self * vn[:, None]) / (p.sum(-1, keepdim=True) + p_self)
        x2 = h + int4_matmul_blocked(rnd(o.reshape(1, nq)), o_p[l], o_s[l], f32)
        h2 = rnd(rmsnorm(x2, nw2[l]))
        gate = int4_matmul_blocked(h2, gu_p[l, 0], gu_s[l, 0], f32)
        up = int4_matmul_blocked(h2, gu_p[l, 1], gu_s[l, 1], f32)
        act = rnd(F.silu(gate) * up)
        h = rnd(x2 + int4_matmul_blocked(act, d_p[l], d_s[l], f32))
    return h.to(out_dtype), torch.stack(kns).to(k_arena.dtype), torch.stack(vns).to(v_arena.dtype)


def _check_shapes(x, cos, sin, k_arena, v_arena, nw1, nw2, qkv_p, qkv_s, qkv_b, o_p, o_s, gu_p, gu_s, d_p, d_s):
    L, A, lanes, d, n_kv, n_heads = _dims(cos, k_arena, qkv_p)
    H = x.shape[-1]
    nbq, half_q, nqkv = qkv_p.shape[1:]
    nbo, half_o = o_p.shape[1:3]
    nb_in, half_in, inter = gu_p.shape[2:]
    nd, half_d = d_p.shape[1:3]
    want = {
        "x": (x, (1, H)), "cos": (cos, (1, d // 2)), "sin": (sin, (1, d // 2)), "v_arena": (v_arena, (L, A, lanes)),
        "nw1": (nw1, (L, H)), "nw2": (nw2, (L, H)), "qkv_s": (qkv_s, (L, nbq, nqkv)), "qkv_b": (qkv_b, (L, nqkv)),
        "o_p": (o_p, (L, nbo, half_o, H)), "o_s": (o_s, (L, nbo, H)), "gu_p": (gu_p, (L, 2, nb_in, half_in, inter)),
        "gu_s": (gu_s, (L, 2, nb_in, inter)), "d_p": (d_p, (L, nd, half_d, H)), "d_s": (d_s, (L, nd, H)),
    }
    bad = [f"{name} {tuple(t.shape)} (want {shape})" for name, (t, shape) in want.items() if tuple(t.shape) != shape]
    if (
        bad or qkv_p.dim() != 4 or qkv_p.shape[0] != L or lanes % d or n_kv < 1 or n_heads < n_kv
        or n_heads % n_kv or nqkv != (n_heads + 2 * n_kv) * d or nbq * 2 * half_q < H or nbo * 2 * half_o < n_heads * d
        or nb_in * 2 * half_in < H or nd * 2 * half_d != inter
    ):
        raise ValueError(
            f"int4_decode_layers shapes do not fit: arena {tuple(k_arena.shape)}, qkv_p {tuple(qkv_p.shape)}, "
            f"d={d}, heads {n_heads}/{n_kv}; " + "; ".join(bad)
        )
    if A > MAX_FUSED_ARENA:
        raise ValueError(f"arena of {A} rows exceeds MAX_FUSED_ARENA={MAX_FUSED_ARENA}: the step is K4 + K1 + K6 there")
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float arena, got {t.dtype}")


def int4_decode_layers(
    x, cos, sin, pos, k_arena, v_arena, nw1, nw2, qkv_p, qkv_s, qkv_b, o_p, o_s, gu_p, gu_s, d_p, d_s,
    eps=1e-6, out_dtype=torch.bfloat16,
):
    """Every layer of one B=1 int4p decode step (K7).

    x [1, H] layer-0 input (the token's embedding); cos/sin [1, d/2] rope at
    pos; pos a one-element int32 tensor (keys < pos are visible); k_arena /
    v_arena [L, A, Hkv*d] with A <= MAX_FUSED_ARENA; the stacked weights of
    stack_decode_params. Returns (x_out [1, H] pre-final-norm hidden in
    out_dtype, k_new [L, Hkv*d], v_new [L, Hkv*d] in the arena's dtype)."""
    args = (x, cos, sin, k_arena, v_arena, nw1, nw2, qkv_p, qkv_s, qkv_b, o_p, o_s, gu_p, gu_s, d_p, d_s)
    _check_shapes(*args)
    weights = (nw1, nw2, qkv_p, qkv_s, qkv_b, o_p, o_s, gu_p, gu_s, d_p, d_s)
    if x.device.type == "cpu":
        return int4_decode_layers_plain(x, cos, sin, pos, k_arena, v_arena, *weights, eps=eps, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    L, A, lanes, d, n_kv, n_heads = _dims(cos, k_arena, qkv_p)
    H = x.shape[-1]
    nbq, half_q, nqkv = qkv_p.shape[1:]
    nbo, half_o = o_p.shape[1:3]
    nb_in, half_in, inter = gu_p.shape[2:]
    nd, half_d = d_p.shape[1:3]
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the kernel writes a bfloat16 x_out, asked for {out_dtype}")
    _check_cuda("x", x, torch.bfloat16, x.device)
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena)):
        _check_cuda(name, t, torch.bfloat16, x.device)
    for name, t in (("cos", cos), ("sin", sin), ("nw1", nw1), ("nw2", nw2), ("qkv_b", qkv_b)):
        _check_cuda(name, t, torch.float32, x.device)
    if not isinstance(pos, torch.Tensor) or pos.numel() != 1:
        raise ValueError("pos must be a one-element int32 tensor on the card")
    _check_cuda("pos", pos, torch.int32, x.device)
    for name, p, s in (("qkv", qkv_p, qkv_s), ("o", o_p, o_s), ("gate_up", gu_p, gu_s), ("down", d_p, d_s)):
        _check_weights(name, p, s, x.device)
    if (
        d != HEAD_DIM or n_heads // n_kv > MAX_REP or H > MAX_HIDDEN or H % UNIT_COLS or A > MAX_CHUNKS * ATTN_CHUNK
        or min(half_q, half_o, half_in, half_d) % 8 or max(half_q, half_in, half_d) > 256 or half_o > 4 * HEAD_DIM
    ):
        raise ValueError(
            f"kernel takes head_dim {HEAD_DIM}, <= {MAX_REP} query heads per KV head, a hidden size <= {MAX_HIDDEN} "
            f"and a multiple of {UNIT_COLS}, arenas of <= {MAX_CHUNKS * ATTN_CHUNK} rows and scale blocks of a "
            f"multiple of 16 rows, got d={d}, rep={n_heads // n_kv}, H={H}, A={A}"
        )
    from cosyvoice_tpu_torch.ops._build import load_library

    dev = x.device
    grid = grid_of(dev)
    key = (grid, A, H, n_kv, nbq, half_q, nqkv, nbo, half_o, nb_in, half_in, inter, nd, half_d)
    plan = decode_layers_plan(*key)
    check_shared_memory("int4_decode_layers", plan["xs_bytes"] + plan["slot_bytes"], K7_STATIC_SMEM,
                        smem_limit(dev))
    # one f32 workspace (the kernel's layout): qkv partials [kq, nqkv], attention
    # partials m, l [Hkv, MAX_CHUNKS, MAX_REP] and acc [..., d], o partials
    # [ko, H], down partials [kd, H], then act [inter] in bf16
    parts = n_kv * MAX_CHUNKS * MAX_REP
    n_f32 = plan["kq"] * nqkv + parts * (2 + d) + (plan["ko"] + plan["kd"]) * H
    work = torch.empty(n_f32 + inter // 2, device=dev, dtype=torch.float32)
    x_out = torch.empty_like(x)
    k_new = torch.empty((L, lanes), device=dev, dtype=k_arena.dtype)
    v_new = torch.empty_like(k_new)
    rc = load_library().cvt_int4_decode_layers(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), pos.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
        *(t.data_ptr() for t in weights), x_out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), work.data_ptr(),
        _counters(dev, 2).data_ptr(), _plan_on(dev, ("decode_layers",) + key, plan["table"]).data_ptr(),
        L, A, H, n_heads, n_kv, d, nbq, half_q, nqkv, nbo, half_o, nb_in, half_in, inter, nd, half_d, plan["kq"],
        plan["ko"], plan["kd"], plan["maxu"], plan["kv_items"], *plan["parts"], plan["slot_bytes"], plan["xs_bytes"],
        grid, float(eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "int4_decode_layers")
    int4_decode_layers.launches += 1
    return x_out, k_new, v_new


int4_decode_layers.launches = 0
