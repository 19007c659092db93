"""Decode-step attention over the preallocated KV arena, and the arena row write.

Counterpart of `cosyvoice_tpu/ops/decode_attention.py`. Three kernels, each
beside its plain PyTorch version:

- K1 `gqa_decode_attention`: single-token GQA flash decode over a bf16 or a
  float32 arena (csrc/decode_attention.cu: the live keys split over ~132
  blocks, merged by log-sum-exp in the same launch). Replaces the Pallas
  `_decode_kernel`.
- K3 `gqa_decode_attention_quant`: K1 over an int8 arena with per-token f32
  scales (csrc/decode_attention.cu). Replaces the Pallas
  `_quant_decode_kernel`.
- K2 `kv_arena_write_kv`: the decode step's whole arena write in one launch
  (csrc/decode_attention.cu): the K row and the V row of every batch row (or
  of every layer of the stacked arena) at pos[b], and over the int8 arena
  their two per-row scales. `kv_arena_write`, one arena's row write
  `arena[b, pos[b]] = new[b]`, is the same kernel without V. Replaces the
  Pallas `_kv_write_kernel`, which the JAX model calls once for K and once
  for V beside two masked-select scale writes.

`quantize_kv_rows` / `dequantize_kv_arena` are the int8 arena's per-token
absmax quantiser and its inverse, as in the JAX package.

`decode_kernel_wanted` is the one gate of the decode step's route, read by
models/qwen2.py and models/decode_graph.py: the kernels (K2, then K1 or K3)
where the JAX LM takes its Pallas kernels, the plain route (an indexed row
write and the masked einsum over the arena) where it takes the einsum. K1
and K2 take bf16 and float32 arenas (the JAX gate passes a float32 arena to
its kernel as it is), K3 and K2 the int8 arena.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises. Each wrapper counts its kernel launches in a
plain int attribute (`gqa_decode_attention.launches`,
`gqa_decode_attention_quant.launches`, `kv_arena_write.launches`,
`kv_arena_write_kv.launches`) so a run can show that it went through the
kernel.

Layouts are the JAX package's: q [B, Hq, d], arenas [B, T, Hkv, d], scales
[B, T], cur_len / pos [B] int32.
"""

import math

import torch

NEG_INF = -1e30
NUM_SMS = 132  # H100 SXM
DECODE_CHUNK = 64  # keys the CUDA kernel stages in shared memory per round trip (32 for float32 rows)
FLASH_BLOCK = 512  # the Pallas kernel's arena block (cosyvoice_tpu/ops/decode_attention.py)


def decode_kernel_wanted(T: int, lanes: int, block_size: int = FLASH_BLOCK) -> bool:
    """Whether the decode step over an arena of T rows with Hkv * d = `lanes`
    takes the kernels (the arena write K2, attention K1 or K3) rather than
    the plain route: the JAX LM's gate, `flash_decode_wanted(T, lanes)`
    under COSY_FLASH_DECODE=force, which names the cases its TPU takes. The
    kernel where `lanes` is a multiple of 128 and the arena's length divides
    into the kernel's block (min(block_size, T) rows); the plain route
    otherwise. Decided from shapes alone, never from a kernel's error: where
    it picks the kernel, the wrappers launch or raise."""
    return lanes % 128 == 0 and T % min(block_size, T) == 0


def gqa_decode_attention_plain(q, k_arena, v_arena, cur_len):
    """Masked-softmax reference (the einsum path of the JAX model, and
    `gqa_decode_attention_reference`): keys at positions <= cur_len[b] are
    live. Returns [B, Hq, d] in q.dtype."""
    B, Hq, d = q.shape
    T, Hkv = k_arena.shape[1], k_arena.shape[2]
    rep = Hq // Hkv
    qg = q.reshape(B, Hkv, rep, d).float()
    scores = torch.einsum("bgrd,btgd->bgrt", qg, k_arena.float()) / math.sqrt(d)
    valid = torch.arange(T, device=q.device)[None, :] <= cur_len.long()[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", attn, v_arena.float())
    return out.reshape(B, Hq, d).to(q.dtype)


def decode_plan(B: int, Hkv: int, T: int) -> int:
    """Splits per (row, KV head) of K1 / K3: about one block per SM over the
    B * Hkv (row, KV head) pairs (66 at B=1 for Qwen2-0.5B), at most one per
    arena row. It depends on the shapes alone: the kernel spreads the live
    keys over the splits on the device, so no host sync reads cur_len."""
    return max(1, min(T, NUM_SMS // (B * Hkv)))


def decode_split_range(s: int, n_live: int, splits: int) -> tuple:
    """Keys [begin, end) of split s over n_live live keys: the CUDA kernel's
    split_begin, mirrored for the tests. Each split holds floor or ceil of
    n_live / splits keys, in order."""
    return s * n_live // splits, (s + 1) * n_live // splits


def live_keys(cur_len: int, T: int) -> int:
    """Live keys of a row, positions 0..cur_len clamped to the arena, as the
    kernel counts them."""
    return min(max(cur_len + 1, 1), T)


# Per-device ticket counters of K1 / K3 (and the tickets and grid barriers
# of K5, K6, K7), one int per (row, KV head): zeroed once, returned to 0 by
# every call's merging block, grown with B * Hkv. One stream at a time: two
# calls in flight on two streams would share them. A CUDA graph bakes in
# their pointer, so once a graph was captured on a device (CAPTURED, kept by
# models/decode_graph.py) they are never replaced there.
_COUNTERS = {}
CAPTURED = set()


def _counters(device, n: int):
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None and device in CAPTURED:
            raise RuntimeError(f"the kernels' counters on {device} would move to hold {n} ints, under captured CUDA "
                               "graphs that use them")
        buf = torch.zeros(max(n, 64), device=device, dtype=torch.int32)
        _COUNTERS[device] = buf
    return buf


def _check_cuda(name, t, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def _check_decode_shapes(q, k_arena, v_arena, cur_len):
    B, Hq, d = q.shape
    if k_arena.shape != v_arena.shape or k_arena.dim() != 4 or k_arena.shape[0] != B or k_arena.shape[3] != d:
        raise ValueError(f"arena shapes {tuple(k_arena.shape)} / {tuple(v_arena.shape)} do not match q {tuple(q.shape)}")
    if Hq % k_arena.shape[2] != 0:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k_arena.shape[2]}")
    if cur_len.shape != (B,):
        raise ValueError(f"cur_len must be [B]={B}, got {tuple(cur_len.shape)}")


def _launch_decode(entry, q, k_arena, v_arena, scales, cur_len, q_dtype, kv_dtype):
    """Shared launch of K1 / K3: checks, the scratch buffer, one C call."""
    B, Hq, d = q.shape
    T, Hkv = k_arena.shape[1], k_arena.shape[2]
    _check_cuda("q", q, q_dtype, q.device)
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena)):
        _check_cuda(name, t, kv_dtype, q.device)
    for name, t in zip(("k_scale", "v_scale"), scales):
        _check_cuda(name, t, torch.float32, q.device)
    _check_cuda("cur_len", cur_len, torch.int32, q.device)
    if d not in (64, 128) or Hq // Hkv > 8:
        raise ValueError(f"kernel takes head_dim 64/128 and <= 8 query heads per KV head, got d={d}, rep={Hq // Hkv}")
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("kernel copies 16-byte rows: k_arena/v_arena must be 16-byte aligned")
    from cosyvoice_tpu_torch.ops._build import load_library

    splits = decode_plan(B, Hkv, T)
    out = torch.empty_like(q)
    # one scratch buffer: m and l [B*Hq, splits], then acc [B*Hq, splits, d]
    part = torch.empty(B * Hq * splits * (d + 2), device=q.device, dtype=torch.float32)
    rc = getattr(load_library(), entry)(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), *(t.data_ptr() for t in scales),
        cur_len.data_ptr(), out.data_ptr(), part.data_ptr(), _counters(q.device, B * Hkv).data_ptr(),
        B, Hq, Hkv, T, d, splits, 1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, entry)
    return out


def gqa_decode_attention(q, k_arena, v_arena, cur_len):
    """Single-token GQA attention against a length-masked KV arena (K1).

    q: [B, Hq, d] (rope applied); k_arena/v_arena: [B, T, Hkv, d], the
    current token's K/V already written at cur_len[b]; cur_len: [B] int32.
    q and the arenas all bf16 or all float32 (the kernel's two
    instantiations). Returns [B, Hq, d] in q.dtype."""
    _check_decode_shapes(q, k_arena, v_arena, cur_len)
    if q.device.type == "cpu":
        return gqa_decode_attention_plain(q, k_arena, v_arena, cur_len)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    dt = k_arena.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes bfloat16 or float32 arenas, got {dt}")
    entry = "cvt_gqa_decode_attention" if dt == torch.bfloat16 else "cvt_gqa_decode_attention_f32"
    out = _launch_decode(entry, q, k_arena, v_arena, (), cur_len, dt, dt)
    gqa_decode_attention.launches += 1
    return out


gqa_decode_attention.launches = 0


def quantize_kv_rows(x, eps: float = 1e-6):
    """Per-token absmax int8 quantisation of new KV rows: x [B, S, Hkv, d] ->
    (q int8 [B, S, Hkv, d], scale f32 [B, S]), one scale per token row
    across the KV heads."""
    x32 = x.float()
    scale = x32.abs().amax(dim=(2, 3)).clamp_min(eps) / 127.0
    return torch.round(x32 / scale[:, :, None, None]).to(torch.int8), scale


def dequantize_kv_arena(arena_q, scale, dtype):
    """Inverse of quantize_kv_rows over an arena: the scale multiplies in
    float32 and only the product is cast to `dtype`."""
    return (arena_q.float() * scale[:, :, None, None]).to(dtype)


def gqa_decode_attention_quant_plain(q, k_arena, v_arena, k_scale, v_scale, cur_len):
    """K3's plain version (= `gqa_decode_attention_quant_reference`): the
    arenas dequantised in float32, then K1's plain version. Returns q.dtype."""
    kd = dequantize_kv_arena(k_arena, k_scale, torch.float32)
    vd = dequantize_kv_arena(v_arena, v_scale, torch.float32)
    return gqa_decode_attention_plain(q, kd, vd, cur_len)


def gqa_decode_attention_quant(q, k_arena, v_arena, k_scale, v_scale, cur_len):
    """Single-token GQA attention against an int8 KV arena (K3).

    q: [B, Hq, d] float32 (rope applied); k_arena/v_arena: [B, T, Hkv, d]
    int8 with per-token scales k_scale/v_scale [B, T] f32, the current
    token's row written at cur_len[b]; cur_len: [B] int32. Returns
    [B, Hq, d] in q.dtype."""
    _check_decode_shapes(q, k_arena, v_arena, cur_len)
    B, T = k_arena.shape[:2]
    if k_scale.shape != (B, T) or v_scale.shape != (B, T):
        raise ValueError(f"scales must be [B, T]={(B, T)}, got {tuple(k_scale.shape)} / {tuple(v_scale.shape)}")
    if q.device.type == "cpu":
        return gqa_decode_attention_quant_plain(q, k_arena, v_arena, k_scale, v_scale, cur_len)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = _launch_decode(
        "cvt_gqa_decode_attention_quant", q, k_arena, v_arena, (k_scale, v_scale), cur_len, torch.float32, torch.int8
    )
    gqa_decode_attention_quant.launches += 1
    return out


gqa_decode_attention_quant.launches = 0


def kv_arena_write_plain(arena, new_kv, pos):
    """Advanced-index write arena[b, pos[b]] = new_kv[b, 0], in place."""
    rows = torch.arange(arena.shape[0], device=arena.device)
    arena[rows, pos.long()] = new_kv[:, 0].to(arena.dtype)
    return arena


def kv_arena_write(arena, new_kv, pos):
    """Write new_kv[b] into arena[b, pos[b]] in place (K2) and return arena.

    arena: [B, T, Hkv, d] bf16, float32 or int8; new_kv: [B, 1, Hkv, d] of the same
    type; pos: [B] int32. The JAX version donates the arena; here it is
    updated in place."""
    B, T, Hkv, d = arena.shape
    if new_kv.shape != (B, 1, Hkv, d):
        raise ValueError(f"new_kv must be {(B, 1, Hkv, d)}, got {tuple(new_kv.shape)}")
    if pos.shape != (B,):
        raise ValueError(f"pos must be [B]={B}, got {tuple(pos.shape)}")
    if arena.device.type == "cpu":
        return kv_arena_write_plain(arena, new_kv, pos)
    if arena.device.type != "cuda":
        raise ValueError(f"no kernel for device {arena.device}")
    _write_rows(arena, None, new_kv, None, pos)
    kv_arena_write.launches += 1
    return arena


kv_arena_write.launches = 0


def kv_arena_write_kv_plain(k_arena, v_arena, k_new, v_new, pos, k_scale=None, v_scale=None, ks=None, vs=None):
    """K2's plain version: kv_arena_write_plain on each arena, and over the
    int8 arena the advanced-index writes k_scale[b, pos[b]] = ks[b] and
    v_scale[b, pos[b]] = vs[b]; pos [B] or [1] (one position for every row)."""
    B = k_arena.shape[0]
    pos = pos.expand(B)
    kv_arena_write_plain(k_arena, k_new, pos)
    kv_arena_write_plain(v_arena, v_new, pos)
    if k_scale is not None:
        rows, p = torch.arange(B, device=k_arena.device), pos.long()
        k_scale[rows, p] = ks.reshape(B)
        v_scale[rows, p] = vs.reshape(B)
    return k_arena, v_arena


def kv_arena_write_kv(k_arena, v_arena, k_new, v_new, pos, k_scale=None, v_scale=None, ks=None, vs=None):
    """The decode step's arena write in one launch (K2), in place: for every
    row b, k_arena[b, pos[b]] = k_new[b] and v_arena[b, pos[b]] = v_new[b]
    and, over an int8 arena, k_scale[b, pos[b]] = ks[b] and
    v_scale[b, pos[b]] = vs[b]. Returns (k_arena, v_arena).

    Arenas [B, T, Hkv, d] bf16, float32 or int8; new rows [B, 1, Hkv, d] of the same
    type; pos [B] int32, or [1] for one position in every row (the stacked
    [L, T, Hkv, d] arena of the fused decode step); scales [B, T] f32 and ks,
    vs [B] or [B, 1] f32, all four or none."""
    B, T, Hkv, d = k_arena.shape
    scales = (k_scale, v_scale, ks, vs)
    if v_arena.shape != k_arena.shape or k_new.shape != (B, 1, Hkv, d) or v_new.shape != (B, 1, Hkv, d):
        raise ValueError(f"arenas {tuple(k_arena.shape)} / {tuple(v_arena.shape)} and new rows "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)} do not fit")
    if pos.shape not in ((B,), (1,)):
        raise ValueError(f"pos must be [B]={B} or [1], got {tuple(pos.shape)}")
    if any(t is None for t in scales) != all(t is None for t in scales):
        raise ValueError("pass all four of k_scale, v_scale, ks, vs or none")
    if k_scale is not None and (k_scale.shape != (B, T) or v_scale.shape != (B, T) or ks.numel() != B
                                or vs.numel() != B):
        raise ValueError(f"scales must be [B, T]={(B, T)} and ks / vs [B], got {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)}, {tuple(ks.shape)}, {tuple(vs.shape)}")
    if k_arena.device.type == "cpu":
        return kv_arena_write_kv_plain(k_arena, v_arena, k_new, v_new, pos, *scales)
    if k_arena.device.type != "cuda":
        raise ValueError(f"no kernel for device {k_arena.device}")
    _write_rows(k_arena, v_arena, k_new, v_new, pos, scales if k_scale is not None else None)
    kv_arena_write_kv.launches += 1
    return k_arena, v_arena


kv_arena_write_kv.launches = 0


def _write_rows(k_arena, v_arena, k_new, v_new, pos, scales=None):
    """Checks and the one C call of K2 (v_arena / v_new and scales optional)."""
    B, T, Hkv, d = k_arena.shape
    dev = k_arena.device
    if k_arena.dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise TypeError(f"arena must be bfloat16, float32 or int8, got {k_arena.dtype}")
    tensors = [("k_arena", k_arena), ("k_new", k_new)]
    if v_arena is not None:
        tensors += [("v_arena", v_arena), ("v_new", v_new)]
    for name, t in tensors:
        _check_cuda(name, t, k_arena.dtype, dev)
    _check_cuda("pos", pos, torch.int32, dev)
    if scales is not None:
        for name, t in zip(("k_scale", "v_scale", "ks", "vs"), scales):
            _check_cuda(name, t, torch.float32, dev)
    row_bytes = Hkv * d * k_arena.element_size()
    if row_bytes % 16 or row_bytes > 16 * 512 or any(t.data_ptr() % 16 for _, t in tensors):
        raise ValueError(
            f"kernel copies 16-byte vectors: a row of {row_bytes} bytes must be a multiple of 16 (at most 8 KB) "
            "and arenas / new rows 16-byte aligned"
        )
    from cosyvoice_tpu_torch.ops._build import load_library

    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = load_library().cvt_kv_arena_write_kv(
        k_arena.data_ptr(), ptr(v_arena), k_new.data_ptr(), ptr(v_new), pos.data_ptr(), int(pos.numel() == B),
        *(ptr(t) for t in (scales or (None,) * 4)), B, T, row_bytes, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "kv_arena_write")


def empty_kernel(device):
    """One launch of a kernel that does nothing: the floor that a launch sets
    under K2's time (timed beside it)."""
    from cosyvoice_tpu_torch.ops._build import load_library

    _raise_on(load_library().cvt_empty_kernel(torch.cuda.current_stream(device).cuda_stream), "empty_kernel")
