#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cosyvoice_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each under a hard time budget (the process exits non-zero if one is
exceeded, a kernel disagrees with its plain version, or anything raises):

1. device: the card's name and power limit; TF32 off for matmuls and convs.
2. build: every CUDA kernel, one nvcc call, timed.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the LM's decode shapes: K1 (flash-decode GQA, bf16) and K3 (the same over
   an int8 arena, f32 q) at B=1 and ragged B=4, cur_len 0/27/511/512/513/
   4095, with NaN in the dead arena; K2 (KV-arena row write) in bf16 and
   int8; K4 (int4 GEMV) and K6 (fused int4 layer tail) at B=1 and 16.
   Kernel, plain and library device times (CUDA events around a replayed
   CUDA graph that rotates over enough distinct input sets to exceed twice
   the L2 cache, at least one per layer) and eager host rates, and the bound
   from the bytes and operations of each call.
4. slice: the full-width CosyVoice2-0.5B offline engine, random weights from
   seed 0, serves 3 `tts(stream=False)` requests; wavs must be finite and
   n_tokens * 2 * 480 long, and the launch counters must show that every
   decode step went through K1 (24 per step) and K2 (48 per step).
5. check: the LM's kernel decode path against the same decode with the
   plain versions and against a full-prefix recompute of the same tokens
   (plain attention), logits within twice the floor that plain decode
   against the recompute shows.
6. slice_int4p: the same engine with the quantised LM,
   `Qwen2Config(quant="int4p", kv_quant=True)` (fp weights from seed 0,
   quantised on the host), serves 3 requests; every decode step goes
   through K4, K3 and K6 (24 each per step) and K2 (48), and never K1.
7. check_int4p: phase 5 for the quantised LM (its recompute is one prefill
   over the dequantised arena rows).

The line before the last is {"kernels": [...]}, with each kernel's launches
summed over the runs of phases 4 and 6 (each counted from 0); the last line
is {"ok": true, "device": {...}}. Without a card it exits 2 and prints no
result.
"""

import dataclasses
import faulthandler
import json
import math
import subprocess
import sys
import time

# K1 limit per case: two bf16 ulps at the case's largest |reference|. Kernel
# and plain version each round one fp32 result to bf16, and one bf16 ulp at
# |x| is at most 2**-7 * |x|.
K1_TOL_REL = 2**-6
# Relative L2 of LM logits, kernel decode against the same decode with the
# plain versions and against one prefill over the sequence: twice the floor,
# plain decode against that prefill, which is 9.6e-3 to 1.0e-2 on an H100 at
# full width (bf16 matmuls of M=1 and M=T round differently).
LOGIT_TOL = 0.02
# The same check for the int4p LM with the int8 KV arena: twice its floor,
# plain decode against one prefill over the dequantised arena, which is
# 1.52e-2 after 1 step and 1.55e-2 after 96 on an H100 at full width (the
# prefill rounds each int4 block product to bf16, the decode kernels sum in
# float32).
LOGIT_TOL_INT4P = 0.031
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16
L2_BYTES = 50e6  # H100 L2 cache

PHASE_BUDGET_S = {"device": 60, "build": 360, "kernels": 300, "slice": 420, "check": 120,
                  "slice_int4p": 420, "check_int4p": 120}


class Phase:
    """Hard time budget for one phase: faulthandler's watchdog thread dumps
    the stacks and exits the process if the phase overruns, even inside a
    CUDA call that never returns to the interpreter."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        faulthandler.dump_traceback_later(PHASE_BUDGET_S[self.name], exit=True)
        print(f"== phase {self.name} (budget {PHASE_BUDGET_S[self.name]} s)", flush=True)
        return self

    def __exit__(self, *exc):
        faulthandler.cancel_dump_traceback_later()
        print(f"== phase {self.name} done in {time.perf_counter() - self.t0:.1f} s", flush=True)
        return False


def cuda_ms(fn, iters=100, warmup=5):
    """Mean time per call of fn() in ms between CUDA events around `iters`
    eager calls: the rate at which the host launches the work (it includes
    the wrapper's Python and launch cost, as the decode loop pays it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=50, replays=20):
    """Device time per call of fn() in ms: `calls` calls captured in one CUDA
    graph and replayed `replays` times between CUDA events, so the host's
    launch cost is excluded."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32 set to False for cuda.matmul and cudnn (fp32 flow and vocoder run in full fp32)")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")


def phase_build():
    from cosyvoice_tpu_torch.ops import _build

    info = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if any(w in ln for w in ("registers", "spill", "Compiling entry"))]
    print(f"kernels built in {info['seconds']:.1f} s -> {info['path']}")
    for ln in regs:
        print(f"  ptxas: {ln}")


def n_sets(bytes_per_call):
    """Distinct input sets a timing rotates over: at least one per layer
    (24), and enough that their bytes exceed twice the L2 cache, as a decode
    step's weights and arenas do, so that no timed call finds its inputs in
    L2 from an earlier call."""
    return max(24, math.ceil(2 * L2_BYTES / bytes_per_call))


def time_fns(fns, calls):
    """Device ms per call (a graph of `calls` calls, which visits every
    rotating input set once) and the eager host rate, of each fn."""
    dev = {name: graph_ms(fn, calls=calls) for name, fn in fns.items()}
    host = {name: cuda_ms(fn) for name, fn in fns.items()}
    return dev, host


def rotate(sets, fn):
    """fn(*sets[i]) for i = 0, 1, 2, ... cycling over the sets."""
    it = {"i": 0}

    def call():
        args = sets[it["i"] % len(sets)]
        it["i"] += 1
        return fn(*args)

    return call


def kernel_row(name, source, replaces, err, dev, bound_ms, bound_by):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": None,
        "max_abs_err": err, "ms": dev["kernel"], "plain_ms": dev["plain"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": dev.get("library"),
    }


def _arena_case(torch, B, T, Hq, Hkv, d, cur, gen, dead):
    """Random q and arenas with the dead region (positions > cur_len) set to
    `dead`, so any read of dead arena shows in the result."""
    dev = "cuda"
    q = torch.randn((B, Hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, T, Hkv, d), generator=gen, device=dev)
    v = torch.randn((B, T, Hkv, d), generator=gen, device=dev)
    live = torch.arange(T, device=dev)[None, :] <= cur[:, None]
    k = torch.where(live[..., None, None], k, torch.full_like(k, dead)).to(torch.bfloat16)
    v = torch.where(live[..., None, None], v, torch.full_like(v, dead)).to(torch.bfloat16)
    return q, k.contiguous(), v.contiguous()


def _quant_arena_case(torch, B, T, Hq, Hkv, d, cur, gen, dead):
    """f32 q and int8 arenas quantised per token from random rows; the dead
    region's int8 rows are 127 and its scales `dead`."""
    from cosyvoice_tpu_torch.ops.decode_attention import quantize_kv_rows

    q = torch.randn((B, Hq, d), generator=gen, device="cuda")
    live = torch.arange(T, device="cuda")[None, :] <= cur[:, None]
    out = []
    for _ in range(2):
        x8, s = quantize_kv_rows(torch.randn((B, T, Hkv, d), generator=gen, device="cuda"))
        out.append(torch.where(live[..., None, None], x8, torch.full_like(x8, 127)).contiguous())
        out.append(torch.where(live, s, torch.full_like(s, dead)).contiguous())
    k, ks, v, vs = out
    return q, k, v, ks, vs


CASES = [[c] for c in (0, 27, 511, 512, 513, 4095)] + [[0, 27, 513, 4095], [511, 512, 4095, 27]]
CUR_T = 1023  # timed decode position, mid-utterance


def check_k1(da, qc, gen):
    import torch

    Hq, Hkv, d, T = qc.num_heads, qc.num_kv_heads, qc.head_dim, qc.max_cache_len
    err_max = 0.0
    for cl in CASES:
        cur = torch.tensor(cl, device="cuda", dtype=torch.int32)
        q, k, v = _arena_case(torch, len(cl), T, Hq, Hkv, d, cur, gen, dead=100.0)
        out = da.gqa_decode_attention(q, k, v, cur)
        ref = da.gqa_decode_attention_plain(q, k, v, cur)
        err = (out.float() - ref.float()).abs().max().item()
        tol = K1_TOL_REL * ref.float().abs().max().item()
        # NaN in the dead arena must not reach the output: the kernel never reads it
        kn = torch.where(k == 100.0, torch.full_like(k, float("nan")), k)
        vn = torch.where(v == 100.0, torch.full_like(v, float("nan")), v)
        out_nan = da.gqa_decode_attention(q, kn, vn, cur)
        torch.cuda.synchronize()
        if not torch.equal(out_nan, out):
            raise AssertionError(f"K1 read dead arena at cur_len={cl}")
        err_max = max(err_max, err)
        print(f"K1 B={len(cl)} cur_len={cl}: max_abs_err {err:.3e} (tol {tol:.3e} = 2 bf16 ulps at max |ref|)")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at cur_len={cl}: {err}")

    cur = torch.tensor([CUR_T], device="cuda", dtype=torch.int32)
    live = CUR_T + 1
    k1_bytes = 2 * Hq * d * 2 + 2 * live * Hkv * d * 2 + 4
    n = n_sets(k1_bytes)
    sets = [_arena_case(torch, 1, T, Hq, Hkv, d, cur, gen, dead=0.0) + (cur,) for _ in range(n)]
    mask = (torch.arange(T, device="cuda") <= CUR_T)[None, None, None, :]

    def sdpa(q, k, v, c):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )

    dev, host = time_fns({"kernel": rotate(sets, da.gqa_decode_attention),
                          "plain": rotate(sets, da.gqa_decode_attention_plain), "library": rotate(sets, sdpa)}, n)
    row = kernel_row("gqa_decode_attention", "cosyvoice_tpu_torch/csrc/decode_attention.cu",
                     "cosyvoice_tpu/ops/decode_attention.py:290", err_max, dev,
                     *bound(k1_bytes, 4 * live * Hq * d))
    return row, host, n


def check_k3(da, qc, gen):
    import torch

    Hq, Hkv, d, T = qc.num_heads, qc.num_kv_heads, qc.head_dim, qc.max_cache_len
    err_max = 0.0
    for cl in CASES:
        cur = torch.tensor(cl, device="cuda", dtype=torch.int32)
        q, k, v, ks, vs = _quant_arena_case(torch, len(cl), T, Hq, Hkv, d, cur, gen, dead=100.0)
        out = da.gqa_decode_attention_quant(q, k, v, ks, vs, cur)
        ref = da.gqa_decode_attention_quant_plain(q, k, v, ks, vs, cur)
        err = (out - ref).abs().max().item()
        tol = K1_TOL_REL * ref.abs().max().item()
        # NaN scales in the dead arena must not reach the output: the kernel never reads them
        ksn = torch.where(ks == 100.0, torch.full_like(ks, float("nan")), ks)
        vsn = torch.where(vs == 100.0, torch.full_like(vs, float("nan")), vs)
        out_nan = da.gqa_decode_attention_quant(q, k, v, ksn, vsn, cur)
        torch.cuda.synchronize()
        if not torch.equal(out_nan, out):
            raise AssertionError(f"K3 read dead arena at cur_len={cl}")
        err_max = max(err_max, err)
        print(f"K3 B={len(cl)} cur_len={cl}: max_abs_err {err:.3e} (tol {tol:.3e} = 2 bf16 ulps at max |ref|)")
        if not err <= tol:
            raise AssertionError(f"K3 disagrees with its plain version at cur_len={cl}: {err}")

    cur = torch.tensor([CUR_T], device="cuda", dtype=torch.int32)
    live = CUR_T + 1
    k3_bytes = 2 * Hq * d * 4 + 2 * live * (Hkv * d + 4) + 4
    n = n_sets(k3_bytes)
    sets = [_quant_arena_case(torch, 1, T, Hq, Hkv, d, cur, gen, dead=0.0) + (cur,) for _ in range(n)]
    deq = [(q.to(torch.bfloat16), da.dequantize_kv_arena(k, ks, torch.bfloat16),
            da.dequantize_kv_arena(v, vs, torch.bfloat16)) for q, k, v, ks, vs, _ in sets]
    mask = (torch.arange(T, device="cuda") <= CUR_T)[None, None, None, :]

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )

    dev, host = time_fns({"kernel": rotate(sets, da.gqa_decode_attention_quant),
                          "plain": rotate(sets, da.gqa_decode_attention_quant_plain),
                          "library": rotate(deq, sdpa)}, n)
    row = kernel_row("gqa_decode_attention_quant", "cosyvoice_tpu_torch/csrc/decode_attention.cu",
                     "cosyvoice_tpu/ops/decode_attention.py:344", err_max, dev,
                     *bound(k3_bytes, 4 * live * Hq * d))
    return row, host, n


def check_k2(da, qc, gen):
    import torch

    Hkv, d, T = qc.num_kv_heads, qc.head_dim, qc.max_cache_len
    errs = {}
    for dtype in (torch.bfloat16, torch.int8):
        for cl in CASES:
            B = len(cl)
            pos = torch.tensor(cl, device="cuda", dtype=torch.int32)
            arena = (torch.randn((B, T, Hkv, d), generator=gen, device="cuda") * 50).to(dtype)
            new = (torch.randn((B, 1, Hkv, d), generator=gen, device="cuda") * 50).to(dtype)
            ref = da.kv_arena_write_plain(arena.clone(), new, pos)
            out = da.kv_arena_write(arena.clone(), new, pos)
            err = (out.float() - ref.float()).abs().max().item()
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            if err != 0.0:
                raise AssertionError(f"K2 ({dtype}) disagrees with its plain version at pos={cl}: {err}")
        print(f"K2 {dtype} {len(CASES)} cases (B=1 and ragged B=4): max_abs_err {errs[dtype]} (tol 0, exact copy)")

    cur = torch.tensor([CUR_T], device="cuda", dtype=torch.int32)
    flat_idx = cur.long()  # row b*T + pos[b] of the [B*T, F] view, B=1
    F = Hkv * d
    timed = {}
    for dtype in (torch.bfloat16, torch.int8):
        arena = (torch.randn((1, T, Hkv, d), generator=gen, device="cuda") * 50).to(dtype)
        new = (torch.randn((1, 1, Hkv, d), generator=gen, device="cuda") * 50).to(dtype)
        fns = {
            "kernel": lambda a=arena, n=new: da.kv_arena_write(a, n, cur),
            "plain": lambda a=arena, n=new: da.kv_arena_write_plain(a, n, cur),
            "library": lambda a=arena, n=new: a.view(T, F).index_copy_(0, flat_idx, n.view(1, F)),
        }
        timed[dtype] = time_fns(fns, 50) + (bound(2 * F * arena.element_size() + 4, 0),)
    dev, host, (b_ms, b_by) = timed[torch.bfloat16]
    row = kernel_row("kv_arena_write", "cosyvoice_tpu_torch/csrc/decode_attention.cu",
                     "cosyvoice_tpu/ops/decode_attention.py:447", max(errs.values()), dev, b_ms, b_by)
    # the int8 row write (the quantised LM's path) beside the bf16 one
    dev8, _, (b8_ms, _) = timed[torch.int8]
    row["int8"] = {"ms": dev8["kernel"], "plain_ms": dev8["plain"], "library_ms": dev8["library"],
                   "bound_ms": b8_ms}
    return row, host, 50


def _gemv_weights(torch, int4, n_in, n_out, gen):
    w = (torch.randn((n_in, n_out), generator=gen, device="cuda") * 0.05).cpu().numpy()
    return tuple(torch.from_numpy(a).cuda() for a in int4.pack_gemv_int4(w))


def _tail_weights(torch, int4, H, inter, gen):
    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.05).cpu().numpy()

    packs = (int4.pack_gemv_int4(w(H, H)), int4.pack_gate_up_int4(w(H, 2 * inter)), int4.pack_down_int4(w(inter, H)))
    return tuple(torch.from_numpy(a).cuda() for p in packs for a in p)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_k4(int4, qc, gen):
    """K4 at the qkv projection's shape: x [B, 896] -> [B, 1152]."""
    import torch

    n_in, n_out = qc.hidden_size, (qc.num_heads + 2 * qc.num_kv_heads) * qc.head_dim
    p, s = _gemv_weights(torch, int4, n_in, n_out, gen)
    err_max = 0.0
    for B in (1, 16):
        x = torch.randn((B, n_in), generator=gen, device="cuda").to(torch.bfloat16)
        out, ref = int4.int4_gemv(x, p, s), int4.int4_gemv_plain(x, p, s)
        err = (out.float() - ref.float()).abs().max().item()
        tol = K1_TOL_REL * ref.float().abs().max().item()
        err_max = max(err_max, err)
        print(f"K4 B={B} [{B}, {n_in}] x int4 [{n_in}, {n_out}]: max_abs_err {err:.3e} (tol {tol:.3e} = 2 bf16 "
              "ulps at max |ref|)")
        if not err <= tol:
            raise AssertionError(f"K4 disagrees with its plain version at B={B}: {err}")

    x = torch.randn((1, n_in), generator=gen, device="cuda").to(torch.bfloat16)
    k4_bytes = _nbytes(x, p, s) + n_out * 2
    n = n_sets(k4_bytes)
    sets = [(x,) + _gemv_weights(torch, int4, n_in, n_out, gen) for _ in range(n)]
    dense = [(x, int4.unpack_int4_blocked(pp, ss, torch.bfloat16)[:n_in].contiguous()) for x, pp, ss in sets]
    dev, host = time_fns({"kernel": rotate(sets, int4.int4_gemv), "plain": rotate(sets, int4.int4_gemv_plain),
                          "library": rotate(dense, torch.matmul)}, n)
    row = kernel_row("int4_gemv", "cosyvoice_tpu_torch/csrc/int4_fused.cu", "cosyvoice_tpu/ops/int4_fused.py:339",
                     err_max, dev, *bound(k4_bytes, 2 * n_in * n_out))
    return row, host, n


def check_k6(int4, qc, gen):
    """K6 at full width, B=1 (the decode step's shape) and B=16: attn [B, 896]
    f32 (K3's output), x [B, 896] bf16; timed at B=1."""
    import torch

    H, inter = qc.hidden_size, qc.intermediate_size
    ws = _tail_weights(torch, int4, H, inter, gen)

    def inputs(B=1):
        attn = torch.randn((B, H), generator=gen, device="cuda")
        x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
        nw = 1.0 + 0.1 * torch.randn((H,), generator=gen, device="cuda")
        return attn, x, nw

    err_max = 0.0
    for B in (1, 16):
        attn, x, nw = inputs(B)
        out = int4.int4_o_mlp(attn, x, nw, *ws)
        again = int4.int4_o_mlp(attn, x, nw, *ws)
        ref = int4.int4_o_mlp_plain(attn, x, nw, *ws)
        # what rounding to bf16 where both round adds: the plain version
        # against the same function in float32 throughout
        exact = int4.int4_o_mlp_plain(attn, x.float(), nw, *ws)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # the floor: the least nonzero difference of two bf16 results at the
        # largest |reference|, one ulp (<= 2**-7 of it); the limit is twice that
        floor = K1_TOL_REL / 2 * ref.float().abs().max().item()
        rounding = (ref.float() - exact).abs().max().item()
        err_max = max(err_max, err)
        print(f"K6 B={B} H={H} inter={inter}: max_abs_err {err:.3e} (tol {2 * floor:.3e} = 2 x floor {floor:.3e}, "
              f"one bf16 ulp at max |ref|); the bf16 roundings themselves move the result by {rounding:.3e} (plain "
              f"in bf16 vs in f32 throughout); repeats bit for bit: {torch.equal(out, again)}")
        if not torch.equal(out, again):
            raise AssertionError(f"K6 does not repeat bit for bit at B={B}")
        if not err <= 2 * floor:
            raise AssertionError(f"K6 disagrees with its plain version at B={B}: {err} > 2 x {floor}")

    attn, x, nw = inputs()
    k6_bytes = _nbytes(attn, x, nw, *ws) + H * 2
    n = n_sets(k6_bytes)
    sets = [inputs() + _tail_weights(torch, int4, H, inter, gen) for _ in range(n)]
    dev, host = time_fns({"kernel": rotate(sets, int4.int4_o_mlp), "plain": rotate(sets, int4.int4_o_mlp_plain)}, n)
    flops = 2 * H * H + 2 * H * 2 * inter + 2 * inter * H
    row = kernel_row("int4_o_mlp", "cosyvoice_tpu_torch/csrc/int4_fused.cu", "cosyvoice_tpu/ops/int4_fused.py:519",
                     err_max, dev, *bound(k6_bytes, flops))
    return row, host, n


def phase_kernels(cfg):
    """Hold every kernel against its plain version; time all three ways."""
    import torch

    from cosyvoice_tpu_torch.ops import decode_attention as da, int4_fused as int4

    qc = cfg.qwen
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {"K1": lambda: check_k1(da, qc, gen), "K2": lambda: check_k2(da, qc, gen),
              "K3": lambda: check_k3(da, qc, gen), "K4": lambda: check_k4(int4, qc, gen),
              "K6": lambda: check_k6(int4, qc, gen)}
    kernels = {}
    for key, check in checks.items():
        row, host, n = check()
        kernels[key] = row
        eager = ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in host.items())
        lib = f"{row['library_ms'] * 1e3:.2f} us" if row["library_ms"] is not None else "none (no one PyTorch call)"
        print(f"{key} {row['name']} device time per call ({n} rotating input sets): {row['ms'] * 1e3:.2f} us, "
              f"plain {row['plain_ms'] * 1e3:.2f} us, library {lib}, bound {row['bound_ms'] * 1e3:.4f} us "
              f"({row['bound_by']}); eager host rate: {eager}")
        if "int8" in row:
            r8 = row.pop("int8")
            print(f"{key} int8 rows: device {r8['ms'] * 1e3:.2f} us, plain {r8['plain_ms'] * 1e3:.2f} us, "
                  f"library {r8['library_ms'] * 1e3:.2f} us, bound {r8['bound_ms'] * 1e3:.5f} us")
        torch.cuda.empty_cache()
    return kernels


def _counters():
    from cosyvoice_tpu_torch.ops import decode_attention as da, int4_fused as int4

    return {"K1": da.gqa_decode_attention, "K2": da.kv_arena_write, "K3": da.gqa_decode_attention_quant,
            "K4": int4.int4_gemv, "K6": int4.int4_o_mlp}


# kernel launches per decode step of the 24-layer LM, per engine
PER_STEP = {"bf16": {"K1": 24, "K2": 48, "K3": 0, "K4": 0, "K6": 0},
            "int4p": {"K1": 0, "K2": 48, "K3": 24, "K4": 24, "K6": 24}}


def build_engine(lm_cfg):
    import torch

    from cosyvoice_tpu_torch.runtime.engine import build_random_engine

    t0 = time.perf_counter()
    eng = build_random_engine(seed=0, device="cuda", lm_cfg=lm_cfg)
    torch.cuda.synchronize()
    n_lm = sum(p.numel() for p in eng.lm.module.parameters())
    lm_mb = sum(p.numel() * p.element_size() for p in eng.lm.module.parameters()) / 1e6
    n_fh = sum(p.numel() for m in (eng.flow, eng.hift) for p in m.parameters())
    q = lm_cfg.qwen
    quant = eng.timer.records.get("quantize")
    qs = f", quantised on the host in {quant[0]:.1f} s" if quant else ""
    print(f"full-width engine (LM quant={q.quant}, kv_quant={q.kv_quant}) from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s{qs}: LM {n_lm / 1e6:.1f}M params ({lm_mb:.0f} MB), "
          f"flow+HiFT {n_fh / 1e6:.1f}M params")
    return eng


def phase_slice(eng, per_step, text_lens=(16, 32, 48), n_prompt_speech=50, n_prompt_mel=100):
    """Serve offline requests through CosyVoice2Engine.tts; check each wav and
    that every decode step launched each kernel `per_step[key]` times.
    Returns (prompt, requests, launches)."""
    import numpy as np

    c = eng.lm.cfg
    rng = np.random.default_rng(0)
    prompt_text = rng.integers(0, c.qwen.vocab_size, 10)
    prompt_speech = rng.integers(0, min(c.speech_token_size, eng.flow.cfg.vocab_size), n_prompt_speech)
    prompt_mel = (rng.standard_normal((1, n_prompt_mel, 80)) - 5.0).astype(np.float32)
    emb = rng.standard_normal((1, 192)).astype(np.float32)

    def request(n_text):
        text = rng.integers(0, c.qwen.vocab_size, n_text)
        (out,) = list(eng.tts(text, prompt_text, prompt_speech, prompt_speech, prompt_mel, emb, stream=False))
        return text, out

    request(4)  # warm-up: first launches, cuDNN algorithm choice; not counted
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    eng.lm.decode_steps = 0
    reqs = []
    for n_text in text_lens:
        eng.timer.reset()
        t = time.perf_counter()
        text, out = request(n_text)
        wall = time.perf_counter() - t
        wav, toks = out["tts_speech"], out["speech_tokens"]
        if not np.isfinite(wav).all():
            raise AssertionError(f"request text={n_text}: non-finite wav")
        if wav.shape != (1, len(toks) * 2 * 480):
            raise AssertionError(f"request text={n_text}: wav {wav.shape} for {len(toks)} tokens")
        lm_s, t2w_s = eng.timer.records["lm"][-1], sum(eng.timer.records["t2w"])
        audio_s = wav.shape[1] / 24000
        rtf = f"{wall / audio_s:.4f}" if audio_s else "n/a (no audio)"
        print(f"request text={n_text}: {len(toks)} tokens, LM {len(toks) / lm_s:.1f} tok/s ({lm_s * 1e3:.0f} ms), "
              f"flow+HiFT {t2w_s * 1e3:.1f} ms, audio {audio_s:.2f} s, wall {wall * 1e3:.0f} ms, RTF {rtf}")
        reqs.append((text, toks))
    launches = {key: fn.launches for key, fn in counters.items()}
    steps = eng.lm.decode_steps
    print(f"decode steps {steps}: launches " + ", ".join(
        f"{k} {n} (want {per_step[k] * steps})" for k, n in launches.items()))
    if steps == 0 or any(n != per_step[k] * steps for k, n in launches.items()):
        raise AssertionError("the decode steps did not all go through their kernels")
    return (prompt_text, prompt_speech), reqs, launches


def phase_check(eng, prompt, reqs, tol, n_tokens=96):
    """LM logits after decoding generated tokens through the kernels, against
    the same decode with the plain versions swapped in, and against one
    prefill over the whole sequence (plain attention, over the dequantised
    rows when the arena is int8): relative L2 error after the first and
    after the last step. Plain decode against the prefill is the floor: the
    bf16 drift of two paths with exact attention."""
    import numpy as np
    import torch

    from cosyvoice_tpu_torch.models import qwen2
    from cosyvoice_tpu_torch.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT
    from cosyvoice_tpu_torch.ops import decode_attention as da, int4_fused as int4

    c, m, dev = eng.lm.cfg, eng.lm.module, eng.device
    prompt_text, prompt_speech = prompt
    text, toks = max(reqs, key=lambda r: len(r[1]))
    toks = np.asarray(toks[:n_tokens], np.int64)
    if len(toks) == 0:
        raise AssertionError("no request generated a token to check")
    ids = np.concatenate([[c.sos_id], prompt_text, text, [c.task_id], prompt_speech]).astype(np.int64)
    types = np.concatenate([[TYPE_SPECIAL], np.full(len(prompt_text) + len(text), TYPE_TEXT), [TYPE_SPECIAL],
                            np.full(len(prompt_speech), TYPE_SPEECH)]).astype(np.int64)
    T, n = len(ids), len(toks)

    def prefill(i, t):
        return m.prefill(torch.as_tensor(i[None], device=dev), torch.as_tensor(t[None], device=dev),
                         torch.tensor([len(i)], device=dev), eng.lm.init_cache(1))

    def decode_logits():
        """Logits after the first and after the last decode step."""
        logits, cache = prefill(ids, types)
        seen = []
        for i, t in enumerate(toks):
            logits, cache = m.decode_step(torch.tensor([int(t)], device=dev),
                                          torch.tensor([T + i], dtype=torch.int32, device=dev), cache)
            if i in (0, n - 1):
                seen.append(logits)
        return seen[0], seen[-1]

    def full_logits(k):
        logits, _ = prefill(np.concatenate([ids, toks[:k]]), np.concatenate([types, np.full(k, TYPE_SPEECH)]))
        return logits

    plain_fns = {"gqa_decode_attention": da.gqa_decode_attention_plain, "kv_arena_write": da.kv_arena_write_plain,
                 "gqa_decode_attention_quant": da.gqa_decode_attention_quant_plain,
                 "int4_gemv": int4.int4_gemv_plain, "int4_o_mlp": int4.int4_o_mlp_plain}
    with torch.inference_mode():
        kern = decode_logits()
        saved = {name: getattr(qwen2, name) for name in plain_fns}
        for name, fn in plain_fns.items():
            setattr(qwen2, name, fn)
        try:
            plain = decode_logits()
        finally:
            for name, fn in saved.items():
                setattr(qwen2, name, fn)
        full = full_logits(1), full_logits(n)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    e_plain, e_floor, e_full = ([rel(a[j], b[j]) for j in (0, 1)] for a, b in ((kern, plain), (plain, full),
                                                                              (kern, full)))
    print(f"LM logits rel L2 after 1 / {n} decode steps: kernel vs plain decode {e_plain[0]:.2e} / {e_plain[1]:.2e} "
          f"(tol {tol}); floor, plain decode vs one prefill {e_floor[0]:.2e} / {e_floor[1]:.2e}; "
          f"kernel vs one prefill {e_full[0]:.2e} / {e_full[1]:.2e} (tol {tol}); argmax after {n} "
          f"agrees: {int(kern[1].argmax()) == int(plain[1].argmax())}, {int(kern[1].argmax()) == int(full[1].argmax())}")
    if not max(e_plain + e_full) <= tol:
        raise AssertionError("LM decode through the kernels disagrees with the plain path")


def main(argv):
    import torch

    sys.stdout.reconfigure(line_buffering=True)  # keep every line if a phase budget ends the process

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one GPU", file=sys.stderr)
        return 2
    from cosyvoice_tpu_torch.models.llm import LMConfig

    with Phase("device"):
        phase_device()
    with Phase("build"):
        phase_build()
    with Phase("kernels"):
        kernels = phase_kernels(LMConfig())
    launches = dict.fromkeys(kernels, 0)
    bf16_cfg = LMConfig()
    int4p_cfg = dataclasses.replace(bf16_cfg, qwen=dataclasses.replace(bf16_cfg.qwen, quant="int4p", kv_quant=True))
    for suffix, cfg, per_step, tol in (("", bf16_cfg, PER_STEP["bf16"], LOGIT_TOL),
                                       ("_int4p", int4p_cfg, PER_STEP["int4p"], LOGIT_TOL_INT4P)):
        with Phase("slice" + suffix):
            eng = build_engine(cfg)
            prompt, reqs, counts = phase_slice(eng, per_step)
        with Phase("check" + suffix):
            phase_check(eng, prompt, reqs, tol)
        for key, n in counts.items():
            launches[key] += n
        del eng
        torch.cuda.empty_cache()
    for key, n in launches.items():
        kernels[key]["launches"] = n
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
