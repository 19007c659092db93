"""The port's CUDA kernels against their plain PyTorch versions on the card, at
small shapes (K4 at the full-width qkv and o_proj): K1, K2 (bf16 and int8
rows; the fused K, V and scales write), K3, K4, K5, K6 and K7, and
bit-for-bit repeats of K1, K3, K4, K5, K6 and K7. No JAX: these
tests need only torch, numpy and a GPU, and skip inside each test without
one (the kernels are built with nvcc and have no CPU mode). Run them on a
card with `python -m pytest tests/test_torch_cuda_kernels.py -m cuda`;
chip_smoke.py holds the same kernels at full width."""

import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.ops import decode_attention as tda, int4_block as tblock, int4_fused as tint4

pytestmark = pytest.mark.cuda

# two bf16 ulps at the largest |reference|: kernel and plain version each
# round one f32 result to bf16
TWO_ULPS = 2**-6
# K6's rows: the B=1 decode step's kernel, then the batched steps' (one
# tensor-core product per weight fragment up to 8 rows, two from 9)
K6_ROWS = (1, 2, 4, 8, 9, 16)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels are built with nvcc and run only on the GPU")


def _err(out, ref):
    return (out.float() - ref.float()).abs().max().item()


def _case(seed, lens, T=64, Hq=14, Hkv=2, d=64, garbage=1e3):
    """Random q/arenas with the dead region (positions > cur_len) filled with garbage."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, d)).astype(np.float32)
    for b, n in enumerate(lens):
        k[b, n + 1 :] = garbage
        v[b, n + 1 :] = -garbage
    return [torch.from_numpy(a).cuda() for a in (q, k, v, np.asarray(lens, np.int32))]


def _quant_case(seed, lens, T=64, Hq=14, Hkv=2, d=64):
    """int8 arenas with per-token scales; the dead region holds the largest
    int8 value at a huge scale."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    k = rng.integers(-127, 128, (B, T, Hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (B, T, Hkv, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, (B, T)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (B, T)).astype(np.float32)
    for b, n in enumerate(lens):
        k[b, n + 1 :], v[b, n + 1 :], ks[b, n + 1 :], vs[b, n + 1 :] = 127, -127, 1e3, 1e3
    return [torch.from_numpy(a).cuda() for a in (q, k, v, ks, vs, np.asarray(lens, np.int32))]


# cur_len values that split unevenly (or leave splits empty) at 66 splits
UNEVEN = (1, 15, 16, 17, 63, 64, 65, 1023, 2047)


def test_cuda_kernels_match_plain():
    _need_card()
    q, k, v, cur = _case(4, [0, 27, 63])
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ref = tda.gqa_decode_attention_plain(q, k, v, cur)
    assert _err(tda.gqa_decode_attention(q, k, v, cur), ref) <= TWO_ULPS * ref.float().abs().max().item()
    # K1 and K3 where the live keys split unevenly over the 66 splits of a
    # 4096-row arena, or leave splits empty, one row and a ragged batch
    for i, lens in enumerate([[n] for n in UNEVEN] + [UNEVEN[:4], UNEVEN[5:]]):
        q1, k1, v1, c1 = _case(30 + i, lens, T=4096)
        q1, k1, v1 = q1.bfloat16(), k1.bfloat16(), v1.bfloat16()
        ref = tda.gqa_decode_attention_plain(q1, k1, v1, c1)
        assert _err(tda.gqa_decode_attention(q1, k1, v1, c1), ref) <= TWO_ULPS * ref.float().abs().max().item(), lens
        qargs = _quant_case(50 + i, lens, T=4096)
        ref = tda.gqa_decode_attention_quant_plain(*qargs)
        assert _err(tda.gqa_decode_attention_quant(*qargs), ref) <= TWO_ULPS * ref.abs().max().item(), lens
    arena, new = k.clone(), torch.randn(3, 1, 2, 64, device="cuda").bfloat16()
    assert torch.equal(
        tda.kv_arena_write(arena.clone(), new, cur), tda.kv_arena_write_plain(arena.clone(), new, cur)
    )
    # K3: float32 in and out, the same limit
    args = _quant_case(8, [0, 27, 63])
    ref = tda.gqa_decode_attention_quant_plain(*args)
    assert _err(tda.gqa_decode_attention_quant(*args), ref) <= TWO_ULPS * ref.abs().max().item()
    # int8 K2: exact
    arena8, new8 = args[1].clone(), torch.randint(-127, 128, (3, 1, 2, 64), device="cuda", dtype=torch.int8)
    assert torch.equal(
        tda.kv_arena_write(arena8.clone(), new8, args[-1]), tda.kv_arena_write_plain(arena8.clone(), new8, args[-1])
    )
    # K4 and K6 in bf16 at the full-width shapes: both accumulate in float32
    # and round at the same points; limits of two bf16 ulps at the largest
    # |reference| (K4) and four (K6, where a flipped rounding of h2 or
    # silu(g)*u carries through the next product)
    rng = np.random.default_rng(9)
    w = lambda *sh: rng.standard_normal(sh).astype(np.float32) * 0.05  # noqa: E731
    wq = [torch.from_numpy(a).cuda() for a in (
        *tint4.pack_gemv_int4(w(896, 1152)), *tint4.pack_gemv_int4(w(896, 896)),
        *tint4.pack_gate_up_int4(w(896, 2 * 4864)), *tint4.pack_down_int4(w(4864, 896)))]
    wq_tail = [wq[2], wq[3], *wq[4:]]
    for B in (1, 2, 5, 16):  # every row bucket of K4 but 8; qkv then o_proj
        x = torch.randn(B, 896, device="cuda").bfloat16()
        for p, s in (wq[:2], wq[2:4]):
            out, ref = tint4.int4_gemv(x, p, s), tint4.int4_gemv_plain(x, p, s)
            assert _err(out, ref) <= TWO_ULPS * ref.float().abs().max().item(), (B, tuple(p.shape))
    nw = torch.ones(896, device="cuda")
    for B in K6_ROWS:  # B=1's kernel, then the batched steps' (8 rows a product, two from 9)
        attn, x = torch.randn(B, 896, device="cuda"), torch.randn(B, 896, device="cuda").bfloat16()
        for a in (attn, attn.bfloat16()):  # K3's f32 output, K1's bf16
            out, ref = tint4.int4_o_mlp(a, x, nw, *wq_tail), tint4.int4_o_mlp_plain(a, x, nw, *wq_tail)
            torch.cuda.synchronize()
            assert _err(out, ref) <= 2**-5 * ref.float().abs().max().item(), (B, a.dtype)


def _repeat_case(kernel, B):
    """(fn, args) of one call of a redesigned kernel at its main-path shape,
    B rows for K4."""
    if kernel == "K1":
        q, k, v, cur = _case(60, [1023], T=4096)
        return tda.gqa_decode_attention, (q.bfloat16(), k.bfloat16(), v.bfloat16(), cur)
    if kernel == "K3":
        return tda.gqa_decode_attention_quant, _quant_case(61, [1023], T=4096)
    rng = np.random.default_rng(62)
    w = rng.standard_normal((896, 1152)).astype(np.float32) * 0.05
    p, s = (torch.from_numpy(a).cuda() for a in tint4.pack_gemv_int4(w))
    return tint4.int4_gemv, (torch.from_numpy(rng.standard_normal((B, 896)).astype(np.float32)).cuda().bfloat16(), p, s)


@pytest.mark.parametrize("kernel,B", [("K1", 1), ("K3", 1), ("K4", 1), ("K4", 16)])
def test_cuda_kernel_repeats_bit_for_bit(kernel, B):
    """K1, K3 (merge of 66 splits in split order) and K4 (cluster partials
    summed in rank order): no float atomics, so the same call twice gives
    the same bits, and K1/K3's ticket counters are back at 0 after each
    call."""
    _need_card()
    fn, args = _repeat_case(kernel, B)
    outs = [fn(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    if kernel in ("K1", "K3"):
        assert int(tda._COUNTERS[args[0].device].abs().sum()) == 0


@pytest.mark.parametrize("B", [1, 5, 15, 16])
def test_cuda_k5_matches_plain(B):
    """K5 at the full-width MLP (hidden 896, intermediate 4864 -> 5120) at the
    row counts of the bistream extends: within two bf16 ulps at the largest
    |reference| of its plain version (both sum in float32 and round
    silu(g)*u and the output to bf16), the same bits twice with a call on
    other weights in between, one launch counted per call, and the grid
    barrier's and tickets' counters back at 0."""
    _need_card()
    rng = np.random.default_rng(20 + B)
    w = lambda *sh: rng.standard_normal(sh).astype(np.float32) * 0.05  # noqa: E731

    def weights():
        return [torch.from_numpy(a).cuda() for a in (*tint4.pack_gate_up_int4(w(896, 2 * 4864)),
                                                     *tint4.pack_down_int4(w(4864, 896)))]

    wq, other = weights(), weights()
    x = torch.from_numpy(rng.standard_normal((B, 896)).astype(np.float32)).cuda().bfloat16()
    n = tint4.int4_mlp.launches
    out = tint4.int4_mlp(x, *wq)
    tint4.int4_mlp(x, *other)
    again, ref = tint4.int4_mlp(x, *wq), tint4.int4_mlp_plain(x, *wq)
    torch.cuda.synchronize()
    assert tint4.int4_mlp.launches == n + 3
    assert out.shape == (B, 896) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    assert _err(out, ref) <= TWO_ULPS * ref.float().abs().max().item()
    assert int(tda._COUNTERS[out.device].abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("pos,rows", [([5], 1), ([0, 27, 63, 40], 4), ([63], 24)])
def test_cuda_k2_fused_write_matches_plain(dtype, pos, rows):
    """K2's one launch (K and V rows, and over the int8 arena both scales) at
    B=1, a ragged B=4 and 24 stacked layers with one position: exactly its
    plain version (a copy), nothing else of the arenas touched, one launch
    counted."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(len(pos) + rows)
    T = 64

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 50).to(dtype)

    ka, va, kn, vn = rnd(rows, T, 2, 64), rnd(rows, T, 2, 64), rnd(rows, 1, 2, 64), rnd(rows, 1, 2, 64)
    sc = ((torch.rand(rows, T, device="cuda"), torch.rand(rows, T, device="cuda"), torch.rand(rows, 1, device="cuda"),
           torch.rand(rows, 1, device="cuda")) if dtype == torch.int8 else (None,) * 4)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    got = [ka.clone(), va.clone(), *(t.clone() if t is not None else None for t in sc[:2])]
    want = [ka.clone(), va.clone(), *(t.clone() if t is not None else None for t in sc[:2])]
    n = tda.kv_arena_write_kv.launches
    tda.kv_arena_write_kv(got[0], got[1], kn, vn, p, *got[2:], *sc[2:])
    tda.kv_arena_write_kv_plain(want[0], want[1], kn, vn, p, *want[2:], *sc[2:])
    torch.cuda.synchronize()
    assert tda.kv_arena_write_kv.launches == n + 1
    for g, w in zip(got, want):
        assert w is None or torch.equal(g, w)


def _k7_case(seed, L=2, H=384, n_heads=6, n_kv=2, d=64, inter=448, A=64):
    """Stacked int4 weights packed by the port's packers, a bf16 input row and
    a bf16 arena: the tiny widths of the CPU parity tests."""
    rng = np.random.default_rng(seed)
    lanes, nqkv = n_kv * d, (n_heads + 2 * n_kv) * d
    layers = []
    for _ in range(L):
        qp, qs = tint4.pack_gemv_int4(rng.standard_normal((H, nqkv)).astype(np.float32) * 0.05)
        op, osc = tint4.pack_gemv_int4(rng.standard_normal((n_heads * d, H)).astype(np.float32) * 0.05)
        gp, gs = tint4.pack_gate_up_int4(rng.standard_normal((H, 2 * inter)).astype(np.float32) * 0.05)
        dp, ds = tint4.pack_down_int4(rng.standard_normal((inter, H)).astype(np.float32) * 0.05)
        nw1, nw2 = (1.0 + 0.1 * rng.standard_normal((2, H))).astype(np.float32)
        bias = (rng.standard_normal(nqkv) * 0.05).astype(np.float32)
        layers.append((nw1, nw2, qp, qs, bias, op, osc, gp, gs, dp, ds))
    keys = ("nw1", "nw2", "qkv_p", "qkv_s", "qkv_b", "o_p", "o_s", "gu_p", "gu_s", "d_p", "d_s")
    w = {k: torch.from_numpy(np.stack(v)).cuda() for k, v in zip(keys, zip(*layers))}
    ang = rng.standard_normal((1, d // 2))
    cos, sin = (torch.from_numpy(f(ang).astype(np.float32)).cuda() for f in (np.cos, np.sin))
    x = torch.from_numpy(rng.standard_normal((1, H)).astype(np.float32) * 0.5).cuda().bfloat16()
    ka, va = (torch.from_numpy(rng.standard_normal((L, A, lanes)).astype(np.float32) * 0.5).cuda().bfloat16()
              for _ in range(2))
    return x, cos, sin, ka, va, w


@pytest.mark.parametrize("pos", [0, 1, 7, 63])
def test_cuda_k7_matches_plain(pos):
    """K7 against its plain version with NaN in every arena row >= pos (the
    stale row at pos included): the same bits as with zeros there, and the
    same run twice gives the same bits. Limit per output: twice a floor, the
    larger of what the bf16 roundings themselves move (the plain version
    against the same function unrounded) and one bf16 ulp at the largest
    |reference|, as chip_smoke.py holds K7 at full width."""
    _need_card()
    x, cos, sin, ka, va, w = _k7_case(10 + pos)
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    live = (torch.arange(ka.shape[1], device="cuda") < pos)[None, :, None]
    nan = torch.full_like(ka, float("nan"))
    ka_nan, va_nan = torch.where(live, ka, nan), torch.where(live, va, nan)
    ka_zero, va_zero = torch.where(live, ka, 0), torch.where(live, va, 0)
    out = tblock.int4_decode_layers(x, cos, sin, p, ka_nan, va_nan, **w)
    again = tblock.int4_decode_layers(x, cos, sin, p, ka_nan, va_nan, **w)
    zero = tblock.int4_decode_layers(x, cos, sin, p, ka_zero, va_zero, **w)
    ref = tblock.int4_decode_layers_plain(x, cos, sin, p, ka_nan, va_nan, **w)
    exact = tblock.int4_decode_layers_plain(x, cos, sin, p, ka_nan, va_nan, **w, out_dtype=torch.float32,
                                            round_dtype=torch.float32)
    torch.cuda.synchronize()
    for o, a, z, r, e, what in zip(out, again, zero, ref, exact, ("x_out", "k_new", "v_new")):
        assert torch.isfinite(o).all(), what
        assert torch.equal(o, a) and torch.equal(o, z), what
        floor = max(_err(r, e), TWO_ULPS / 2 * r.float().abs().max().item())
        assert _err(o, r) <= 2 * floor, (what, _err(o, r), floor)


@pytest.mark.parametrize("kernel,B", [*(("K6", B) for B in K6_ROWS), ("K7", 1)])
def test_cuda_resident_kernels_repeat_and_zero_their_counters(kernel, B):
    """K6 at K6_ROWS rows and K7 (one block per SM, weights streamed into
    shared memory, grid barriers and tickets on a persistent counter
    buffer): the same call three times gives the same bits, and every
    counter is back at 0 after each call, so the next launch or a graph
    replay finds them zeroed."""
    _need_card()
    if kernel == "K6":
        rng = np.random.default_rng(70)
        w = lambda *sh: rng.standard_normal(sh).astype(np.float32) * 0.05  # noqa: E731
        wq = [torch.from_numpy(a).cuda() for a in (*tint4.pack_gemv_int4(w(896, 896)),
                                                   *tint4.pack_gate_up_int4(w(896, 2 * 4864)),
                                                   *tint4.pack_down_int4(w(4864, 896)))]
        args = (torch.randn(B, 896, device="cuda"), torch.randn(B, 896, device="cuda").bfloat16(),
                torch.ones(896, device="cuda"), *wq)
        outs = [tint4.int4_o_mlp(*args) for _ in range(3)]
    else:
        x, cos, sin, ka, va, w = _k7_case(71)
        p = torch.tensor([40], dtype=torch.int32, device="cuda")
        outs = [tblock.int4_decode_layers(x, cos, sin, p, ka, va, **w)[0] for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert int(tda._COUNTERS[outs[0].device].abs().sum()) == 0
