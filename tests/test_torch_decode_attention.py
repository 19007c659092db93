"""K1 (flash-decode GQA), K3 (the same over an int8 arena) and K2 (KV-arena
row write, bf16 and int8; the K, V and scales write of one launch) of the
PyTorch port against the JAX package: the
port's plain versions (what its wrappers run on CPU tensors) against the
Pallas kernels in interpret mode and the JAX references, in float32. The CUDA
kernels themselves run only on a GPU (tests/test_torch_cuda_kernels.py,
skipped without one; chip_smoke.py runs them at full width)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.ops import decode_attention as jda
from cosyvoice_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)

ATOL = 1e-5  # float32, same masked-softmax math up to summation order


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
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens", [[0], [17], [15, 16, 63], [63, 0, 31, 32]])
def test_decode_attention_plain_matches_pallas_and_reference(lens):
    q, k, v, cur = _case(0, lens)
    ref = np.asarray(jda.gqa_decode_attention_reference(*map(jnp.asarray, (q, k, v, cur))))
    pallas = np.asarray(jda.gqa_decode_attention(*map(jnp.asarray, (q, k, v, cur)), block_size=16, interpret=True))
    got = tda.gqa_decode_attention(*map(torch.from_numpy, (q, k, v, cur))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def _quant_case(seed, lens, T=64, Hq=14, Hkv=2, d=64):
    """int8 arenas with per-token scales; the dead region (positions >
    cur_len) holds the largest int8 value at a huge scale."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    k = rng.integers(-127, 128, (B, T, Hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (B, T, Hkv, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, (B, T)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (B, T)).astype(np.float32)
    for b, n in enumerate(lens):
        k[b, n + 1 :], v[b, n + 1 :], ks[b, n + 1 :], vs[b, n + 1 :] = 127, -127, 1e3, 1e3
    return q, k, v, ks, vs, np.asarray(lens, np.int32)


# cur_len 0, a ragged batch, and the last arena row
@pytest.mark.parametrize("lens", [[0], [17], [15, 16, 63], [63, 0, 31, 32]])
def test_quant_decode_attention_plain_matches_pallas_and_reference(lens):
    args = _quant_case(5, lens)
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jda.gqa_decode_attention_quant_reference(*jargs))
    pallas = np.asarray(jda.gqa_decode_attention_quant(*jargs, block_size=16, interpret=True))
    got = tda.gqa_decode_attention_quant(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=ATOL)


def test_decode_attention_cpu_wrapper_is_plain_and_uncounted():
    q, k, v, cur = map(torch.from_numpy, _case(1, [5, 40]))
    before = tda.gqa_decode_attention.launches
    out = tda.gqa_decode_attention(q, k, v, cur)
    assert torch.equal(out, tda.gqa_decode_attention_plain(q, k, v, cur))
    assert tda.gqa_decode_attention.launches == before
    args = list(map(torch.from_numpy, _quant_case(6, [5, 40])))
    before = tda.gqa_decode_attention_quant.launches
    assert torch.equal(tda.gqa_decode_attention_quant(*args), tda.gqa_decode_attention_quant_plain(*args))
    assert tda.gqa_decode_attention_quant.launches == before


@pytest.mark.parametrize("pos", [[0], [13, 63, 8]])
def test_kv_arena_write_plain_matches_pallas(pos):
    rng = np.random.default_rng(2)
    B, T, Hkv, d = len(pos), 64, 2, 64
    arena = rng.standard_normal((B, T, Hkv, d)).astype(np.float32)
    new = rng.standard_normal((B, 1, Hkv, d)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = np.asarray(jda.kv_arena_write(jnp.asarray(arena), jnp.asarray(new), jnp.asarray(p), interpret=True))
    ta = torch.from_numpy(arena.copy())
    out = tda.kv_arena_write(ta, torch.from_numpy(new), torch.from_numpy(p))
    assert out is ta  # in place
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("pos", [[0], [13, 63, 8]])
def test_kv_arena_write_int8_plain_matches_pallas(pos):
    """The int8 arena (the JAX kernel rewrites a 32-row tile group): exact."""
    rng = np.random.default_rng(3)
    B, T, Hkv, d = len(pos), 64, 2, 64
    arena = rng.integers(-127, 128, (B, T, Hkv, d)).astype(np.int8)
    new = rng.integers(-127, 128, (B, 1, Hkv, d)).astype(np.int8)
    p = np.asarray(pos, np.int32)
    want = np.asarray(jda.kv_arena_write(jnp.asarray(arena), jnp.asarray(new), jnp.asarray(p), interpret=True))
    ta = torch.from_numpy(arena.copy())
    out = tda.kv_arena_write(ta, torch.from_numpy(new), torch.from_numpy(p))
    assert out is ta and out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), want)


def _jax_scale_write(scale, new, pos):
    """The JAX decode step's masked-select write of one scale plane
    (cosyvoice_tpu/models/qwen2.py, kv_quant): scale[b, pos[b]] = new[b]."""
    ssel = jnp.arange(scale.shape[1])[None, :] == jnp.asarray(pos)[:, None]
    return np.asarray(jnp.where(ssel, jnp.asarray(new), jnp.asarray(scale)))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pos", [[0], [13, 63, 8, 40]])
def test_kv_arena_write_kv_plain_matches_pallas(quant, pos):
    """K2's one launch (K and V rows, and over the int8 arena both scales):
    its plain version against the JAX package's two Pallas row writes
    (interpret mode) and its two masked-select scale writes, at B=1 and a
    ragged B=4, bf16-valued float32 and int8 arenas: exact."""
    rng = np.random.default_rng(4 + quant)
    B, T, Hkv, d = len(pos), 64, 2, 64
    if quant:
        arenas = [rng.integers(-127, 128, (B, T, Hkv, d)).astype(np.int8) for _ in range(2)]
        new = [rng.integers(-127, 128, (B, 1, Hkv, d)).astype(np.int8) for _ in range(2)]
        scales = [rng.uniform(0.002, 0.03, (B, T)).astype(np.float32) for _ in range(2)]
        s_new = [rng.uniform(0.002, 0.03, (B, 1)).astype(np.float32) for _ in range(2)]
    else:
        arenas = [rng.standard_normal((B, T, Hkv, d)).astype(np.float32) for _ in range(2)]
        new = [rng.standard_normal((B, 1, Hkv, d)).astype(np.float32) for _ in range(2)]
        scales, s_new = [], []
    p = np.asarray(pos, np.int32)
    want = [np.asarray(jda.kv_arena_write(jnp.asarray(a), jnp.asarray(n), jnp.asarray(p), interpret=True))
            for a, n in zip(arenas, new)]
    want += [_jax_scale_write(sc, sn, p) for sc, sn in zip(scales, s_new)]
    got = [torch.from_numpy(a.copy()) for a in arenas + scales]
    k_out, v_out = tda.kv_arena_write_kv(got[0], got[1], *map(torch.from_numpy, new), torch.from_numpy(p), *got[2:],
                                         *map(torch.from_numpy, s_new))
    assert k_out is got[0] and v_out is got[1]  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_kv_arena_write_kv_one_pos_serves_every_row():
    """The fused decode step's write over the [L, T, Hkv, d] stacked arena:
    pos [1] writes every layer's row at that position, as pos repeated per
    layer does; the CPU wrapper is the plain version and counts nothing."""
    rng = np.random.default_rng(6)
    L, T = 24, 16
    ka, va = (torch.from_numpy(rng.standard_normal((L, T, 2, 64)).astype(np.float32)) for _ in range(2))
    kn, vn = (torch.from_numpy(rng.standard_normal((L, 1, 2, 64)).astype(np.float32)) for _ in range(2))
    one, every = torch.tensor([9], dtype=torch.int32), torch.full((L,), 9, dtype=torch.int32)
    before = tda.kv_arena_write_kv.launches
    got = tda.kv_arena_write_kv(ka.clone(), va.clone(), kn, vn, one)
    want = (tda.kv_arena_write_plain(ka.clone(), kn, every), tda.kv_arena_write_plain(va.clone(), vn, every))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tda.kv_arena_write_kv.launches == before
    with pytest.raises(ValueError):
        tda.kv_arena_write_kv(ka, va, kn, vn, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="all four"):
        tda.kv_arena_write_kv(ka, va, kn, vn, one, torch.zeros(L, T))
    with pytest.raises(ValueError, match="no kernel"):
        tda.kv_arena_write_kv(*(t.to("meta") for t in (ka, va, kn, vn, one)))


def test_wrappers_check_shapes_and_devices():
    q, k, v, cur = map(torch.from_numpy, _case(3, [3]))
    with pytest.raises(ValueError):
        tda.gqa_decode_attention(q, k[:, :, :1], v, cur)
    with pytest.raises(ValueError):
        tda.kv_arena_write(k, torch.zeros(1, 2, 2, 64), cur)
    with pytest.raises(ValueError, match="no kernel"):
        tda.gqa_decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), cur.to("meta"))
    q, k, v, ks, vs, cur = map(torch.from_numpy, _quant_case(7, [3]))
    with pytest.raises(ValueError):
        tda.gqa_decode_attention_quant(q, k, v, ks[:, :8], vs, cur)


# (B, Hkv, T): the LM's first arena bucket and its 4096-row arena at B=1, the
# ragged B=4 of the card checks, the tiny widths of these tests, and an
# arena shorter than the split count
SPLIT_SHAPES = [(1, 2, 512), (1, 2, 4096), (4, 2, 4096), (1, 2, 64), (3, 1, 100), (1, 2, 40)]


@pytest.mark.parametrize("B,Hkv,T", SPLIT_SHAPES)
def test_decode_splits_cover_each_live_key_once(B, Hkv, T):
    """K1 / K3 geometry: for every cur_len of the arena, the splits of
    decode_plan (ranges from the mirror of the kernel's split_begin) cover
    each live key exactly once, in order, and no dead key; every split is
    live once there are at least as many live keys as splits; no split
    holds more than ceil(T / S) keys."""
    S = tda.decode_plan(B, Hkv, T)
    assert 1 <= S <= min(T, tda.NUM_SMS) and B * Hkv * S <= max(tda.NUM_SMS, B * Hkv)
    cap = -(-T // S)
    for cur in range(T):
        n = tda.live_keys(cur, T)
        ranges = [tda.decode_split_range(s, n, S) for s in range(S)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [hi - lo for lo, hi in ranges]
        assert min(sizes) >= 0 and max(sizes) <= cap
        if n >= S:
            assert min(sizes) >= 1
        else:
            assert sum(size > 0 for size in sizes) == n


@pytest.mark.parametrize("B,Hkv,T,S", [(1, 2, 4096, 66), (1, 2, 512, 66), (4, 2, 4096, 16), (1, 2, 40, 40),
                                       (200, 1, 4096, 1)])
def test_decode_plan_fills_the_sms_from_shapes_alone(B, Hkv, T, S):
    """About one block per SM over the (row, KV head) pairs, at most one
    split per arena row, at least one; on the LM's B=1 path a split fits
    the kernel's one shared-memory chunk, so it makes one round trip."""
    assert tda.decode_plan(B, Hkv, T) == S
    if B * Hkv <= 2 and T <= 4096:
        assert -(-T // S) <= tda.DECODE_CHUNK


@pytest.mark.parametrize("cur,T,n", [(-1, 64, 1), (0, 64, 1), (62, 64, 63), (63, 64, 64), (99, 64, 64)])
def test_live_keys_clamps_to_the_arena(cur, T, n):
    assert tda.live_keys(cur, T) == n


@pytest.mark.parametrize("quant,kv_quant,fused", [(False, False, False), ("int4p", True, False), ("int4p", False, True)],
                         ids=["bf16_lm", "int4p_int8_arena", "int4p_k7_step"])
def test_decode_steps_write_the_arena_in_one_k2_call_per_layer(quant, kv_quant, fused, monkeypatch):
    """A per-layer decode step (the bf16 LM; int4p over the int8 arena, scales
    included) writes each layer's K and V rows through one K2 call, and the
    fused int4p step over a bf16 arena (K7) every layer's rows through one:
    the calls the port's LMs make, counted at the wrapper (on CPU tensors it
    runs the plain version)."""
    from cosyvoice_tpu_torch.models import llm as tllm, qwen2 as tqwen2
    from tests.test_torch_common import jax_lm_cfg_quant, to_port_cfg

    lm = tllm.Qwen2LM(to_port_cfg(jax_lm_cfg_quant(quant=quant, kv_quant=kv_quant), tllm.LMConfig), device="cpu")
    calls = []
    for mod in (tqwen2, tllm):
        monkeypatch.setattr(mod, "kv_arena_write_kv",
                            lambda *a, real=mod.kv_arena_write_kv, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(tda, "kv_arena_write", lambda *a, **k: pytest.fail("a single-arena write on the decode path"))
    cache = lm.init_cache(1, 64)
    token, cur = torch.tensor([3]), torch.tensor([5], dtype=torch.int32)
    with torch.inference_mode():
        if fused:
            stacked = lm._decode_pack(cache)
            assert stacked is not None
            lm.module.decode_step_fused(token, cur, cache, stacked)
        else:
            lm.module.decode_step(token, cur, cache)
    L = lm.cfg.qwen.num_layers
    assert calls == ([(L, 64, 2, 64)] if fused else [(1, 64, 2, 64)] * L)
