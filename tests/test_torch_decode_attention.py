"""K1 (flash-decode GQA) and K2 (KV-arena row write) of the PyTorch port
against the JAX package: the port's plain versions (what its wrappers run on
CPU tensors) against the Pallas kernels in interpret mode and the JAX
reference, in float32. The CUDA kernels themselves run only on a GPU
(test at the end, skipped without one; chip_smoke.py runs them at full width)."""

import jax
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


def test_decode_attention_cpu_wrapper_is_plain_and_uncounted():
    q, k, v, cur = map(torch.from_numpy, _case(1, [5, 40]))
    before = tda.gqa_decode_attention.launches
    out = tda.gqa_decode_attention(q, k, v, cur)
    assert torch.equal(out, tda.gqa_decode_attention_plain(q, k, v, cur))
    assert tda.gqa_decode_attention.launches == before


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


def test_wrappers_check_shapes_and_devices():
    q, k, v, cur = map(torch.from_numpy, _case(3, [3]))
    with pytest.raises(ValueError):
        tda.gqa_decode_attention(q, k[:, :, :1], v, cur)
    with pytest.raises(ValueError):
        tda.kv_arena_write(k, torch.zeros(1, 2, 2, 64), cur)
    with pytest.raises(ValueError, match="no kernel"):
        tda.gqa_decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), cur.to("meta"))


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels are built with nvcc and run only on the GPU")
    q, k, v, cur = (t.cuda() for t in map(torch.from_numpy, _case(4, [0, 27, 63])))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = tda.gqa_decode_attention(q, k, v, cur)
    ref = tda.gqa_decode_attention_plain(q, k, v, cur)
    # two bf16 ulps at the largest |ref|: kernel and plain each round one fp32 result to bf16
    assert (out.float() - ref.float()).abs().max().item() <= 2**-6 * ref.float().abs().max().item()
    arena, new = k.clone(), torch.randn(3, 1, 2, 64, device="cuda").bfloat16()
    assert torch.equal(
        tda.kv_arena_write(arena.clone(), new, cur), tda.kv_arena_write_plain(arena.clone(), new, cur)
    )
