// Hand-written Hopper (sm_90a) kernels for the Qwen2 LM decode step.
//
// Built by cosyvoice_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into one shared library with a plain C interface, loaded with ctypes.
// Every entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrappers raise if that is not 0.
//
// ---------------------------------------------------------------------------
// K1  gqa_decode_split_kernel + gqa_decode_reduce_kernel  (flash decode)
//
// Replaces: cosyvoice_tpu/ops/decode_attention.py:gqa_decode_attention
//   (pallas_call at :290, body _decode_kernel at :38).
// Computes: single-token GQA attention of q [B,Hq,D] against a KV arena
//   [B,T,Hkv,D]; keys at positions <= cur_len[b] are live, the rest is dead
//   arena that is never read. fp32 online softmax; KV is never head-repeated.
// Bound on the H100: bytes. Per call it must read q, the live K and V rows
//   (2 * (cur_len+1) * Hkv * D * 2 bytes per batch row) and write the output;
//   at 3.35 TB/s that is ~0.15 us for one layer at cur_len 1000, B=1. The
//   arithmetic is 4 * Hq * D flops per live key, ~1/7 flop per byte read.
// Design: the TPU walks the live blocks of one row in one grid step
//   (grid=(B,)); at B=1 that would be a single block on 132 SMs. Here the
//   grid is (splits, Hkv, B): each block takes a contiguous share of the
//   ceil((cur_len+1)/blk) live key blocks of one (row, KV head), holds the
//   rep = Hq/Hkv query heads of that KV head in registers, and keeps a
//   running max and sum in fp32. Each warp streams whole 128-byte K and V
//   rows (coalesced, one load per lane), reduces q.k with warp shuffles,
//   and the block's warps merge through shared memory into one partial
//   (m, l, acc) per split. The second kernel merges the splits of each
//   (row, query head) by log-sum-exp. Splits past the live range exit before
//   reading anything, and the reduction reads only the live splits.
//
// K2  kv_arena_write_kernel  (arena row write)
//
// Replaces: cosyvoice_tpu/ops/decode_attention.py:kv_arena_write /
//   kv_arena_write_traced (pallas_call at :447, body _kv_write_kernel :413).
// Computes: arena[b, pos[b]] = new_kv[b] in place, for every batch row.
// Bound on the H100: bytes. It reads B * Hkv * D new values and writes as
//   many (512 bytes at B=1 for Qwen2-0.5B): ~0.0003 us, far below the cost
//   of a launch.
// Design: one block per batch row copies its F = Hkv*D values with 16-byte
//   vector loads and stores (F must be a multiple of 8 and both tensors
//   16-byte aligned); the rest of the arena is never touched (the TPU kernel
//   rewrites one 8-row tile group per row).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Live keys of row b: positions 0..cur_len[b], clamped to the arena.
__device__ __forceinline__ int live_keys(const int* cur_len, int b, int T) {
  int n = cur_len[b] + 1;
  return n < 1 ? 1 : (n > T ? T : n);
}

template <int D>
__global__ void __launch_bounds__(kThreads) gqa_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, D]
    const __nv_bfloat16* __restrict__ k,   // [B, T, Hkv, D]
    const __nv_bfloat16* __restrict__ v,   // [B, T, Hkv, D]
    const int* __restrict__ cur_len,       // [B]
    float* __restrict__ part_m,            // [B, Hq, splits]
    float* __restrict__ part_l,            // [B, Hq, splits]
    float* __restrict__ part_acc,          // [B, Hq, splits, D]
    int Hkv, int T, int rep, int splits, int blk, float scale) {
  constexpr int DPL = D / 32;  // dims held by each lane
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int n_live = live_keys(cur_len, b, T);
  const int n_blocks = (n_live + blk - 1) / blk;
  const int per_split = (n_blocks + splits - 1) / splits;
  const int key0 = s * per_split * blk;
  if (key0 >= n_live) return;  // dead split: nothing read, reduce skips it
  const int key1 = min(n_live, (s + 1) * per_split * blk);
  const int Hq = Hkv * rep;

  float qr[kMaxRep][DPL];
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[r][i] = 0.f;
      qr[r][i] = r < rep
          ? __bfloat162float(q[((size_t)b * Hq + g * rep + r) * D + lane * DPL + i]) * scale
          : 0.f;
    }
  }

  const size_t row = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + (size_t)b * T * row + (size_t)g * D + lane * DPL;
  const __nv_bfloat16* vb = v + (size_t)b * T * row + (size_t)g * D + lane * DPL;
  for (int j = key0 + warp; j < key1; j += kWarps) {
    float kf[DPL], vf[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kf[i] = __bfloat162float(kb[(size_t)j * row + i]);
      vf[i] = __bfloat162float(vb[(size_t)j * row + i]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float p = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) p += qr[r][i] * kf[i];
        p = warp_sum(p);
        const float m_new = fmaxf(m[r], p);
        const float corr = __expf(m[r] - m_new);
        const float e = __expf(p - m_new);
        l[r] = l[r] * corr + e;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * corr + e * vf[i];
        m[r] = m_new;
      }
    }
  }

  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][D];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][r][lane * DPL + i] = acc[r][i];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rep * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(sm_m[w][r] - M);
      L += sm_l[w][r] * f;
      A += sm_acc[w][r][dd] * f;
    }
    const size_t o = ((size_t)b * Hq + g * rep + r) * splits + s;
    part_acc[o * D + dd] = A;
    if (dd == 0) {
      part_m[o] = M;
      part_l[o] = L;
    }
  }
}

template <int D>
__global__ void gqa_decode_reduce_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const int* __restrict__ cur_len,
    __nv_bfloat16* __restrict__ out,  // [B, Hq, D]
    int Hq, int T, int splits, int blk) {
  const int bh = blockIdx.x, b = bh / Hq;
  const int n_live = live_keys(cur_len, b, T);
  const int n_blocks = (n_live + blk - 1) / blk;
  const int per_split = (n_blocks + splits - 1) / splits;
  const int active = (n_blocks + per_split - 1) / per_split;
  const size_t base = (size_t)bh * splits;
  float M = kNegInf;
  for (int s = 0; s < active; ++s) M = fmaxf(M, part_m[base + s]);
  for (int dd = threadIdx.x; dd < D; dd += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < active; ++s) {
      const float f = __expf(part_m[base + s] - M);
      L += part_l[base + s] * f;
      A += part_acc[(base + s) * D + dd] * f;
    }
    out[(size_t)bh * D + dd] = __float2bfloat16(A / L);
  }
}

__global__ void kv_arena_write_kernel(
    __nv_bfloat16* __restrict__ arena,         // [B, T, F]
    const __nv_bfloat16* __restrict__ new_kv,  // [B, F]
    const int* __restrict__ pos,               // [B]
    int T, int F) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= T) return;  // out of the arena: nothing is written
  // F % 8 == 0 and 16-byte-aligned bases (checked by the entry point), so
  // every row starts on a 16-byte boundary: one uint4 (8 bf16) per thread
  uint4* dst = reinterpret_cast<uint4*>(arena + ((size_t)b * T + p) * F);
  const uint4* src = reinterpret_cast<const uint4*>(new_kv + (size_t)b * F);
  for (int i = threadIdx.x; i < F / 8; i += blockDim.x) dst[i] = src[i];
}

template <int D>
void launch_decode(const void* q, const void* k, const void* v, const int* cur_len, void* out,
                   float* part_m, float* part_l, float* part_acc, int B, int Hq, int Hkv, int T,
                   int splits, int blk, float scale, cudaStream_t stream) {
  dim3 grid(splits, Hkv, B);
  gqa_decode_split_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), cur_len, part_m, part_l, part_acc, Hkv, T, Hq / Hkv,
      splits, blk, scale);
  gqa_decode_reduce_kernel<D><<<B * Hq, D, 0, stream>>>(
      part_m, part_l, part_acc, cur_len, static_cast<__nv_bfloat16*>(out), Hq, T, splits, blk);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a shape the kernel does not take (the Python wrapper checks first).
int cvt_gqa_decode_attention(const void* q, const void* k, const void* v, const int* cur_len,
                             void* out, float* part_m, float* part_l, float* part_acc, int B,
                             int Hq, int Hkv, int T, int D, int splits, int blk, float scale,
                             void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxRep || splits <= 0 || blk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    launch_decode<64>(q, k, v, cur_len, out, part_m, part_l, part_acc, B, Hq, Hkv, T, splits, blk,
                      scale, s);
  } else if (D == 128) {
    launch_decode<128>(q, k, v, cur_len, out, part_m, part_l, part_acc, B, Hq, Hkv, T, splits, blk,
                       scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int cvt_kv_arena_write(void* arena, const void* new_kv, const int* pos, int B, int T, int F,
                       void* stream) {
  if (F <= 0 || F % 8 != 0 || reinterpret_cast<uintptr_t>(arena) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(new_kv) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  kv_arena_write_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(arena), static_cast<const __nv_bfloat16*>(new_kv), pos, T, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
