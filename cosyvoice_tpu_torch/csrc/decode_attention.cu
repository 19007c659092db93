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
// K3  gqa_decode_split_kernel<D, true> + gqa_decode_reduce_kernel  (int8 KV)
//
// Replaces: cosyvoice_tpu/ops/decode_attention.py:gqa_decode_attention_quant
//   (pallas_call at :344, body _quant_decode_kernel at :125).
// Computes: K1 over an int8 arena [B,T,Hkv,D] with per-token f32 scales
//   k_scale/v_scale [B,T] (one scale per token row across the KV heads);
//   q and the output are f32. The k scale multiplies each score
//   (q.k_q * ks[t]) and the v scale multiplies the softmax weight before
//   p.v (exact for per-token scales); the running sum l takes the unscaled
//   weight, as the Pallas kernel's does.
// Bound on the H100: bytes. At B=1, cur_len 1023: 1024 * 128 B of int8 K and
//   V rows + 1024 * 8 B of scales ~ 0.27 MB: ~0.08 us at 3.35 TB/s.
// Design: K1's kernels, instantiated for int8 rows, f32 q and output, and two
//   scale loads per key (one 4-byte broadcast each); the split count is
//   fixed from T, so no host sync reads cur_len.
//
// K2  kv_arena_write_kernel  (arena row write)
//
// Replaces: cosyvoice_tpu/ops/decode_attention.py:kv_arena_write /
//   kv_arena_write_traced (pallas_call at :447, body _kv_write_kernel :413).
// Computes: arena[b, pos[b]] = new_kv[b] in place, for every batch row, for
//   bf16 and int8 arenas alike (a row is Hkv*D elements, copied as bytes).
// Bound on the H100: bytes. It reads B * Hkv * D new values and writes as
//   many (512 bytes at B=1 for Qwen2-0.5B in bf16, 256 in int8): ~0.0003 us,
//   far below the cost of a launch.
// Design: one block per batch row copies its row bytes (128 B in int8, 256 B
//   in bf16) with 16-byte vector loads and stores (the row must be a
//   multiple of 16 bytes and both tensors 16-byte aligned); the rest of the
//   arena is never touched (the TPU kernel rewrites one 8-row tile group per
//   row in bf16, 32 in int8).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = 8;
constexpr float kNegInf = -1e30f;

// Element types of the two instantiations: K1 (bf16 q, arena and output) and
// K3 (f32 q and output, int8 arena with f32 per-token scales).
template <bool kQuant>
struct DecodeTypes {
  using q_t = __nv_bfloat16;
  using kv_t = __nv_bfloat16;
  using out_t = __nv_bfloat16;
};
template <>
struct DecodeTypes<true> {
  using q_t = float;
  using kv_t = int8_t;
  using out_t = float;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads) gqa_decode_split_kernel(
    const typename DecodeTypes<kQuant>::q_t* __restrict__ q,   // [B, Hq, D]
    const typename DecodeTypes<kQuant>::kv_t* __restrict__ k,  // [B, T, Hkv, D]
    const typename DecodeTypes<kQuant>::kv_t* __restrict__ v,  // [B, T, Hkv, D]
    const float* __restrict__ k_scale,     // [B, T] (K3 only)
    const float* __restrict__ v_scale,     // [B, T] (K3 only)
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
          ? to_f32(q[((size_t)b * Hq + g * rep + r) * D + lane * DPL + i]) * scale
          : 0.f;
    }
  }

  const size_t row = (size_t)Hkv * D;
  const auto* kb = k + (size_t)b * T * row + (size_t)g * D + lane * DPL;
  const auto* vb = v + (size_t)b * T * row + (size_t)g * D + lane * DPL;
  for (int j = key0 + warp; j < key1; j += kWarps) {
    float kf[DPL], vf[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kf[i] = to_f32(kb[(size_t)j * row + i]);
      vf[i] = to_f32(vb[(size_t)j * row + i]);
    }
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = k_scale[(size_t)b * T + j];
      vs = v_scale[(size_t)b * T + j];
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float p = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) p += qr[r][i] * kf[i];
        p = warp_sum(p);
        if constexpr (kQuant) p *= ks;  // column dequant of the score
        const float m_new = fmaxf(m[r], p);
        const float corr = __expf(m[r] - m_new);
        const float e = __expf(p - m_new);
        l[r] = l[r] * corr + e;
        float ev = e;
        if constexpr (kQuant) ev *= vs;  // v dequant folded into the weight
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * corr + ev * vf[i];
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

template <int D, typename OutT>
__global__ void gqa_decode_reduce_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const int* __restrict__ cur_len,
    OutT* __restrict__ out,  // [B, Hq, D]
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
    store(out + (size_t)bh * D + dd, A / L);
  }
}

__global__ void kv_arena_write_kernel(
    uint8_t* __restrict__ arena,         // [B, T, row_bytes]
    const uint8_t* __restrict__ new_kv,  // [B, row_bytes]
    const int* __restrict__ pos,         // [B]
    int T, int row_bytes) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= T) return;  // out of the arena: nothing is written
  // row_bytes % 16 == 0 and 16-byte-aligned bases (checked by the entry
  // point), so every row starts on a 16-byte boundary: one uint4 per thread
  uint4* dst = reinterpret_cast<uint4*>(arena + ((size_t)b * T + p) * row_bytes);
  const uint4* src = reinterpret_cast<const uint4*>(new_kv + (size_t)b * row_bytes);
  for (int i = threadIdx.x; i < row_bytes / 16; i += blockDim.x) dst[i] = src[i];
}

template <int D, bool kQuant>
void launch_decode(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* cur_len, void* out, float* part_m, float* part_l,
                   float* part_acc, int B, int Hq, int Hkv, int T, int splits, int blk, float scale,
                   cudaStream_t stream) {
  using Ty = DecodeTypes<kQuant>;
  dim3 grid(splits, Hkv, B);
  gqa_decode_split_kernel<D, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const typename Ty::q_t*>(q), static_cast<const typename Ty::kv_t*>(k),
      static_cast<const typename Ty::kv_t*>(v), k_scale, v_scale, cur_len, part_m, part_l, part_acc,
      Hkv, T, Hq / Hkv, splits, blk, scale);
  gqa_decode_reduce_kernel<D, typename Ty::out_t><<<B * Hq, D, 0, stream>>>(
      part_m, part_l, part_acc, cur_len, static_cast<typename Ty::out_t*>(out), Hq, T, splits, blk);
}

template <bool kQuant>
int decode_entry(const void* q, const void* k, const void* v, const float* k_scale,
                 const float* v_scale, const int* cur_len, void* out, float* part_m, float* part_l,
                 float* part_acc, int B, int Hq, int Hkv, int T, int D, int splits, int blk,
                 float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxRep || splits <= 0 || blk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    launch_decode<64, kQuant>(q, k, v, k_scale, v_scale, cur_len, out, part_m, part_l, part_acc, B,
                              Hq, Hkv, T, splits, blk, scale, s);
  } else if (D == 128) {
    launch_decode<128, kQuant>(q, k, v, k_scale, v_scale, cur_len, out, part_m, part_l, part_acc, B,
                               Hq, Hkv, T, splits, blk, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a shape the kernel does not take (the Python wrapper checks first).
int cvt_gqa_decode_attention(const void* q, const void* k, const void* v, const int* cur_len,
                             void* out, float* part_m, float* part_l, float* part_acc, int B,
                             int Hq, int Hkv, int T, int D, int splits, int blk, float scale,
                             void* stream) {
  return decode_entry<false>(q, k, v, nullptr, nullptr, cur_len, out, part_m, part_l, part_acc, B,
                             Hq, Hkv, T, D, splits, blk, scale, stream);
}

int cvt_gqa_decode_attention_quant(const void* q, const void* k, const void* v,
                                   const float* k_scale, const float* v_scale, const int* cur_len,
                                   void* out, float* part_m, float* part_l, float* part_acc, int B,
                                   int Hq, int Hkv, int T, int D, int splits, int blk, float scale,
                                   void* stream) {
  return decode_entry<true>(q, k, v, k_scale, v_scale, cur_len, out, part_m, part_l, part_acc, B,
                            Hq, Hkv, T, D, splits, blk, scale, stream);
}

int cvt_kv_arena_write(void* arena, const void* new_kv, const int* pos, int B, int T, int row_bytes,
                       void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(arena) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(new_kv) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  kv_arena_write_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(arena), static_cast<const uint8_t*>(new_kv), pos, T, row_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
