// Hand-written Hopper (sm_90a) kernels for the Qwen2 LM decode step.
//
// Built by cosyvoice_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into one shared library with a plain C interface, loaded with ctypes.
// Every entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrappers raise if that is not 0.
//
// ---------------------------------------------------------------------------
// K1  gqa_decode_kernel<D, kBf16> / <D, kF32>  (flash decode, one launch)
//
// Replaces: cosyvoice_tpu/ops/decode_attention.py:gqa_decode_attention
//   (pallas_call at :290, body _decode_kernel at :38).
// Computes: single-token GQA attention of q [B,Hq,D] against a KV arena
//   [B,T,Hkv,D]; keys at positions <= cur_len[b] are live, the rest is dead
//   arena that is never read. fp32 softmax; KV is never head-repeated.
// Bound on the H100: bytes. Per call it must read q, the live K and V rows
//   (2 * (cur_len+1) * Hkv * D * 2 bytes per batch row) and write the output;
//   at 3.35 TB/s that is ~0.16 us for one layer at cur_len 1023, B=1. The
//   arithmetic is 4 * Hq * D flops per live key, ~1/7 flop per byte read.
// Design: at B=1 the work is a few hundred KB, so the call is latency: a
//   launch, one DRAM round trip, a merge. The grid is (S, Hkv, B) with S
//   splits per (row, KV head) chosen on the host from B*Hkv alone (~132 /
//   (B*Hkv) blocks, ops/decode_attention.py:decode_plan; 66 at B=1), and
//   each split takes the live keys [floor(s*n/S), floor((s+1)*n/S)) with
//   n = cur_len+1 read on the device: every split is live once n >= S (16
//   keys each at cur_len 1023, B=1) and no host sync reads cur_len.
//   - One round trip: the block issues cp.async 16-byte copies of all its K
//     and V rows (and, for K3, the two scales of each key) into shared
//     memory before the first wait, in chunks of kChunk = 64 keys; on the
//     main path (B*Hkv <= 2, T <= 4096) a split is one chunk. Rows are
//     padded by 16 bytes, so the score loop reads them free of bank
//     conflicts. q, pre-scaled by 1/sqrt(D), sits in shared memory in f32.
//   - No per-key shuffle chain: a thread owns (query head, key) pairs and
//     dots over D from shared memory; each head's max and sum are one warp
//     reduction per chunk; for P.V a thread owns (head, dim pair) slots and
//     sums over the chunk's keys in key order. Chunks merge by the usual
//     online-softmax rescale.
//   - Merge in the same launch: each block writes (m, l, acc) for its
//     split to one scratch buffer, fences, and takes a ticket from an
//     integer counter per (row, KV head) (atomicAdd: integers only). The
//     block that draws the last ticket merges the S partials in split order
//     (log-sum-exp), with every load of the merge in flight at once (one L2
//     round trip at D=64, S <= 66: merging in dependent rounds cost more on
//     the H100 than the rest of the kernel), writes the output and puts the
//     counter back to 0, so
//     the counters (a persistent zeroed buffer of the wrapper's module) are
//     0 between calls and across CUDA-graph replays. A split with no live
//     key writes the neutral partial (m = -1e30, l = 0, acc = 0) without
//     reading the arena, so the merge needs no liveness test. The merge
//     order is fixed: a call repeats bit for bit.
//   A cluster over the splits with a DSMEM merge was not taken: a portable
//   cluster holds at most 8 blocks (16 with an opt-in), so at B=1 it would
//   cap the grid at 2 * 16 = 32 blocks.
//   The float32 instantiation (<D, kF32>: f32 q, arena and output) serves
//   the float32 LMs the JAX gate sends to its kernel (Hkv*D a multiple of
//   128; the Pallas kernel takes the arena's dtype as it is). Its rows are
//   twice as wide, so it stages 32 keys per round trip (kChunk / 2) to stay
//   inside the 48 KB of static shared memory at D=128.
//
// K3  gqa_decode_kernel<D, kInt8>  (int8 KV)
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
// Design: K1's kernel instantiated for int8 rows (64 bytes per row at D=64,
//   padded to 80 in shared memory), f32 q and output, and the two scales of
//   each key copied with 4-byte cp.async beside the rows.
//
// K2  kv_write_kernel  (KV arena row write: K, V and their scales in one launch)
//
// Replaces: cosyvoice_tpu/ops/decode_attention.py:kv_arena_write /
//   kv_arena_write_traced (pallas_call at :447, body _kv_write_kernel :413),
//   called once for K and once for V, and over the int8 arena the two
//   masked-select scale writes beside them (cosyvoice_tpu/models/
//   qwen2.py:265-278), which one compiled step fuses on the TPU.
// Computes: k_arena[b, pos[b]] = k_new[b] and v_arena[b, pos[b]] = v_new[b]
//   in place, for every row b (a batch row, or a layer of the stacked
//   arena of the fused decode step, where one pos serves every layer), for
//   bf16, float32 and int8 arenas alike (a row is Hkv*D elements, copied as
//   bytes: the float32 row of the float32 LMs is the same copy, 4 bytes an
//   element);
//   over the int8 arena also k_scale[b, pos[b]] = ks[b] and
//   v_scale[b, pos[b]] = vs[b]. One arena alone (no V) is the JAX
//   function's single write.
// Bound on the H100: bytes. It reads 2 * B * Hkv * D new values and writes
//   as many (1 KB at B=1 for Qwen2-0.5B in bf16, 512 B in int8): ~0.0003 us,
//   far below the cost of a launch, which sets its time. So the design is
//   one launch per layer and step where the port made two (K, V) or four
//   (K, V and two scale writes over the int8 arena), and one per step of the
//   fused decode for all layers.
// Design: one block per row copies the row's K and V bytes (128 B each in
//   int8, 256 B in bf16) with 16-byte vector loads and stores, one vector a
//   thread (the row must be a multiple of 16 bytes and every tensor 16-byte
//   aligned), and two threads write the scales; the new rows, the scales and
//   pos are all loaded before the first store, so the launch makes one
//   memory round trip. The rest of the arena is never touched (the TPU
//   kernel rewrites one 8-row tile group per row in bf16, 32 in int8).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = kWarps;  // a warp owns one query head in the softmax and the merge
constexpr int kChunk = 64;       // keys staged in shared memory per round trip
constexpr int kMaxSplits = 132;  // splits per (row, KV head): one per SM at most
constexpr float kNegInf = -1e30f;

// Element types of the three instantiations: K1 in bf16 (bf16 q, arena and
// output) and in float32 (f32 q, arena and output), and K3 (f32 q and
// output, int8 arena with f32 per-token scales).
constexpr int kBf16 = 0, kInt8 = 1, kF32 = 2;
template <int kKind>
struct DecodeTypes {
  using q_t = __nv_bfloat16;
  using kv_t = __nv_bfloat16;
  using out_t = __nv_bfloat16;
};
template <>
struct DecodeTypes<kInt8> {
  using q_t = float;
  using kv_t = int8_t;
  using out_t = float;
};
template <>
struct DecodeTypes<kF32> {
  using q_t = float;
  using kv_t = float;
  using out_t = float;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// The two neighbouring elements of a shared-memory row at p, in f32.
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f32(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_f32(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// The 16 bytes at p (a shared-memory row slice) as f32: 8 bf16, 4 f32 or 16 int8.
__device__ __forceinline__ void vec_f32(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void vec_f32(const float* p, float (&f)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  f[0] = w.x;
  f[1] = w.y;
  f[2] = w.z;
  f[3] = w.w;
}
__device__ __forceinline__ void vec_f32(const int8_t* p, float (&f)[16]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(static_cast<int>(words[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Live keys of row b: positions 0..cur_len[b], clamped to the arena.
__device__ __forceinline__ int live_keys(const int* cur_len, int b, int T) {
  int n = cur_len[b] + 1;
  return n < 1 ? 1 : (n > T ? T : n);
}

// First key of split s of n live keys in S splits (decode_split_range in
// ops/decode_attention.py mirrors it): the splits cover [0, n) in order,
// each floor(n/S) or ceil(n/S) keys.
__device__ __forceinline__ int split_begin(int s, int n, int S) {
  return static_cast<int>(static_cast<long long>(s) * n / S);
}

template <int D, int kKind>
__global__ void __launch_bounds__(kThreads) gqa_decode_kernel(
    const typename DecodeTypes<kKind>::q_t* __restrict__ q,   // [B, Hq, D]
    const typename DecodeTypes<kKind>::kv_t* __restrict__ k,  // [B, T, Hkv, D]
    const typename DecodeTypes<kKind>::kv_t* __restrict__ v,  // [B, T, Hkv, D]
    const float* __restrict__ k_scale,  // [B, T] (K3 only)
    const float* __restrict__ v_scale,  // [B, T] (K3 only)
    const int* __restrict__ cur_len,    // [B]
    typename DecodeTypes<kKind>::out_t* __restrict__ out,  // [B, Hq, D]
    float* part,     // m [B*Hq, S], l [B*Hq, S], acc [B*Hq, S, D]
    int* counters,   // [B * Hkv], 0 between calls
    int Hkv, int T, int rep, int splits, float scale) {
  using kv_t = typename DecodeTypes<kKind>::kv_t;
  constexpr bool kQuant = kKind == kInt8;
  constexpr int kCh = sizeof(kv_t) == 4 ? kChunk / 2 : kChunk;  // keys staged per round trip
  constexpr int kVec = 16 / sizeof(kv_t);      // elements per 16-byte copy
  constexpr int kVecPerRow = D / kVec;
  constexpr int kRow = D + kVec;               // shared row stride: 16 bytes of padding
  constexpr int kQRow = D + 4;
  constexpr int kDP = D / 2;                   // dim pairs of a head
  constexpr int kHeadGroups = kThreads / kDP;  // 4 at D=64, 2 at D=128
  constexpr int kHPT = kMaxRep / kHeadGroups;  // head slots per thread
  constexpr int kBatch = kMaxSplits / 2;      // partials a merging thread loads at once
  constexpr int kLaneSplits = (kMaxSplits + 31) / 32;

  __shared__ __align__(16) kv_t ks_[kCh * kRow];
  __shared__ __align__(16) kv_t vs_[kCh * kRow];
  __shared__ __align__(16) float qs[kMaxRep * kQRow];
  __shared__ float ps[kMaxRep * kChunk];  // scores, then softmax weights
  __shared__ float ksc[kChunk], vsc[kChunk];
  __shared__ float m_run[kMaxRep], l_run[kMaxRep], corr[kMaxRep];
  __shared__ float wgt[kMaxRep * kMaxSplits];  // merge weights of the last block
  __shared__ int is_last;

  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dp = tid % kDP, hg = tid / kDP;
  const int n_live = live_keys(cur_len, b, T);
  const int key0 = split_begin(s, n_live, splits), key1 = split_begin(s + 1, n_live, splits);
  const int Hq = Hkv * rep;
  const size_t row = (size_t)Hkv * D;
  const kv_t* kb = k + (size_t)b * T * row + (size_t)g * D;
  const kv_t* vb = v + (size_t)b * T * row + (size_t)g * D;

  // issue every copy of one chunk of keys [c0, c0 + nk): K rows, V rows and
  // (K3) their scales, all before anything waits on them
  auto issue = [&](int c0, int nk) {
    for (int idx = tid; idx < 2 * nk * kVecPerRow; idx += kThreads) {
      const int which = idx / (nk * kVecPerRow), rem = idx % (nk * kVecPerRow);
      const int j = rem / kVecPerRow, c = rem % kVecPerRow;
      cp_async16((which ? vs_ : ks_) + j * kRow + c * kVec, (which ? vb : kb) + (size_t)(c0 + j) * row + c * kVec);
    }
    if constexpr (kQuant) {
      for (int j = tid; j < 2 * nk; j += kThreads) {
        const bool is_v = j >= nk;
        const int jj = is_v ? j - nk : j;
        cp_async4((is_v ? vsc : ksc) + jj, (is_v ? v_scale : k_scale) + (size_t)b * T + c0 + jj);
      }
    }
  };
  if (key0 < key1) issue(key0, min(kCh, key1 - key0));

  for (int idx = tid; idx < rep * D; idx += kThreads)
    qs[(idx / D) * kQRow + idx % D] = to_f32(q[((size_t)b * Hq + g * rep) * D + idx]) * scale;
  if (tid < kMaxRep) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }
  float acc[kHPT][2];
#pragma unroll
  for (int i = 0; i < kHPT; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int c0 = key0; c0 < key1; c0 += kCh) {
    const int nk = min(kCh, key1 - c0);
    if (c0 != key0) issue(c0, nk);
    cp_async_wait_all();
    __syncthreads();

    // scores: a thread owns (head, key) pairs and dots over D (four
    // independent partial sums, added in a fixed order)
    for (int idx = tid; idx < rep * nk; idx += kThreads) {
      const int r = idx / nk, j = idx % nk;
      const float* qr = qs + r * kQRow;
      const kv_t* kr = ks_ + j * kRow;
      float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kVecPerRow; ++c) {
        float f[kVec];
        vec_f32(kr + c * kVec, f);
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + c * kVec + e);
          p4[0] = fmaf(qv.x, f[e], p4[0]);
          p4[1] = fmaf(qv.y, f[e + 1], p4[1]);
          p4[2] = fmaf(qv.z, f[e + 2], p4[2]);
          p4[3] = fmaf(qv.w, f[e + 3], p4[3]);
        }
      }
      float p = (p4[0] + p4[1]) + (p4[2] + p4[3]);
      if constexpr (kQuant) p *= ksc[j];  // column dequant of the score
      ps[r * kChunk + j] = p;
    }
    __syncthreads();

    // one max and one sum per head per chunk, warp r taking head r; the
    // weights replace the scores. Warps past rep repeat the last head and
    // write nothing: a `warp < rep` branch around this and the merge's
    // weights step measured slower on the H100.
    {
      const int r = min(warp, rep - 1);
      float mx = kNegInf;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, ps[r * kChunk + j]);
      const float m_new = fmaxf(m_run[r], warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float e = __expf(ps[r * kChunk + j] - m_new);
        sum += e;
        float w = e;
        if constexpr (kQuant) w *= vsc[j];  // v dequant folded into the weight
        if (warp < rep) ps[r * kChunk + j] = w;
      }
      sum = warp_sum(sum);
      if (lane == 0 && warp < rep) {
        const float cr = __expf(m_run[r] - m_new);
        corr[r] = cr;
        l_run[r] = l_run[r] * cr + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: a thread owns (head, dim pair) slots and sums over keys in order;
    // each V pair is read once for all of the thread's heads
    {
      int hr[kHPT];
#pragma unroll
      for (int i = 0; i < kHPT; ++i) {
        hr[i] = min(hg + i * kHeadGroups, rep - 1);
        acc[i][0] *= corr[hr[i]];
        acc[i][1] *= corr[hr[i]];
      }
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const float2 vv = pair_f32(vs_ + j * kRow + 2 * dp);
#pragma unroll
        for (int i = 0; i < kHPT; ++i) {
          const float w = ps[hr[i] * kChunk + j];
          acc[i][0] = fmaf(w, vv.x, acc[i][0]);
          acc[i][1] = fmaf(w, vv.y, acc[i][1]);
        }
      }
    }
    __syncthreads();  // the next chunk's copies overwrite ks_, vs_ and ps
  }

  // this split's partial (neutral if it had no live key)
  const int bh0 = b * Hq + g * rep;
  float* part_m = part;
  float* part_l = part + (size_t)gridDim.z * Hq * splits;
  float* part_acc = part + 2 * (size_t)gridDim.z * Hq * splits;
#pragma unroll
  for (int i = 0; i < kHPT; ++i) {
    const int r = hg + i * kHeadGroups;
    if (r < rep)
      *reinterpret_cast<float2*>(part_acc + ((size_t)(bh0 + r) * splits + s) * D + 2 * dp) =
          make_float2(acc[i][0], acc[i][1]);
  }
  if (tid < rep) {
    part_m[(size_t)(bh0 + tid) * splits + s] = m_run[tid];
    part_l[(size_t)(bh0 + tid) * splits + s] = l_run[tid];
  }

  // the last of the S blocks of this (row, KV head) merges all partials
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + b * Hkv + g, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The merge issues its loads in batches: a thread owns (head, dim pair)
  // slots and loads up to kBatch splits of one slot at once; the first
  // batch goes out before the weights step, whose m and l loads go out
  // together, so at D=64 and S <= kBatch the merge is one round trip.
  __shared__ float L_all[kMaxRep];
  float2 v2[kBatch];
  const int r0 = min(tid / kDP, rep - 1);
  const float* pa0 = part_acc + (size_t)(bh0 + r0) * splits * D + 2 * (tid % kDP);
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (u < splits) v2[u] = __ldcg(reinterpret_cast<const float2*>(pa0 + (size_t)u * D));
  {  // warp r: head r's weights and L (warps past rep repeat the last head)
    const int r = min(warp, rep - 1);
    const size_t base = (size_t)(bh0 + r) * splits;
    float mv[kLaneSplits], lv[kLaneSplits];
#pragma unroll
    for (int u = 0; u < kLaneSplits; ++u) {
      const int t = lane + 32 * u;
      mv[u] = t < splits ? __ldcg(part_m + base + t) : kNegInf;
      lv[u] = t < splits ? __ldcg(part_l + base + t) : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < kLaneSplits; ++u) mx = fmaxf(mx, mv[u]);
    mx = warp_max(mx);
    float L = 0.f;
#pragma unroll
    for (int u = 0; u < kLaneSplits; ++u) {
      const int t = lane + 32 * u;
      const float w = t < splits ? __expf(mv[u] - mx) : 0.f;
      if (warp < rep && t < splits) wgt[r * kMaxSplits + t] = w;
      L = fmaf(lv[u], w, L);
    }
    L = warp_sum(L);
    if (lane == 0 && warp < rep) L_all[r] = L;
  }
  __syncthreads();
  // out = sum over splits in order of acc_s * w_s, over L
  for (int slot = tid; slot < rep * kDP; slot += kThreads) {
    const int r = slot / kDP;
    const float* pa = part_acc + (size_t)(bh0 + r) * splits * D + 2 * (slot % kDP);
    const float* wr = wgt + r * kMaxSplits;
    float a0 = 0.f, a1 = 0.f;
    for (int t0 = 0; t0 < splits; t0 += kBatch) {
      if (slot != tid || t0 != 0) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (t0 + u < splits) v2[u] = __ldcg(reinterpret_cast<const float2*>(pa + (size_t)(t0 + u) * D));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t0 + u < splits) {
          const float w = wr[t0 + u];
          a0 = fmaf(v2[u].x, w, a0);
          a1 = fmaf(v2[u].y, w, a1);
        }
      }
    }
    auto* o = out + (size_t)(bh0 + r) * D + 2 * (slot % kDP);
    store(o, a0 / L_all[r]);
    store(o + 1, a1 / L_all[r]);
  }
  if (tid == 0) counters[b * Hkv + g] = 0;  // ready for the next call
}

__global__ void kv_write_kernel(
    uint8_t* __restrict__ k_arena, uint8_t* __restrict__ v_arena,  // [B, T, row_bytes]; v_arena may be null
    const uint8_t* __restrict__ k_new, const uint8_t* __restrict__ v_new,  // [B, row_bytes]
    const int* __restrict__ pos, int pos_stride,  // row b writes at pos[b * pos_stride]
    float* __restrict__ k_scale, float* __restrict__ v_scale,  // [B, T] or null
    const float* __restrict__ ks, const float* __restrict__ vs,  // [B]
    int T, int row_bytes) {
  // thread i < n16 copies 16-byte vector i of the K row, n16 <= i < 2 * n16 vector i - n16 of the V row
  // (row_bytes % 16 == 0 and 16-byte-aligned bases, checked by the entry point); threads 0 and 1 the scales.
  // Every load (the new vector, the scale, pos) goes out before the first store: one round trip, not two.
  const int b = blockIdx.x, i = threadIdx.x, n16 = row_bytes / 16;
  const bool is_v = i >= n16, live = i < 2 * n16 && (!is_v || v_arena != nullptr);
  uint4 vec = make_uint4(0, 0, 0, 0);
  if (live) vec = reinterpret_cast<const uint4*>(is_v ? v_new : k_new)[(size_t)b * n16 + i % n16];
  const bool scale = k_scale != nullptr && i < 2;
  const float sv = scale ? (i == 0 ? ks : vs)[b] : 0.f;
  const int p = pos[b * pos_stride];
  if (p < 0 || p >= T) return;  // out of the arena: nothing is written
  const size_t row = (size_t)b * T + p;
  if (live) reinterpret_cast<uint4*>(is_v ? v_arena : k_arena)[row * n16 + i % n16] = vec;
  if (scale) (i == 0 ? k_scale : v_scale)[row] = sv;
}

// Launches nothing useful: the floor of a launch, against which K2 is timed.
__global__ void empty_kernel() {}

template <int D, int kKind>
void launch_decode(const void* q, const void* k, const void* v, const float* k_scale, const float* v_scale,
                   const int* cur_len, void* out, float* part, int* counters, int B, int Hq, int Hkv, int T,
                   int splits, float scale, cudaStream_t stream) {
  using Ty = DecodeTypes<kKind>;
  gqa_decode_kernel<D, kKind><<<dim3(splits, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const typename Ty::q_t*>(q), static_cast<const typename Ty::kv_t*>(k),
      static_cast<const typename Ty::kv_t*>(v), k_scale, v_scale, cur_len, static_cast<typename Ty::out_t*>(out),
      part, counters, Hkv, T, Hq / Hkv, splits, scale);
}

template <int kKind>
int decode_entry(const void* q, const void* k, const void* v, const float* k_scale, const float* v_scale,
                 const int* cur_len, void* out, float* part, int* counters, int B, int Hq, int Hkv, int T, int D,
                 int splits, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || T <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxRep || splits <= 0 ||
      splits > kMaxSplits || reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    launch_decode<64, kKind>(q, k, v, k_scale, v_scale, cur_len, out, part, counters, B, Hq, Hkv, T, splits,
                              scale, s);
  } else if (D == 128) {
    launch_decode<128, kKind>(q, k, v, k_scale, v_scale, cur_len, out, part, counters, B, Hq, Hkv, T, splits,
                               scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take (the Python wrapper checks first).
// part: 2 * B*Hq*splits + B*Hq*splits*D floats of scratch; counters: B*Hkv
// ints, all 0 on entry and again on exit.
int cvt_gqa_decode_attention(const void* q, const void* k, const void* v, const int* cur_len, void* out, float* part,
                             int* counters, int B, int Hq, int Hkv, int T, int D, int splits, float scale,
                             void* stream) {
  return decode_entry<kBf16>(q, k, v, nullptr, nullptr, cur_len, out, part, counters, B, Hq, Hkv, T, D, splits,
                             scale, stream);
}

// K1 in float32: q, arenas and output float32, otherwise cvt_gqa_decode_attention.
int cvt_gqa_decode_attention_f32(const void* q, const void* k, const void* v, const int* cur_len, void* out,
                                 float* part, int* counters, int B, int Hq, int Hkv, int T, int D, int splits,
                                 float scale, void* stream) {
  return decode_entry<kF32>(q, k, v, nullptr, nullptr, cur_len, out, part, counters, B, Hq, Hkv, T, D, splits,
                            scale, stream);
}

int cvt_gqa_decode_attention_quant(const void* q, const void* k, const void* v, const float* k_scale,
                                   const float* v_scale, const int* cur_len, void* out, float* part, int* counters,
                                   int B, int Hq, int Hkv, int T, int D, int splits, float scale, void* stream) {
  return decode_entry<kInt8>(q, k, v, k_scale, v_scale, cur_len, out, part, counters, B, Hq, Hkv, T, D, splits,
                            scale, stream);
}

// K2: k_arena / k_new always; v_arena / v_new both or neither; the four
// scale pointers all or none; pos_stride 0 (one pos for every row) or 1.
int cvt_kv_arena_write_kv(void* k_arena, void* v_arena, const void* k_new, const void* v_new, const int* pos,
                          int pos_stride, float* k_scale, float* v_scale, const float* ks, const float* vs, int B,
                          int T, int row_bytes, void* stream) {
  auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool v_ok = (v_arena == nullptr) == (v_new == nullptr);
  const bool s_ok = (k_scale == nullptr) == (v_scale == nullptr) && (k_scale == nullptr) == (ks == nullptr) &&
                    (k_scale == nullptr) == (vs == nullptr) && (k_scale == nullptr || v_arena != nullptr);
  if (B <= 0 || T <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes > 16 * 512 || !v_ok || !s_ok ||
      (pos_stride != 0 && pos_stride != 1) || !a16(k_arena) || !a16(v_arena) || !a16(k_new) || !a16(v_new))
    return (int)cudaErrorInvalidValue;
  const int threads = row_bytes / 8 < 32 ? 32 : (row_bytes / 8 + 31) / 32 * 32;  // a vector of K or V each
  kv_write_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(k_arena), static_cast<uint8_t*>(v_arena), static_cast<const uint8_t*>(k_new),
      static_cast<const uint8_t*>(v_new), pos, pos_stride, k_scale, v_scale, ks, vs, T, row_bytes);
  return (int)cudaGetLastError();
}

int cvt_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
