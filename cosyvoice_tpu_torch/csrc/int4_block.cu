// Hand-written Hopper (sm_90a) kernel for one whole int4p decode step (K7).
//
// Built with the other csrc/*.cu files by cosyvoice_tpu_torch/ops/_build.py
// (plain C interface, loaded with ctypes). The entry point launches on the
// stream it is given and returns the launch's error code; the Python wrapper
// (ops/int4_block.py:int4_decode_layers) raises if it is not 0.
//
// ---------------------------------------------------------------------------
// K7  int4_decode_layers_kernel  (every layer of one B=1 decode step)
//
// Replaces: cosyvoice_tpu/ops/int4_block.py:int4_decode_layers (pallas_call
//   at :295, body _decode_layers_kernel :63; XLA reference
//   int4_decode_layers_reference :318).
// Computes, for l = 0 .. L-1, on the f32 residual x (layer 0: the bf16 input):
//   hnorm = bf16(rmsnorm(x) * nw1[l]); qkv = hnorm @ Wqkv[l] + b[l] (f32);
//   q, k_new = rope(q, k) at pos, q / sqrt(d); v_new = v (f32);
//   attention of each query head over the arena keys < pos of its KV head
//   plus the fresh (k_new, v_new) self term, in f32 -> attn_row in bf16;
//   x2 = x + attn_row @ Wo[l]; h2 = bf16(rmsnorm(x2) * nw2[l]);
//   act = bf16(silu(h2 @ Wg) * (h2 @ Wu)); x = bf16(x2 + act @ Wd) (kept f32).
//   Outputs: x_out = bf16(x) [H] and the new rows k_new, v_new [L, Hkv*d] in
//   bf16. The arena is read-only; the caller commits the rows (K2). The
//   stale arena row AT pos is never read: the self term comes from shared
//   memory. Keys >= pos are never read, so NaN there cannot reach the output.
// Bound on the H100: bytes. Full-width CosyVoice2-0.5B (24 layers, H 896,
//   14/2 heads, d 64, intermediate 4864 padded to 5120) reads ~198 MB of
//   packed int4 weights + ~8 MB of scales, norms and biases per step, plus
//   2 * 24 * pos * 256 B of live arena rows (12.6 MB at pos 1023):
//   ~65 us at 3.35 TB/s. ~2 flops per weight byte.
// Design: one cooperative launch per step, one block per SM, a loop over the
//   layers inside, five phases per layer separated by grid barriers. The
//   work of every phase is fixed per block before the launch
//   (ops/int4_fused.py:resident_plan; units of int4_resident.cuh), and none
//   of the step's weights depends on what the step computes, so each block
//   streams its share of the weights into shared memory ahead of use: a ring
//   of five stages, one per phase (a layer's share, ~90 KB), each refilled
//   with the next layer's share as soon as the phase that read it is done,
//   so the copies run through the barriers and have a whole layer's time to
//   land. The arena rows and bias of a block's attention items are a stage
//   too (pos is known at launch). Per layer:
//   A. every block: x = bf16(x2 + the down partials) and the input norm
//      (the same bits in every block); qkv units (64 columns, one split of
//      the input's scale blocks) write f32 partials.
//   B. attention items (KV head g, chunk of kChunk keys < pos), item i on
//      block i mod grid: q, k, v of the group from the qkv partials and the
//      bias (copied with the item's arena rows), rope; one warp per query
//      head scores the chunk's keys (in shared memory) and writes an
//      (m, l, acc) partial; chunk 0 adds the f32 self term and writes k_new,
//      v_new.
//   C. o_proj units (64 columns, one scale block of the input: 4 heads):
//      each merges the partials of its heads in chunk order (one round of
//      loads, two warps a head) into its bf16 input, then writes f32
//      partials. (A merge by the last item of each KV head, behind a ticket
//      counter, put ~6 us per layer on the critical path at pos 1023 on an
//      H100; the o units merge each head 14 times over, in parallel, in the
//      round trip they spend reading their input anyway.)
//   D. every block: x2 = x + the o partials, the post-attention norm;
//      gate|up units (64 columns, both planes, whole input) write
//      act = bf16(silu(g) * u).
//   E. down units (64 columns, a split of the scale blocks) write f32
//      partials.
//   No float atomics: every cross-block sum is a fixed-order sum of f32
//   partials, so runs repeat bit for bit.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_resident.cuh"

namespace {

constexpr int kD = 64;          // head_dim the kernel takes
constexpr int kMaxRep = 8;      // query heads per KV head
constexpr int kChunk = 32;      // arena keys per attention item: one per lane
constexpr int kMaxChunks = 64;  // chunks per KV head (arena rows <= kMaxChunks * kChunk)
constexpr int kStages = 5;      // ring stages per layer: nw1 + qkv, arena rows + bias, o, nw2 + gate|up, down
constexpr int kItemBytes = kChunk * 2 * kD * 2 + (kMaxRep + 2) * kD * 4;  // K, V rows, the group's qkv bias
constexpr float kNegInf = -1e30f;

struct Params {
  const __nv_bfloat16* x;                  // [H] layer-0 input
  const float* cos;                        // [d/2] rope at pos
  const float* sin;                        // [d/2]
  const int* pos;                          // [1]
  const __nv_bfloat16* ka;                 // [L, A, Hkv*d] read-only arena
  const __nv_bfloat16* va;                 // [L, A, Hkv*d]
  const float* nw1;                        // [L, H]
  const float* nw2;                        // [L, H]
  const float* qkv_b;                      // [L, nqkv]
  // tensor maps of the stacked weights (packed rows x columns, scale rows x columns): qkv [L, nbq, half_q,
  // nqkv], o [L, nbo, half_o, H], gate|up [L, 2, nb_in, half_in, I], down [L, nd, half_d, H]; and of the
  // arenas as [L * A, Hkv * d] with boxes of kChunk rows of one head
  WeightMaps mq, mo, mg, md;
  CUtensorMap mk, mv;
  __nv_bfloat16* x_out;                    // [H]
  __nv_bfloat16* k_new;                    // [L, Hkv*d]
  __nv_bfloat16* v_new;                    // [L, Hkv*d]
  // scratch written and read inside the launch: read through L2 (ld.cg)
  float* part_q;                           // [kq, nqkv]
  float* part_m;                           // [Hkv, kMaxChunks, kMaxRep]
  float* part_l;                           // [Hkv, kMaxChunks, kMaxRep]
  float* part_acc;                         // [Hkv, kMaxChunks, kMaxRep, d]
  float* part_o;                           // [ko, H]
  __nv_bfloat16* act;                      // [I]
  float* part_d;                           // [kd, H]
  unsigned* bar;                           // [2] grid barrier, 0 between launches
  const int* plan;                         // [grid, 4, 1 + maxu]: count, unit ids (qkv, o, gate|up, down)
  int L, A, H, n_heads, n_kv, nbq, half_q, nqkv, nbo, half_o, nb_in, half_in, I, nd, half_d;
  int kq, ko, kd, maxu, kv_items, parts_q, parts_o, parts_g, parts_d, slot_bytes, xs_bytes;
  float eps;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// This block's units and where each stage of a layer lies in its ring (bytes).
struct Layout {
  int n[4];               // units: qkv, o, gate|up, down
  const int* ids[4];      // unit id: split * tiles + tile (gate|up: the tile)
  UnitShape u[4];
  int tiles[4];
  int off[kStages + 1];   // stage offsets; off[kStages] = the ring's used bytes
};

__device__ Layout layout(const Params& p) {
  Layout t;
  const int* mine = p.plan + (size_t)blockIdx.x * 4 * (1 + p.maxu);
  for (int k = 0; k < 4; ++k) {
    t.n[k] = mine[k * (1 + p.maxu)];
    t.ids[k] = mine + k * (1 + p.maxu) + 1;
  }
  t.u[0] = {1, p.nbq / p.kq, p.half_q, p.nqkv, p.parts_q};
  t.u[1] = {1, p.nbo / p.ko, p.half_o, p.H, p.parts_o};
  t.u[2] = {2, p.nb_in, p.half_in, p.I, p.parts_g};
  t.u[3] = {1, p.nd / p.kd, p.half_d, p.H, p.parts_d};
  t.tiles[0] = p.nqkv / kUnitCols;
  t.tiles[1] = t.tiles[3] = p.H / kUnitCols;
  t.tiles[2] = p.I / kUnitCols;
  t.off[0] = 0;
  t.off[1] = t.off[0] + p.H * 4 + t.n[0] * t.u[0].bytes();  // nw1, qkv images
  t.off[2] = t.off[1] + p.kv_items * kItemBytes;             // per attention item: K, V rows, bias
  t.off[3] = t.off[2] + t.n[1] * t.u[1].bytes();
  t.off[4] = t.off[3] + p.H * 4 + t.n[2] * t.u[2].bytes();   // nw2, gate|up images
  t.off[5] = t.off[4] + t.n[3] * t.u[3].bytes();
  return t;
}

// Issues (one thread) the copies of unit k of kind w (0 qkv, 1 o, 2 gate|up, 3 down) of layer l into dst.
__device__ void copy_kind(const Params& p, const Layout& t, int w, int k, int l, uint8_t* dst, uint64_t* bar) {
  const int id = t.ids[w][k], c0 = (id % t.tiles[w]) * kUnitCols, b0 = (id / t.tiles[w]) * t.u[w].nb;
  if (w == 0)
    copy_unit(dst, t.u[0], p.mq, l * p.nbq * p.half_q, 0, l * p.nbq, 0, b0, c0, bar);
  else if (w == 1)
    copy_unit(dst, t.u[1], p.mo, l * p.nbo * p.half_o, 0, l * p.nbo, 0, b0, c0, bar);
  else if (w == 2)
    copy_unit(dst, t.u[2], p.mg, l * 2 * p.nb_in * p.half_in, p.nb_in * p.half_in, l * 2 * p.nb_in, p.nb_in, 0, c0,
              bar);
  else
    copy_unit(dst, t.u[3], p.md, l * p.nd * p.half_d, 0, l * p.nd, 0, b0, c0, bar);
}

// Issues (one thread) the copies of stage s of layer l into its place in the ring, announced on bar; nothing
// past the last layer.
__device__ void issue_stage(const Params& p, const Layout& t, uint8_t* ring, int l, int s, int pos, int n_chunks,
                            uint64_t* bar) {
  if (l >= p.L) return;
  const int lanes = p.n_kv * kD, rep = p.n_heads / p.n_kv, nq = p.n_heads * kD;
  uint8_t* dst = ring + t.off[s];
  if (s == 1) {
    uint32_t bytes = 0;
    for (int k = 0; k < p.kv_items && blockIdx.x + k * gridDim.x < p.n_kv * n_chunks; ++k)
      bytes += 2 * min(kChunk, pos - (int)((blockIdx.x + k * gridDim.x) / p.n_kv) * kChunk) * kD * 2 +
               (rep + 2) * kD * 4;
    mbar_expect(bar, bytes);
    for (int k = 0; k < p.kv_items; ++k) {
      const int item = blockIdx.x + k * gridDim.x;
      if (item >= p.n_kv * n_chunks) break;
      const int g = item % p.n_kv, key0 = (item / p.n_kv) * kChunk, n = min(kChunk, pos - key0);
      uint8_t* d = dst + (size_t)k * kItemBytes;
      if (n == kChunk) {  // a whole chunk: one box of K rows, one of V rows
        tma_box(d, &p.mk, g * kD, l * p.A + key0, bar);
        tma_box(d + kChunk * kD * 2, &p.mv, g * kD, l * p.A + key0, bar);
      } else {  // the last, partial chunk: its live rows one by one (no row >= pos is read)
        for (int j = 0; j < n; ++j) {
          const size_t row = ((size_t)l * p.A + key0 + j) * lanes + g * kD;
          bulk_copy(d + (size_t)j * kD * 2, p.ka + row, kD * 2, bar);
          bulk_copy(d + (size_t)(kChunk + j) * kD * 2, p.va + row, kD * 2, bar);
        }
      }
      // the group's bias: its q heads, then k, then v
      float* bias = reinterpret_cast<float*>(d + kChunk * 2 * kD * 2);
      const float* b = p.qkv_b + (size_t)l * p.nqkv;
      bulk_copy(bias, b + g * rep * kD, rep * kD * 4, bar);
      bulk_copy(bias + rep * kD, b + nq + g * kD, kD * 4, bar);
      bulk_copy(bias + (rep + 1) * kD, b + nq + lanes + g * kD, kD * 4, bar);
    }
    return;
  }
  const int w = s == 0 ? 0 : s - 1;  // stages 0, 2, 3, 4 hold units of kinds 0, 1, 2, 3
  const bool norm = s == 0 || s == 3;
  mbar_expect(bar, t.n[w] * t.u[w].bytes() + (norm ? p.H * 4 : 0));
  if (norm) {
    bulk_copy(dst, (s == 0 ? p.nw1 : p.nw2) + (size_t)l * p.H, p.H * 4, bar);
    dst += p.H * 4;
  }
  for (int k = 0; k < t.n[w]; ++k) copy_kind(p, t, w, k, l, dst + (size_t)k * t.u[w].bytes(), bar);
}

// xdst[hh * d + i] = bf16 of head h0 + hh's attention output (hh < nh <= kResWarps / 2; zero past the last
// head), its n_chunks (m, l, acc) partials merged in chunk order. Two warps per head, each half of the chunks:
// the lane's chunk's m and l and the first 16 chunks' acc of its two dims go out in one round of loads; M and L
// over both halves meet in shared memory (red: 2 * kResWarps floats, then kResWarps * 32 float2; wgt: the
// weights of each warp's chunks).
__device__ void merge_heads(const Params& p, int h0, int nh, int n_chunks, __nv_bfloat16* xdst, float* red,
                            float* wgt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rep = p.n_heads / p.n_kv;
  const int hh = warp % nh, half = warp / nh, h = h0 + hh, hc = (n_chunks + 1) / 2, c0 = half * hc;
  const int cnt = half < 2 && h < p.n_heads ? min(hc, n_chunks - c0) : 0;
  const size_t base = ((size_t)(h / rep) * kMaxChunks) * kMaxRep + h % rep;
  float* mx = red;                                                // [warps] max of m
  float* ls = red + kResWarps;                                    // [warps] sum of w * l
  float2* part = reinterpret_cast<float2*>(red + 2 * kResWarps);  // [warps][32] acc sums
  float* wv = wgt + warp * 32;                                    // the warp's chunks' weights
  auto acc_of = [&](int j) {  // the lane's two dims of chunk c0 + j's acc
    return __ldcg(reinterpret_cast<const float2*>(p.part_acc + (base + (size_t)(c0 + j) * kMaxRep) * kD) + lane);
  };
  float mv = kNegInf, lv = 0.f;
  if (lane < cnt) {
    mv = ld_cg(p.part_m + base + (size_t)(c0 + lane) * kMaxRep);
    lv = ld_cg(p.part_l + base + (size_t)(c0 + lane) * kMaxRep);
  }
  float2 av[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) av[j] = j < cnt ? acc_of(j) : make_float2(0.f, 0.f);
  const float m_half = warp_max(mv);
  if (lane == 0) mx[warp] = m_half;
  __syncthreads();
  const float M = half < 2 ? fmaxf(mx[hh], mx[hh + nh]) : 0.f;
  const float w = lane < cnt ? expf(mv - M) : 0.f;
  wv[lane] = w;
  const float l_half = warp_sum(w * lv);
  if (lane == 0) ls[warp] = l_half;
  __syncwarp();
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    a0 += wv[j] * av[j].x;
    a1 += wv[j] * av[j].y;
  }
  for (int j = 16; j < cnt; ++j) {  // past 32 chunks a head (arenas over 1024 rows): a second pass
    const float2 a = acc_of(j);
    a0 += wv[j] * a.x;
    a1 += wv[j] * a.y;
  }
  if (half < 2) part[warp * 32 + lane] = make_float2(a0, a1);
  __syncthreads();
  if (half == 0) {
    const float2 s0 = part[warp * 32 + lane], s1 = part[(warp + nh) * 32 + lane];
    const float L = ls[warp] + ls[warp + nh];
    reinterpret_cast<__nv_bfloat162*>(xdst + hh * kD)[lane] =
        h < p.n_heads ? __floats2bfloat162_rn((s0.x + s1.x) / L, (s0.y + s1.y) / L) : __floats2bfloat162_rn(0.f, 0.f);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kResThreads, 1) int4_decode_layers_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t dyn[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dyn);  // the current phase's bf16 activations
  uint8_t* ring = dyn + p.xs_bytes;                            // one stage per phase: a layer's share
  __shared__ float xres[kResMaxHid];                              // residual x (f32, bf16 values at layer boundaries)
  __shared__ float x2s[kResMaxHid];                               // x2 = x + o
  __shared__ __align__(16) float red[kMaxItems * kUnitCols];
  __shared__ float sm[kResWarps];
  __shared__ float qkv_sm[(kMaxRep + 2) * kD];  // q of the item's heads, then k_new, v_new (f32)
  __shared__ float wgt[kResWarps][32];          // merge weights of each warp's chunks
  __shared__ float rope[kD];                    // cos, then sin
  __shared__ __align__(8) uint64_t mbar[kStages];  // one per stage of the ring: its copies have landed

  const int H = p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = p.n_heads / p.n_kv, nq = p.n_heads * kD, lanes = p.n_kv * kD;
  const int Kq = p.nbq * 2 * p.half_q, Ko = p.nbo * 2 * p.half_o, Kin = p.nb_in * 2 * p.half_in;
  const int pos = min(max(*p.pos, 0), p.A);          // keys [0, pos) are live
  const int n_chunks = max(cdiv(pos, kChunk), 1);    // chunk 0 always runs: it holds the self term
  const float q_scale = 1.f / sqrtf((float)kD);
  const Layout t = layout(p);
  const unsigned G = gridDim.x;
  unsigned barriers = 0;

  // the first layer's stages go out before anything else
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(mbar + s);
    mbar_fence_init();
    for (int s = 0; s < kStages; ++s) issue_stage(p, t, ring, 0, s, pos, n_chunks, mbar + s);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < H; k += kResThreads) xres[k] = __bfloat162float(p.x[k]);
  for (int k = threadIdx.x; k < kD; k += kResThreads) rope[k] = k < kD / 2 ? p.cos[k] : p.sin[k - kD / 2];

  for (int l = 0; l < p.L; ++l) {
    // ---- A: residual (past layer 0), input norm; qkv units -> f32 partials per split of the input
    if (l > 0) {
      float d[kPerThread];
      sum_splits(p.part_d, p.kd, H, d);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int k = threadIdx.x + i * kResThreads;
        if (k < H) xres[k] = __bfloat162float(__float2bfloat16(x2s[k] + d[i]));
      }
    }
    mbar_wait(mbar + 0, l & 1);
    __syncthreads();
    {
      const uint8_t* st = ring + t.off[0];
      rmsnorm_bf16(xres, reinterpret_cast<const float*>(st), H, Kq, p.eps, xs, sm);
      const int span = t.u[0].nb * 2 * p.half_q;
      run_units(st + H * 4, t.u[0], t.n[0], [&](int k) { return xs + (t.ids[0][k] / t.tiles[0]) * span; }, red,
                [&](int k, int j, float s, float) {
                  const int id = t.ids[0][k];
                  p.part_q[(size_t)(id / t.tiles[0]) * p.nqkv + (id % t.tiles[0]) * kUnitCols + j] = s;
                });
    }
    grid_arrive(p.bar);
    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, 0, pos, n_chunks, mbar + 0);
    grid_wait(p.bar, ++barriers * G);

    // ---- B: attention items (KV head, chunk of keys); the last item of a head merges
    mbar_wait(mbar + 1, l & 1);
    __syncthreads();
    for (int k = 0; k < p.kv_items; ++k) {
      const int item = blockIdx.x + k * G;
      if (item >= p.n_kv * n_chunks) break;
      const int g = item % p.n_kv, c = item / p.n_kv, key0 = c * kChunk, n = min(kChunk, pos - key0);
      const uint8_t* it = ring + t.off[1] + (size_t)k * kItemBytes;
      const float* bias = reinterpret_cast<const float*>(it + kChunk * 2 * kD * 2);
      // the group's q heads, k_new and v_new: qkv partials summed in order (every load out at once), bias;
      // then rope (q also scaled by 1/sqrt(d)) in place
      auto column = [&](int idx) {
        if (idx < rep * kD) return g * rep * kD + idx;
        if (idx < (rep + 1) * kD) return nq + g * kD + idx - rep * kD;
        return nq + lanes + g * kD + idx - (rep + 1) * kD;
      };
      float raw[2];
      {
        float buf[2][kMaxSplits];
#pragma unroll
        for (int s = 0; s < kMaxSplits; ++s)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = threadIdx.x + i * kResThreads;
            buf[i][s] = s < p.kq && idx < (rep + 2) * kD ? ld_cg(p.part_q + (size_t)s * p.nqkv + column(idx)) : 0.f;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = threadIdx.x + i * kResThreads;
          float a = 0.f;
#pragma unroll
          for (int s = 0; s < kMaxSplits; ++s) a += buf[i][s];
          raw[i] = idx < (rep + 2) * kD ? a + bias[idx] : 0.f;
        }
      }
      float* qraw = red;  // the unit sums of phase A are done with: red holds the raw values a moment
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (threadIdx.x + i * kResThreads < (rep + 2) * kD) qraw[threadIdx.x + i * kResThreads] = raw[i];
      __syncthreads();
      for (int idx = threadIdx.x; idx < (rep + 2) * kD; idx += kResThreads) {
        const int i = idx % kD, d2 = kD / 2;
        const float v = qraw[idx];
        float out = v;
        if (idx < (rep + 1) * kD) {  // q or k: rotate the two halves of the head
          const float w = qraw[i < d2 ? idx + d2 : idx - d2];
          const int f = i % d2;
          out = i < d2 ? v * rope[f] - w * rope[d2 + f] : v * rope[f] + w * rope[d2 + f];
          if (idx < rep * kD) out = out * q_scale;
        }
        qkv_sm[idx < rep * kD ? idx : kMaxRep * kD + idx - rep * kD] = out;
      }
      __syncthreads();
      const float* kg = qkv_sm + kMaxRep * kD;
      const float* vg = kg + kD;
      if (c == 0)
        for (int i = threadIdx.x; i < kD; i += kResThreads) {
          p.k_new[(size_t)l * lanes + g * kD + i] = __float2bfloat16(kg[i]);
          p.v_new[(size_t)l * lanes + g * kD + i] = __float2bfloat16(vg[i]);
        }
      // one warp per query head: lane j keeps key j's score; the self term rides along in chunk 0
      if (warp < rep) {
        const __nv_bfloat16* kr = reinterpret_cast<const __nv_bfloat16*>(it);
        const __nv_bfloat16* vr = kr + kChunk * kD;
        const float q0 = qkv_sm[warp * kD + 2 * lane], q1 = qkv_sm[warp * kD + 2 * lane + 1];
        float s_mine = kNegInf;
        for (int j = 0; j < n; ++j) {
          const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + j * kD + 2 * lane));
          const float s = warp_sum(q0 * kf.x + q1 * kf.y);
          if (lane == j) s_mine = s;
        }
        const float s_self = c == 0 ? warp_sum(q0 * kg[2 * lane] + q1 * kg[2 * lane + 1]) : kNegInf;
        const float m = fmaxf(warp_max(s_mine), s_self);
        const float p_mine = lane < n ? expf(s_mine - m) : 0.f;
        const float p_self = c == 0 ? expf(s_self - m) : 0.f;
        const float lsum = warp_sum(p_mine) + p_self;
        float a0 = p_self * vg[2 * lane], a1 = p_self * vg[2 * lane + 1];
        for (int j = 0; j < n; ++j) {
          const float pj = __shfl_sync(kFull, p_mine, j);
          const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr + j * kD + 2 * lane));
          a0 += pj * vf.x;
          a1 += pj * vf.y;
        }
        const size_t o = ((size_t)g * kMaxChunks + c) * kMaxRep + warp;
        reinterpret_cast<float2*>(p.part_acc + o * kD)[lane] = make_float2(a0, a1);
        if (lane == 0) {
          p.part_m[o] = m;
          p.part_l[o] = lsum;
        }
      }
      __syncthreads();
    }
    grid_arrive(p.bar);
    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, 1, pos, n_chunks, mbar + 1);
    grid_wait(p.bar, ++barriers * G);

    // ---- C: each o_proj unit's input, the attention rows of the heads it covers, merged from their chunk
    // partials into xs; then the units -> f32 partials per split of the input
    mbar_wait(mbar + 2, l & 1);
    {
      const int span = t.u[1].nb * 2 * p.half_o;  // whole heads, at most kResWarps / 2 of them
      for (int k = 0; k < t.n[1]; ++k) {
        const int split = t.ids[1][k] / t.tiles[1];
        bool seen = false;
        for (int k2 = 0; k2 < k; ++k2) seen |= t.ids[1][k2] / t.tiles[1] == split;
        if (!seen) merge_heads(p, split * span / kD, span / kD, n_chunks, xs + split * span, red, &wgt[0][0]);
      }
      run_units(ring + t.off[2], t.u[1], t.n[1], [&](int k) { return xs + (t.ids[1][k] / t.tiles[1]) * span; }, red,
                [&](int k, int j, float s, float) {
                  const int id = t.ids[1][k];
                  p.part_o[(size_t)(id / t.tiles[1]) * H + (id % t.tiles[1]) * kUnitCols + j] = s;
                });
    }
    grid_arrive(p.bar);
    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, 2, pos, n_chunks, mbar + 2);
    grid_wait(p.bar, ++barriers * G);

    // ---- D: x2 and the post-attention norm (every block); gate|up units -> act
    {
      float o[kPerThread];
      sum_splits(p.part_o, p.ko, H, o);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int k = threadIdx.x + i * kResThreads;
        if (k < H) x2s[k] = xres[k] + o[i];
      }
    }
    mbar_wait(mbar + 3, l & 1);
    __syncthreads();
    {
      const uint8_t* st = ring + t.off[3];
      rmsnorm_bf16(x2s, reinterpret_cast<const float*>(st), H, Kin, p.eps, xs, sm);
      run_units(st + H * 4, t.u[2], t.n[2], [&](int) { return xs; }, red, [&](int k, int j, float gt, float u) {
        p.act[t.ids[2][k] * kUnitCols + j] = __float2bfloat16(gt / (1.f + expf(-gt)) * u);
      });
    }
    grid_arrive(p.bar);
    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, 3, pos, n_chunks, mbar + 3);
    grid_wait(p.bar, ++barriers * G);

    // ---- E: down units -> f32 partials per split of the intermediate input
    mbar_wait(mbar + 4, l & 1);
    __syncthreads();
    if (t.n[3] > 0) {
      stage_bf16(xs, p.act, p.I, p.I);
      const int span = t.u[3].nb * 2 * p.half_d;
      run_units(ring + t.off[4], t.u[3], t.n[3], [&](int k) { return xs + (t.ids[3][k] / t.tiles[3]) * span; }, red,
                [&](int k, int j, float s, float) {
                  const int id = t.ids[3][k];
                  p.part_d[(size_t)(id / t.tiles[3]) * H + (id % t.tiles[3]) * kUnitCols + j] = s;
                });
    }
    grid_arrive(p.bar);
    if (threadIdx.x == 0) issue_stage(p, t, ring, l + 1, 4, pos, n_chunks, mbar + 4);
    grid_wait(p.bar, ++barriers * G);
  }
  if (blockIdx.x == 0) {
    float d[kPerThread];
    sum_splits(p.part_d, p.kd, H, d);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int k = threadIdx.x + i * kResThreads;
      if (k < H) p.x_out[k] = __float2bfloat16(x2s[k] + d[i]);
    }
  }
  grid_exit(p.bar);
}

}  // namespace

extern "C" {

// Returns the launch's error code, or cudaErrorInvalidValue for a shape the
// kernel does not take (the Python wrapper checks first). plan, grid, the
// splits kq, ko, kd, maxu, kv_items, parts_*, slot_bytes and xs_bytes come
// from ops/int4_block.py:decode_layers_plan.
int cvt_int4_decode_layers(const void* x, const float* cos, const float* sin, const int* pos, const void* ka,
                           const void* va, const float* nw1, const float* nw2, const void* qkv_p, const float* qkv_s,
                           const float* qkv_b, const void* o_p, const float* o_s, const void* gu_p,
                           const float* gu_s, const void* d_p, const float* d_s, void* x_out, void* k_new,
                           void* v_new, float* work, void* counters, const int* plan, int L, int A, int H,
                           int n_heads, int n_kv, int d, int nbq, int half_q, int nqkv, int nbo, int half_o,
                           int nb_in, int half_in, int I, int nd, int half_d, int kq, int ko, int kd, int maxu,
                           int kv_items, int parts_q, int parts_o, int parts_g, int parts_d, int slot_bytes,
                           int xs_bytes, int grid, float eps, void* stream) {
  const int Kq = nbq * 2 * half_q, Ko = nbo * 2 * half_o, Kin = nb_in * 2 * half_in;
  const int rep = n_heads / n_kv;
  const bool splits_ok = kq >= 1 && ko >= 1 && kd >= 1 && kq <= kMaxSplits && ko <= kMaxSplits &&
                         kd <= kMaxSplits && nbq % kq == 0 && nbo % ko == 0 && nd % kd == 0;
  const bool halves_ok = half_q % (8 * parts_q) == 0 && half_o % (8 * parts_o) == 0 &&
                         half_in % (8 * parts_g) == 0 && half_d % (8 * parts_d) == 0 && half_q <= 256 &&
                         half_o <= 256 && half_in <= 256 && half_d <= 256;
  const bool items_ok = nbq / kq * parts_q <= kMaxItems && nbo / ko * parts_o <= kMaxItems &&
                        2 * nb_in * parts_g <= kMaxItems && nd / kd * parts_d <= kMaxItems;
  const bool aligned = aligned16(qkv_p) && aligned16(qkv_s) && aligned16(qkv_b) && aligned16(o_p) &&
                       aligned16(o_s) && aligned16(gu_p) && aligned16(gu_s) && aligned16(d_p) && aligned16(d_s) &&
                       aligned16(nw1) && aligned16(nw2) && aligned16(ka) && aligned16(va) && aligned16(work);
  if (!splits_ok || !halves_ok || !items_ok || !aligned || L < 1 || A < 1 || A > kMaxChunks * kChunk ||
      d != kD || n_kv < 1 || n_heads % n_kv != 0 || rep > kMaxRep ||
      (nbo / ko * 2 * half_o) % kD != 0 || nbo / ko * 2 * half_o / kD > kResWarps / 2 ||
      nqkv != (n_heads + 2 * n_kv) * kD || H % kUnitCols != 0 || nqkv % kUnitCols != 0 || I % kUnitCols != 0 ||
      H > kResMaxHid || Kq < H || Ko < n_heads * kD || Kin < H || nd * 2 * half_d != I || xs_bytes < 2 * I ||
      xs_bytes < 2 * Kq || xs_bytes < 2 * Ko || xs_bytes < 2 * Kin || xs_bytes % 128 || slot_bytes % 16 ||
      grid < 1 || kv_items * grid < n_kv * ((A + kChunk - 1) / kChunk))
    return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(int4_decode_layers_kernel);
  const int dyn = xs_bytes + slot_bytes;
  int sms = 0, per_sm = 0;
  const int rc = resident_blocks(kernel, dyn, &sms, &per_sm);
  if (rc != 0) return rc;
  if (per_sm < 1 || grid > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.cos = cos;
  p.sin = sin;
  p.pos = pos;
  p.ka = static_cast<const __nv_bfloat16*>(ka);
  p.va = static_cast<const __nv_bfloat16*>(va);
  p.nw1 = nw1;
  p.nw2 = nw2;
  p.qkv_b = qkv_b;
  int rc_map = weight_maps(&p.mq, qkv_p, qkv_s, nqkv, (uint64_t)L * nbq * half_q, half_q, (uint64_t)L * nbq, nbq / kq);
  if (rc_map == 0)
    rc_map = weight_maps(&p.mo, o_p, o_s, H, (uint64_t)L * nbo * half_o, half_o, (uint64_t)L * nbo, nbo / ko);
  if (rc_map == 0)
    rc_map = weight_maps(&p.mg, gu_p, gu_s, I, (uint64_t)L * 2 * nb_in * half_in, half_in, (uint64_t)L * 2 * nb_in,
                         nb_in);
  if (rc_map == 0)
    rc_map = weight_maps(&p.md, d_p, d_s, H, (uint64_t)L * nd * half_d, half_d, (uint64_t)L * nd, nd / kd);
  const int lanes = n_kv * kD;
  if (rc_map == 0)
    rc_map = tensor_map(&p.mk, ka, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lanes, (uint64_t)L * A, kD, kChunk);
  if (rc_map == 0)
    rc_map = tensor_map(&p.mv, va, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lanes, (uint64_t)L * A, kD, kChunk);
  if (rc_map != 0) return rc_map;
  p.x_out = static_cast<__nv_bfloat16*>(x_out);
  p.k_new = static_cast<__nv_bfloat16*>(k_new);
  p.v_new = static_cast<__nv_bfloat16*>(v_new);
  // one f32 workspace, every piece a multiple of 4 floats (16-byte aligned): qkv partials, m, l, acc, o
  // partials, down partials, then act in bf16
  const int parts = n_kv * kMaxChunks * kMaxRep;
  float* w = work;
  p.part_q = w;
  w += (size_t)kq * nqkv;
  p.part_m = w;
  w += parts;
  p.part_l = w;
  w += parts;
  p.part_acc = w;
  w += (size_t)parts * kD;
  p.part_o = w;
  w += (size_t)ko * H;
  p.part_d = w;
  w += (size_t)kd * H;
  p.act = reinterpret_cast<__nv_bfloat16*>(w);
  p.bar = static_cast<unsigned*>(counters);
  p.plan = plan;
  p.L = L;
  p.A = A;
  p.H = H;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.nbq = nbq;
  p.half_q = half_q;
  p.nqkv = nqkv;
  p.nbo = nbo;
  p.half_o = half_o;
  p.nb_in = nb_in;
  p.half_in = half_in;
  p.I = I;
  p.nd = nd;
  p.half_d = half_d;
  p.kq = kq;
  p.ko = ko;
  p.kd = kd;
  p.maxu = maxu;
  p.kv_items = kv_items;
  p.parts_q = parts_q;
  p.parts_o = parts_o;
  p.parts_g = parts_g;
  p.parts_d = parts_d;
  p.slot_bytes = slot_bytes;
  p.xs_bytes = xs_bytes;
  p.eps = eps;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kResThreads), args, dyn,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
