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
// Design: the TPU runs one sequential grid over (layer, MLP chunk) and carries
//   the residual in VMEM from step to step. Blocks on Hopper cannot wait for
//   each other inside a plain launch, so this is ONE cooperative launch per
//   decode step, grid no larger than the co-resident blocks, with a loop over
//   the L layers inside and cooperative_groups grid syncs between five
//   phases per layer (5 L barriers per step):
//   A. every block computes the RMSNorm of the residual (kept in its shared
//      memory, the same bits in every block) and stages hnorm as bf16;
//      qkv work items (64-column tile, scale block) write f32 partials.
//   B. attention items (KV head, chunk of kChunk arena keys): each sums the
//      qkv partials of its head group in a fixed order, adds the bias,
//      applies rope, and runs an online softmax over its keys, one key per
//      warp at a time (K1's scheme); the warps merge through shared memory
//      into one (m, l, acc) partial per item. Chunk 0 of each KV head also
//      merges the f32 self term and writes k_new, v_new.
//   C. o_proj items (64-column tile, scale block) merge the partials of the
//      heads in their 256 inputs by log-sum-exp, in a fixed order, round
//      attn_row to bf16 and write f32 o partials.
//   D. every block sums the o partials into x2 (kept in shared memory), norms
//      and stages h2; gate|up items (64-column tile, both planes) write act.
//   E. down items (64-column tile, 512-row scale block) write f32 partials.
//   Then every block sums the down partials in order, adds x2 and rounds the
//   new residual to bf16; past the last layer block 0 writes x_out.
//   No float atomics: every cross-block sum goes through f32 partials summed
//   in a fixed order after a barrier, so runs repeat bit for bit. A simple
//   kernel that is right: CUDA-core dots, no wgmma or TMA; the barriers and
//   the 64-column items leave most of the card's bandwidth unused (PERF.md).
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_gemv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 64;          // head_dim the kernel takes
constexpr int kDPL = kD / 32;   // head dims held by each lane
constexpr int kMaxRep = 8;      // query heads per KV head
constexpr int kMaxHid = 2048;   // hidden size and every staged activation length
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
  const int8_t* qkv_p;                     // [L, nbq, half_q, nqkv]
  const float* qkv_s;                      // [L, nbq, nqkv]
  const float* qkv_b;                      // [L, nqkv]
  const int8_t* o_p;                       // [L, nbo, half_o, H]
  const float* o_s;                        // [L, nbo, H]
  const int8_t* gu_p;                      // [L, 2, nb_in, half_in, I]
  const float* gu_s;                       // [L, 2, nb_in, I]
  const int8_t* d_p;                       // [L, nd, half_d, H]
  const float* d_s;                        // [L, nd, H]
  __nv_bfloat16* x_out;                    // [H]
  __nv_bfloat16* k_new;                    // [L, Hkv*d]
  __nv_bfloat16* v_new;                    // [L, Hkv*d]
  // scratch written and read inside the launch: plain loads, never the
  // read-only cache
  float* part_q;                           // [nbq, nqkv]
  float* part_m;                           // [Hkv, max_chunks, kMaxRep]
  float* part_l;                           // [Hkv, max_chunks, kMaxRep]
  float* part_acc;                         // [Hkv, max_chunks, kMaxRep, d]
  float* part_o;                           // [nbo, H]
  __nv_bfloat16* act;                      // [I]
  float* part_d;                           // [nd, H]
  int L, A, H, n_heads, n_kv, nbq, half_q, nqkv, nbo, half_o, nb_in, half_in, I, nd, half_d;
  int chunk, max_chunks;
  float eps;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// xs[k] = bf16(x[k] * rsqrt(mean(x^2) + eps) * w[k]) for k < H, zero up to n.
__device__ void rmsnorm_to_bf16(const float* x, const float* w, int H, int n, float eps, __nv_bfloat16* xs,
                                float* sm_sum) {
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += kThreads) ss += x[k] * x[k];
  const float inv = rsqrtf(block_sum(ss, sm_sum) / H + eps);
  for (int k = threadIdx.x; k < n; k += kThreads) xs[k] = __float2bfloat16(k < H ? x[k] * inv * w[k] : 0.f);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) int4_decode_layers_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __nv_bfloat16 xs[kMaxHid];  // staged bf16 activations of the current item
  __shared__ float xres[kMaxHid];        // residual x (f32, bf16 values at layer boundaries)
  __shared__ float x2s[kMaxHid];         // x2 = x + o
  __shared__ float red[kWarps * kTileCols];
  __shared__ float res_g[kTileCols];
  __shared__ float res_u[kTileCols];
  __shared__ float sm_sum[kWarps];
  __shared__ float qkv_sm[(kMaxRep + 2) * kD];  // q of the item's heads, then k_new, v_new (f32)
  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][kD];

  const int H = p.H, I = p.I;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = p.n_heads / p.n_kv;
  const int nq = p.n_heads * kD, lanes = p.n_kv * kD;
  const int tiles_h = cdiv(H, kTileCols), tiles_q = cdiv(p.nqkv, kTileCols), tiles_i = cdiv(I, kTileCols);
  const int Kq = p.nbq * 2 * p.half_q, Kin = p.nb_in * 2 * p.half_in;
  const int go = 2 * p.half_o, gd = 2 * p.half_d;
  const int pos = min(max(*p.pos, 0), p.A);  // keys [0, pos) are live
  const int n_chunks = max(cdiv(pos, p.chunk), 1);  // chunk 0 always runs: it holds the self term
  const float q_scale = 1.f / sqrtf((float)kD);

  for (int k = threadIdx.x; k < H; k += kThreads) xres[k] = __bfloat162float(p.x[k]);
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    // ---- A: input norm (every block); qkv partials per (tile, scale block)
    rmsnorm_to_bf16(xres, p.nw1 + (size_t)l * H, H, Kq, p.eps, xs, sm_sum);
    {
      const int8_t* wp = p.qkv_p + (size_t)l * p.nbq * p.half_q * p.nqkv;
      const float* ws = p.qkv_s + (size_t)l * p.nbq * p.nqkv;
      for (int item = blockIdx.x; item < tiles_q * p.nbq; item += gridDim.x) {
        const int tile = item % tiles_q, b = item / tiles_q;
        gemv_tile<1>(wp, ws, p.half_q, p.nqkv, b, b + 1, xs + (size_t)b * 2 * p.half_q, 0, 0, 1, tile * kTileCols,
                     red, res_g);
        for (int idx = threadIdx.x; idx < kTileCols; idx += kThreads) {
          const int c = tile * kTileCols + idx;
          if (c < p.nqkv) p.part_q[(size_t)b * p.nqkv + c] = res_g[idx];
        }
      }
    }
    grid.sync();

    // ---- B: attention partials per (KV head, key chunk)
    {
      const size_t layer_kv = (size_t)l * p.A * lanes;
      const float* bias = p.qkv_b + (size_t)l * p.nqkv;
      for (int item = blockIdx.x; item < p.n_kv * n_chunks; item += gridDim.x) {
        const int g = item % p.n_kv, c = item / p.n_kv;
        // the group's q heads, k_new and v_new: qkv partials summed in
        // order, bias, rope (q also scaled by 1/sqrt(d)); column of value idx:
        auto column = [&](int idx) {
          if (idx < rep * kD) return g * rep * kD + idx;
          if (idx < (rep + 1) * kD) return nq + g * kD + idx - rep * kD;
          return nq + lanes + g * kD + idx - (rep + 1) * kD;
        };
        auto qkv_value = [&](int col) {
          float s = 0.f;
          for (int b = 0; b < p.nbq; ++b) s += p.part_q[(size_t)b * p.nqkv + col];
          return s + bias[col];
        };
        for (int idx = threadIdx.x; idx < (rep + 2) * kD; idx += kThreads) {
          const int col = column(idx), i = idx % kD, d2 = kD / 2;
          const float v = qkv_value(col);
          float out = v;
          if (idx < (rep + 1) * kD) {  // q or k: rotate the two halves of the head
            const float w = qkv_value(i < d2 ? col + d2 : col - d2);
            const int f = i % d2;
            out = i < d2 ? v * p.cos[f] - w * p.sin[f] : v * p.cos[f] + w * p.sin[f];
            if (idx < rep * kD) out = out * q_scale;
          }
          // qkv_sm keeps the group's q heads at rows 0..rep-1, then k, v
          qkv_sm[idx < rep * kD ? idx : kMaxRep * kD + idx - rep * kD] = out;
        }
        __syncthreads();
        const float* kg = qkv_sm + kMaxRep * kD;
        const float* vg = kg + kD;
        if (c == 0) {
          for (int i = threadIdx.x; i < kD; i += kThreads) {
            p.k_new[(size_t)l * lanes + g * kD + i] = __float2bfloat16(kg[i]);
            p.v_new[(size_t)l * lanes + g * kD + i] = __float2bfloat16(vg[i]);
          }
        }

        float qr[kMaxRep][kDPL], m[kMaxRep], lsum[kMaxRep], acc[kMaxRep][kDPL];
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          m[r] = kNegInf;
          lsum[r] = 0.f;
#pragma unroll
          for (int i = 0; i < kDPL; ++i) {
            acc[r][i] = 0.f;
            qr[r][i] = r < rep ? qkv_sm[r * kD + lane * kDPL + i] : 0.f;
          }
        }
        const int key0 = c * p.chunk, key1 = min(key0 + p.chunk, pos);
        const __nv_bfloat16* kb = p.ka + layer_kv + g * kD + lane * kDPL;
        const __nv_bfloat16* vb = p.va + layer_kv + g * kD + lane * kDPL;
        for (int j = key0 + warp; j < key1; j += kWarps) {
          float kf[kDPL], vf[kDPL];
#pragma unroll
          for (int i = 0; i < kDPL; ++i) {
            kf[i] = __bfloat162float(kb[(size_t)j * lanes + i]);
            vf[i] = __bfloat162float(vb[(size_t)j * lanes + i]);
          }
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) {
              float s = 0.f;
#pragma unroll
              for (int i = 0; i < kDPL; ++i) s += qr[r][i] * kf[i];
              s = warp_sum(s);
              const float m_new = fmaxf(m[r], s);
              const float corr = expf(m[r] - m_new);
              const float e = expf(s - m_new);
              lsum[r] = lsum[r] * corr + e;
#pragma unroll
              for (int i = 0; i < kDPL; ++i) acc[r][i] = acc[r][i] * corr + e * vf[i];
              m[r] = m_new;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            if (lane == 0) {
              sm_m[warp][r] = m[r];
              sm_l[warp][r] = lsum[r];
            }
#pragma unroll
            for (int i = 0; i < kDPL; ++i) sm_acc[warp][r][lane * kDPL + i] = acc[r][i];
          }
        }
        __syncthreads();
        // merge the warps (and, in chunk 0, the f32 self term) in a fixed order
        for (int idx = threadIdx.x; idx < rep * kD; idx += kThreads) {
          const int r = idx / kD, dd = idx % kD;
          float M = kNegInf, s_self = 0.f;
          for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
          if (c == 0) {
            for (int i = 0; i < kD; ++i) s_self += qkv_sm[r * kD + i] * kg[i];
            M = fmaxf(M, s_self);
          }
          float Ls = 0.f, As = 0.f;
          for (int w = 0; w < kWarps; ++w) {
            const float f = expf(sm_m[w][r] - M);
            Ls += sm_l[w][r] * f;
            As += sm_acc[w][r][dd] * f;
          }
          if (c == 0) {
            const float e = expf(s_self - M);
            Ls += e;
            As += e * vg[dd];
          }
          const size_t o = ((size_t)g * p.max_chunks + c) * kMaxRep + r;
          p.part_acc[o * kD + dd] = As;
          if (dd == 0) {
            p.part_m[o] = M;
            p.part_l[o] = Ls;
          }
        }
        __syncthreads();
      }
    }
    grid.sync();

    // ---- C: merge the heads' partials, attn_row in bf16; o_proj partials
    {
      const int8_t* wp = p.o_p + (size_t)l * p.nbo * p.half_o * H;
      const float* ws = p.o_s + (size_t)l * p.nbo * H;
      for (int item = blockIdx.x; item < tiles_h * p.nbo; item += gridDim.x) {
        const int tile = item % tiles_h, b = item / tiles_h;
        for (int idx = threadIdx.x; idx < go; idx += kThreads) {
          const int k = b * go + idx;
          float v = 0.f;
          if (k < nq) {
            const int h = k / kD, dd = k % kD, g = h / rep, r = h % rep;
            const size_t base = (size_t)g * p.max_chunks * kMaxRep + r;
            float M = kNegInf;
            for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, p.part_m[base + (size_t)c * kMaxRep]);
            float Ls = 0.f, As = 0.f;
            for (int c = 0; c < n_chunks; ++c) {
              const size_t o = base + (size_t)c * kMaxRep;
              const float f = expf(p.part_m[o] - M);
              Ls += p.part_l[o] * f;
              As += p.part_acc[o * kD + dd] * f;
            }
            v = As / Ls;
          }
          xs[idx] = __float2bfloat16(v);
        }
        __syncthreads();
        gemv_tile<1>(wp, ws, p.half_o, H, b, b + 1, xs, go, 0, 1, tile * kTileCols, red, res_g);
        for (int idx = threadIdx.x; idx < kTileCols; idx += kThreads) {
          const int c = tile * kTileCols + idx;
          if (c < H) p.part_o[(size_t)b * H + c] = res_g[idx];
        }
        __syncthreads();
      }
    }
    grid.sync();

    // ---- D: x2 and the post-attention norm (every block); gate|up -> act
    {
      for (int k = threadIdx.x; k < H; k += kThreads) {
        float o = 0.f;
        for (int b = 0; b < p.nbo; ++b) o += p.part_o[(size_t)b * H + k];
        x2s[k] = xres[k] + o;
      }
      __syncthreads();
      rmsnorm_to_bf16(x2s, p.nw2 + (size_t)l * H, H, Kin, p.eps, xs, sm_sum);
      const size_t plane = (size_t)p.nb_in * p.half_in * I;
      const int8_t* wp = p.gu_p + (size_t)l * 2 * plane;
      const float* ws = p.gu_s + (size_t)l * 2 * p.nb_in * I;
      for (int tile = blockIdx.x; tile < tiles_i; tile += gridDim.x) {
        gemv_tile<1>(wp, ws, p.half_in, I, 0, p.nb_in, xs, Kin, 0, 1, tile * kTileCols, red, res_g);
        gemv_tile<1>(wp + plane, ws + (size_t)p.nb_in * I, p.half_in, I, 0, p.nb_in, xs, Kin, 0, 1,
                     tile * kTileCols, red, res_u);
        for (int idx = threadIdx.x; idx < kTileCols; idx += kThreads) {
          const int c = tile * kTileCols + idx;
          if (c < I) {
            const float gt = res_g[idx], u = res_u[idx];
            p.act[c] = __float2bfloat16(gt / (1.f + expf(-gt)) * u);
          }
        }
      }
    }
    grid.sync();

    // ---- E: down partials per (tile, 512-row scale block)
    {
      const int8_t* wp = p.d_p + (size_t)l * p.nd * p.half_d * H;
      const float* ws = p.d_s + (size_t)l * p.nd * H;
      for (int item = blockIdx.x; item < tiles_h * p.nd; item += gridDim.x) {
        const int tile = item % tiles_h, c = item / tiles_h;
        for (int idx = threadIdx.x; idx < gd; idx += kThreads) xs[idx] = p.act[(size_t)c * gd + idx];
        __syncthreads();
        gemv_tile<1>(wp, ws, p.half_d, H, c, c + 1, xs, gd, 0, 1, tile * kTileCols, red, res_g);
        for (int idx = threadIdx.x; idx < kTileCols; idx += kThreads) {
          const int col = tile * kTileCols + idx;
          if (col < H) p.part_d[(size_t)c * H + col] = res_g[idx];
        }
        __syncthreads();
      }
    }
    grid.sync();

    // layer boundary: x = bf16(x2 + sum of the down partials, in order)
    for (int k = threadIdx.x; k < H; k += kThreads) {
      float dsum = 0.f;
      for (int c = 0; c < p.nd; ++c) dsum += p.part_d[(size_t)c * H + k];
      xres[k] = __bfloat162float(__float2bfloat16(x2s[k] + dsum));
    }
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < H; k += kThreads) p.x_out[k] = __float2bfloat16(xres[k]);
}

}  // namespace

extern "C" {

// Returns the launch's error code, or cudaErrorInvalidValue for a shape the
// kernel does not take (the Python wrapper checks first).
int cvt_int4_decode_layers(const void* x, const float* cos, const float* sin, const int* pos, const void* ka,
                           const void* va, const float* nw1, const float* nw2, const void* qkv_p, const float* qkv_s,
                           const float* qkv_b, const void* o_p, const float* o_s, const void* gu_p,
                           const float* gu_s, const void* d_p, const float* d_s, void* x_out, void* k_new,
                           void* v_new, float* part_q, float* part_m, float* part_l, float* part_acc, float* part_o,
                           void* act, float* part_d, int L, int A, int H, int n_heads, int n_kv, int d, int nbq,
                           int half_q, int nqkv, int nbo, int half_o, int nb_in, int half_in, int I, int nd,
                           int half_d, int chunk, float eps, void* stream) {
  const int Kq = nbq * 2 * half_q, Kin = nb_in * 2 * half_in;
  if (L < 1 || A < 1 || d != kD || n_kv < 1 || n_heads % n_kv != 0 || n_heads / n_kv > kMaxRep ||
      nqkv != (n_heads + 2 * n_kv) * kD || H % kColsPerThread != 0 || nqkv % kColsPerThread != 0 ||
      I % kColsPerThread != 0 || H > kMaxHid || Kq < H || Kq > kMaxHid || Kin < H || Kin > kMaxHid ||
      nbo * 2 * half_o < n_heads * kD || 2 * half_o > kMaxHid || nd * 2 * half_d != I || 2 * half_d > kMaxHid ||
      chunk < 1 || !aligned16(qkv_p) || !aligned16(qkv_s) || !aligned16(o_p) || !aligned16(o_s) ||
      !aligned16(gu_p) || !aligned16(gu_s) || !aligned16(d_p) || !aligned16(d_s))
    return (int)cudaErrorInvalidValue;
  // co-resident blocks of this kernel on the device, queried once
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int4_decode_layers_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    max_blocks = sms * per_sm;
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.cos = cos;
  p.sin = sin;
  p.pos = pos;
  p.ka = static_cast<const __nv_bfloat16*>(ka);
  p.va = static_cast<const __nv_bfloat16*>(va);
  p.nw1 = nw1;
  p.nw2 = nw2;
  p.qkv_p = static_cast<const int8_t*>(qkv_p);
  p.qkv_s = qkv_s;
  p.qkv_b = qkv_b;
  p.o_p = static_cast<const int8_t*>(o_p);
  p.o_s = o_s;
  p.gu_p = static_cast<const int8_t*>(gu_p);
  p.gu_s = gu_s;
  p.d_p = static_cast<const int8_t*>(d_p);
  p.d_s = d_s;
  p.x_out = static_cast<__nv_bfloat16*>(x_out);
  p.k_new = static_cast<__nv_bfloat16*>(k_new);
  p.v_new = static_cast<__nv_bfloat16*>(v_new);
  p.part_q = part_q;
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.part_o = part_o;
  p.act = static_cast<__nv_bfloat16*>(act);
  p.part_d = part_d;
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
  p.chunk = chunk;
  p.max_chunks = (A + chunk - 1) / chunk;
  p.eps = eps;
  // enough blocks for the widest phase, at most the co-resident ones
  const int tiles_h = (H + kTileCols - 1) / kTileCols;
  int work = ((nqkv + kTileCols - 1) / kTileCols) * nbq;
  if (n_kv * p.max_chunks > work) work = n_kv * p.max_chunks;
  if (tiles_h * nbo > work) work = tiles_h * nbo;
  if ((I + kTileCols - 1) / kTileCols > work) work = (I + kTileCols - 1) / kTileCols;
  if (tiles_h * nd > work) work = tiles_h * nd;
  const int grid = work < max_blocks ? work : max_blocks;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(int4_decode_layers_kernel),
                                                    dim3(grid), dim3(kThreads), args, 0,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
