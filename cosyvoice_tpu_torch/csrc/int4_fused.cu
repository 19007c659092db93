// Hand-written Hopper (sm_90a) kernels for the int4 weight-only LM's decode steps and short extends.
//
// Built with the other csrc/*.cu files by cosyvoice_tpu_torch/ops/_build.py
// (plain C interface, loaded with ctypes). Every entry point launches on the
// stream it is given and returns the launch's error code; the Python
// wrappers raise if it is not 0.
//
// K4 has its own device code over the layout of int4_layout.cuh; K5 and
// K6 (at every B) read unit images resident in shared memory
// (int4_resident.cuh). Input rows past the activation's length are zero
// padding: the activation slice in shared memory is zero-filled there, so
// they add nothing.
//
// ---------------------------------------------------------------------------
// K4  int4_gemv_kernel  (int4 GEMV, <= 16 rows, one cluster launch)
//
// Replaces: cosyvoice_tpu/ops/int4_fused.py:int4_gemv (pallas_call at :339,
//   body _gemv_kernel :307).
// Computes: y[B, O] = x[B, n_in] @ dequant(packed, scale), B <= 16, rounded
//   once to bf16. Exact dequant arithmetic of int4_matmul_blocked: the
//   Pallas kernel's default "fold" scheme (_gemv_planes_fold) instead rounds
//   x_lo - x_hi/16 to bf16 and dots the raw byte; this kernel decodes both
//   nibbles and multiplies the unrounded activations, sums each scale
//   block's partial in f32 and multiplies it by the block's scale.
// Bound on the H100: bytes. The qkv projection of Qwen2-0.5B (n_in 896 ->
//   1024, O 1152) reads 4*128*1152 B of packed weights + 4*1152*4 B of
//   scales ~ 0.61 MB: ~0.18 us at 3.35 TB/s; ~2 flops per weight byte.
// Why the first design took ~10 us: one block per 64-column tile
//   (18 blocks on 132 SMs for qkv) staged all 1024 inputs with 2-byte loads,
//   then walked the scale blocks in a runtime loop whose scale load fed its
//   own FMAs, so a thread's loads went out in several dependent rounds;
//   past 4 rows each 4-row tile re-read the weights from L2.
// Design: a work item is (32-column tile, scale block): 36 tiles x 4 scale
//   blocks = 144 blocks for qkv, 28 x 4 for o_proj (ops/int4_fused.py:
//   gemv_plan). 32 columns took less time on the H100 than 16 (which would
//   fill every SM for o_proj) at 1 to 16 rows (scripts/decode_gemv_
//   ablation.py): each block pays a fixed reduction. Every thread issues all of
//   its weight loads (32 bytes) and its scale load before the first FMA, so
//   a block makes one DRAM round trip; its scale block's inputs come from
//   global memory straight into registers at <= 2 rows, else are staged
//   once in shared memory with 16-byte loads (256 inputs per row, not
//   1024). All rows go through the loaded weights in one pass (see the note
//   at int4_gemv_kernel). The nb scale blocks of a column tile form one
//   thread-block cluster (nb <= 8; past 8 each rank loops over nb / 8
//   blocks): each rank writes its f32 partial tile into its slot of rank 0's
//   shared memory, and after one cluster barrier rank 0 sums the slots in
//   rank order and rounds once to bf16. No second launch, no atomics: a call
//   repeats bit for bit.
//
// K6  int4_o_mlp_resident_kernel (B=1) / int4_o_mlp_rows_kernel (B = 2..16)  (fused int4 layer tail, one
//     cooperative launch)
//
// Replaces: cosyvoice_tpu/ops/int4_fused.py:int4_o_mlp (pallas_call at :519,
//   body _o_mlp_kernel :451).
// Computes: x2 = x + attn @ Wo (f32); h2 = bf16(rmsnorm(x2) * w);
//   act = bf16(silu(h2 @ Wg) * (h2 @ Wu)); out = bf16(x2 + act @ Wd).
//   attn is rounded to bf16 on entry, as the Pallas kernel does.
// Bound on the H100: bytes, whatever B is (every weight byte serves all
//   rows). Qwen2-0.5B: packed o 0.46 MB + gate|up 5.24 MB + down 2.29 MB +
//   ~0.21 MB of scales ~ 8.2 MB: ~2.45 us at 3.35 TB/s; at 16 rows the
//   ~0.44 GFLOP take ~0.45 us at the bf16 tensor-core rate.
// Design (both kernels): the tail's phases depend on each other globally
//   (the norm needs all of x2, gate/up all of h2, down all of act), so it is
//   one cooperative launch, one block per SM. Every unit of every phase
//   (int4_resident.cuh: 64 columns of one weight over a split of its input's
//   scale blocks) is fixed per block on the host (ops/int4_fused.py:
//   resident_plan, o_mlp_plan), and at entry every block has the TMA engine
//   copy all its units' weights (~60-110 KB) into shared memory, one stage
//   per phase on an mbarrier, so the weights stream in while the phases
//   before them run. Three phases, two grid barriers:
//   1. o_proj units (one scale block each) write f32 partials;
//   2. every block sums x2 = x + the o partials in split order, computes the
//      norm and stages h2; gate|up units (both planes, whole input) write act
//      in bf16;
//   3. down units (a split of the scale blocks) write f32 partials; the last
//      unit of each 64-column tile (a ticket counter, returned to 0) writes
//      out = bf16(x2 + the tile's partials in split order).
//   No float atomics, so runs repeat bit for bit. At B=1 a warp's items run
//   on the FMA pipes (int4_resident.cuh: unit_items). At B = 2..16 the units
//   are K5's: tensor-core products (mma_items below) with the weights as the
//   A operand and the rows, padded to 8 (two products past 8), as B, so each
//   weight is decoded once for all rows; phase 1 stages each o unit's split
//   of attn for all rows, phase 2 keeps x2 [B, H] in f32 in the items' sum
//   buffer until the gate|up units need it, and the last down unit of a
//   tile sums x2 again from the o partials, in the same order (the same
//   bits). The first multi-row design, which this replaced, had four phases and
//   three barriers, loaded each phase's weights only after the barrier
//   before it, summed per-scale-block o partials in every block and ran its
//   products as FMAs per 4-row tile: 26x its bound at B=4 on an H100.
//
// K5  int4_mlp_kernel  (fused int4 SwiGLU MLP, <= 16 rows, one cooperative launch)
//
// Replaces: cosyvoice_tpu/ops/int4_fused.py:int4_mlp (pallas_call at :427,
//   body _mlp_kernel :389, _mlp_cell :373).
// Computes: act = bf16(silu(x @ Wg) * (x @ Wu)); out = bf16(act @ Wd), for
//   B <= 16 rows of x (bf16), over the layouts of pack_gate_up_int4 and
//   pack_down_int4. It runs in the exact-shape extends of 2..16 rows of the
//   bi-streaming LM (models/qwen2.py:Qwen2Model.extend).
// Bound on the H100: bytes. At Qwen2-0.5B's width: packed gate|up 5.24 MB +
//   down 2.29 MB + scales 0.20 MB ~ 7.74 MB: ~2.3 us at 3.35 TB/s; at 16
//   rows its ~0.48 GFLOP take ~0.5 us at the bf16 tensor-core rate.
// Design: the TPU runs a sequential grid over 1024-column intermediate cells
//   and carries the [B, H] down sum in VMEM. Down needs all of act, so here it
//   is one cooperative launch, one block per SM, on K6's resident base
//   (int4_resident.cuh): every block's units (64 columns of gate|up over both
//   planes and the whole input; 64 columns of down over a split of its scale
//   blocks) are fixed on the host (ops/int4_fused.py:mlp_plan), and at entry
//   the TMA engine copies all their weights into shared memory, one stage per
//   phase, so the down weights land while gate|up runs. One grid barrier:
//   1. gate|up units write act in bf16;
//   2. down units stage their split of act, write f32 partials, and the last
//      unit of each 64-column tile (a ticket counter, returned to 0) writes
//      out = bf16(the tile's partials summed in split order).
//   Every weight is decoded once and serves all rows: tensor cores
//   (mma.sync.m16n8k16, bf16 x bf16 -> f32) with the weights as the 16-row A
//   operand (16 output columns) and x as B (8 rows; two products past 8
//   rows). A nibble goes into the mantissa of bf16 0x4300 (128 + nibble,
//   the high nibble's sign flipped to make it offset-binary) and one bf16x2
//   subtraction of 136 leaves q exactly, two per register, straight from the
//   JAX layout in shared memory: the low nibbles of packed rows k and k + 1
//   of a column make one register, their high nibbles another, so one load
//   of two rows feeds a 16-input k-step. Products of int4 values and bf16
//   activations are exact; each item (a part of one scale block's rows)
//   sums in f32 and is multiplied by its block's scales, and a unit's items
//   are added in a fixed order. No float atomics: runs repeat bit for bit.
//   Gate|up is not split over its input: a split's f32 partials would have
//   to be summed by every down unit that reads the same inputs (14 of them
//   per split at full width), B x 1024 x 8 values each.
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_layout.cuh"
#include "int4_resident.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 16;

// ---- K4: its own device code ----
//
// FMA, not mma.sync: at 16 rows a block's products are ~2 k FMAs per thread,
// well under a microsecond of the SM's f32 rate, and an mma B fragment would
// need the nibbles restaged in shared memory in the fragment's layout. The
// columns per thread narrow as the rows grow (16, 8, 4 at <= 4, 8, 16 rows),
// so the f32 sums of all rows stay in registers and one pass over the
// weights serves every row.

constexpr int kGemvCols = 32;               // columns of a tile
constexpr int kGemvXElems = 16 * 256;       // staged bf16 inputs: rows * 2 * half
constexpr int kGemvMaxCluster = 8;          // portable cluster size
constexpr int kGemvBytesPerThread = 32;     // weight bytes a thread loads per round

template <int BT>
struct GemvRows {
  static constexpr int kCols = BT <= 4 ? 16 : (BT == 8 ? 8 : 4);  // columns per thread
  static constexpr int kWords = kCols / 4;                        // 32-bit words per load
  static constexpr int kLoads = kGemvBytesPerThread / kCols;      // loads per round
  static constexpr int kGroups = kGemvCols / kCols;                // column groups of a tile
};

template <int W>
__device__ __forceinline__ void load_words(const int8_t* p, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else if constexpr (W == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x, w[1] = t.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

// Grid (cluster, tiles), cluster (cluster, 1, 1): the blocks of a cluster are
// the scale blocks of one column tile. Block rank c takes scale blocks c,
// c + cluster, ... and writes its f32 partial tile into rank 0's shared
// memory (distributed shared memory); rank 0 sums the tiles in rank order
// and rounds once to bf16.
template <int BT>
__global__ void __launch_bounds__(kThreads) int4_gemv_kernel(
    const __nv_bfloat16* __restrict__ x,  // [B, n_in]
    const int8_t* __restrict__ packed,    // [nb, half, O]
    const float* __restrict__ scale,      // [nb, O]
    __nv_bfloat16* __restrict__ y,        // [B, O]
    int B, int n_in, int nb, int half, int O, int x_vec) {
  using R = GemvRows<BT>;
  constexpr int CPT = R::kCols, G = R::kGroups, cols = kGemvCols;
  constexpr int slices = kThreads / G;  // row slices
  __shared__ __align__(16) __nv_bfloat16 xs[BT <= 2 ? 8 : kGemvXElems];
  __shared__ float red[kWarps * BT * cols];
  __shared__ float res[BT * cols];
  __shared__ float gather[kGemvMaxCluster * BT * cols];  // rank 0's: every rank's tile
  __shared__ float s_sc[cols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank()), csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = tid % G, slice = tid / G;
  const int col0 = blockIdx.y * cols, col = col0 + group * CPT;
  const bool live_col = col < O;  // O % 16 == 0: a group is wholly in or out
  const int K = 2 * half;

  for (int blk = rank; blk < nb; blk += csize) {
    // every weight load of the first round and the scale load go out first
    const int8_t* pb = packed + (size_t)blk * half * O + col;
    uint32_t w[R::kLoads][R::kWords];
#pragma unroll
    for (int l = 0; l < R::kLoads; ++l) {
      const int i = slice + l * slices;
      if (live_col && i < half) load_words<R::kWords>(pb + (size_t)i * O, w[l]);
    }
    float sc = 0.f;
    if (tid < cols && col0 + tid < O) sc = __ldg(scale + (size_t)blk * O + col0 + tid);

    // this scale block's inputs of every row (zero past n_in and past B):
    // at <= 2 rows each thread reads its own from global memory (L2), else
    // the block stages them in shared memory
    const size_t k0 = (size_t)blk * K;
    if constexpr (BT <= 2) {
    } else if (x_vec) {
      for (int idx = tid; idx < BT * K / 8; idx += kThreads) {
        const int r = idx / (K / 8), k = (idx % (K / 8)) * 8;
        uint4 t = make_uint4(0, 0, 0, 0);
        if (r < B && k0 + k < (size_t)n_in) t = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * n_in + k0 + k));
        *reinterpret_cast<uint4*>(xs + r * K + k) = t;
      }
    } else {
      for (int idx = tid; idx < BT * K; idx += kThreads) {
        const int r = idx / K, k = idx % K;
        xs[idx] = r < B && k0 + k < (size_t)n_in ? x[(size_t)r * n_in + k0 + k] : __float2bfloat16(0.f);
      }
    }
    if constexpr (BT > 2) __syncthreads();

    float part[BT][CPT];
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j) part[r][j] = 0.f;
    for (int base = slice; base < half; base += R::kLoads * slices) {
      if (base != slice) {  // later rounds (half > 128 at narrow tiles): load again
#pragma unroll
        for (int l = 0; l < R::kLoads; ++l) {
          const int i = base + l * slices;
          if (live_col && i < half) load_words<R::kWords>(pb + (size_t)i * O, w[l]);
        }
      }
#pragma unroll
      for (int l = 0; l < R::kLoads; ++l) {
        const int i = base + l * slices;
        if (live_col && i < half) {
          float xl[BT], xh[BT];
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            if constexpr (BT <= 2) {
              const __nv_bfloat16* xr = x + (size_t)r * n_in + k0;
              xl[r] = r < B && k0 + i < (size_t)n_in ? __bfloat162float(__ldg(xr + i)) : 0.f;
              xh[r] = r < B && k0 + half + i < (size_t)n_in ? __bfloat162float(__ldg(xr + half + i)) : 0.f;
            } else {
              xl[r] = __bfloat162float(xs[r * K + i]);
              xh[r] = __bfloat162float(xs[r * K + half + i]);
            }
          }
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            // byte j, sign-extended: the high nibble is then the signed q_hi,
            // the low nibble q_lo + 8
            const int byte = static_cast<int>(w[l][j / 4] << (24 - 8 * (j % 4))) >> 24;
            const float lo = static_cast<float>((byte & 15) - 8);
            const float hi = static_cast<float>(byte >> 4);
#pragma unroll
            for (int r = 0; r < BT; ++r) part[r][j] += xl[r] * lo + xh[r] * hi;
          }
        }
      }
    }

    // the row slices of a warp sit in the lane bits above the group's; each
    // step shuffles every sum at once, so the steps are the only chain
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) part[r][j] += __shfl_xor_sync(0xffffffffu, part[r][j], off);
    }
    if (lane < G) {
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) red[(warp * BT + r) * cols + group * CPT + j] = part[r][j];
    }
    if (tid < cols) s_sc[tid] = sc;
    __syncthreads();
    // the block's partial: the warps summed in order, times the block's
    // scale; after the rank's last scale block it goes straight into its
    // slot in rank 0's shared memory
    const bool last = blk + csize >= nb;
    float* slot = last ? cluster.map_shared_rank(&gather[0], 0) + rank * BT * cols : res;
    for (int idx = tid; idx < (last ? B : BT) * cols; idx += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) t += red[wp * BT * cols + idx];
      t *= s_sc[idx % cols];
      slot[idx] = blk == rank ? t : res[idx] + t;
    }
    if (!last) __syncthreads();  // xs, red and s_sc are rewritten by the next scale block
  }

  // after one cluster barrier rank 0 sums the ranks' tiles in rank order,
  // and the other ranks may exit (nobody reads their shared memory)
  cluster.sync();
  if (rank == 0) {
    for (int idx = tid; idx < B * cols; idx += kThreads) {
      const int c = col0 + idx % cols;
      if (c < O) {
        float t = 0.f;
        for (int q = 0; q < csize; ++q) t += gather[q * BT * cols + idx];
        y[(size_t)(idx / cols) * O + c] = __float2bfloat16(t);
      }
    }
  }
}

template <int BT>
int launch_gemv(const __nv_bfloat16* x, const int8_t* packed, const float* scale, __nv_bfloat16* y, int B,
                int n_in, int nb, int half, int O, int tiles, int cluster, int x_vec, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, int4_gemv_kernel<BT>, x, packed, scale, y, B, n_in, nb, half, O, x_vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Rows of x padded to the kernel's row bucket (gemv_rows in ops/int4_fused.py).
inline int gemv_rows(int B) { return B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8 : 16; }

// ---- K6 at B=1: every unit's weights stream into shared memory at launch (int4_resident.cuh)
struct TailParams {
  const void* attn;                 // [n_attn] f32 or bf16
  const __nv_bfloat16* x;           // [H] residual
  const float* norm_w;              // [H]
  WeightMaps mo, mg, md;            // tensor maps: o [nb_o, half_o, H], gate|up [2, nb_in, half_in, I],
                                    // down [nd, half_d, H]
  float* part_o;                    // [ko, H] scratch
  float* part_d;                    // [kd, H] scratch
  __nv_bfloat16* act;               // [I] scratch
  __nv_bfloat16* out;               // [H]
  unsigned* bar;                    // [2] grid barrier, then [H / 64] down tickets; 0 between launches
  const int* plan;                  // [grid, 3, 1 + maxu]: count, unit ids (o, gate|up, down)
  int attn_bf16, n_attn, H, nb_o, half_o, nb_in, half_in, I, nd, half_d, ko, kd, maxu, parts_o, parts_g, parts_d;
  int xs_bytes;
  float eps;
};

__global__ void __launch_bounds__(kResThreads, 1) int4_o_mlp_resident_kernel(const __grid_constant__ TailParams p) {
  extern __shared__ __align__(128) uint8_t dyn[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dyn);  // the current phase's bf16 activations
  uint8_t* img = dyn + p.xs_bytes;                             // o images, norm weight, gate|up, down images
  __shared__ float x2s[kResMaxHid];
  __shared__ __align__(16) float red[kMaxItems * kUnitCols];
  __shared__ float sm[kResWarps];
  __shared__ int last_flag;
  __shared__ __align__(8) uint64_t mbar[3];  // o, norm weight + gate|up, down: their copies have landed
  const int H = p.H, Ko = p.nb_o * 2 * p.half_o, Kin = p.nb_in * 2 * p.half_in, tiles = H / kUnitCols;
  const int* mine = p.plan + (size_t)blockIdx.x * 3 * (1 + p.maxu);
  const int n_o = mine[0], n_g = mine[1 + p.maxu], n_d = mine[2 * (1 + p.maxu)];
  const int *ids_o = mine + 1, *ids_g = mine + 2 + p.maxu, *ids_d = mine + 3 + 2 * p.maxu;
  const UnitShape uo = {1, p.nb_o / p.ko, p.half_o, H, p.parts_o}, ug = {2, p.nb_in, p.half_in, p.I, p.parts_g},
                  ud = {1, p.nd / p.kd, p.half_d, H, p.parts_d};
  uint8_t* img_g = img + n_o * uo.bytes() + H * 4;
  uint8_t* img_d = img_g + n_g * ug.bytes();

  // attn is read first, then every copy of the launch goes out: o, then the norm weight and gate|up, then down
  float av[4];  // this thread's attn values (Ko <= 4 * kResThreads)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = threadIdx.x + i * kResThreads;
    av[i] = 0.f;
    if (k < p.n_attn)
      av[i] = p.attn_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.attn)[k])
                          : static_cast<const float*>(p.attn)[k];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) mbar_init(mbar + s);
    mbar_fence_init();
    mbar_expect(mbar, n_o * uo.bytes());
    for (int k = 0; k < n_o; ++k)
      copy_unit(img + k * uo.bytes(), uo, p.mo, 0, 0, 0, 0, (ids_o[k] / tiles) * uo.nb, (ids_o[k] % tiles) * kUnitCols,
                mbar);
    mbar_expect(mbar + 1, H * 4 + n_g * ug.bytes());
    bulk_copy(img_g - H * 4, p.norm_w, H * 4, mbar + 1);
    for (int k = 0; k < n_g; ++k)
      copy_unit(img_g + k * ug.bytes(), ug, p.mg, 0, p.nb_in * p.half_in, 0, p.nb_in, 0, ids_g[k] * kUnitCols, mbar + 1);
    mbar_expect(mbar + 2, n_d * ud.bytes());
    for (int k = 0; k < n_d; ++k)
      copy_unit(img_d + k * ud.bytes(), ud, p.md, 0, 0, 0, 0, (ids_d[k] / tiles) * ud.nb, (ids_d[k] % tiles) * kUnitCols,
                mbar + 2);
  }
  __syncthreads();

  // phase 1: o_proj units over bf16(attn) -> f32 partials per split of the input
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (threadIdx.x + i * kResThreads < Ko) xs[threadIdx.x + i * kResThreads] = __float2bfloat16(av[i]);
  mbar_wait(mbar, 0);
  __syncthreads();
  run_units(img, uo, n_o, [&](int k) { return xs + (ids_o[k] / tiles) * uo.nb * 2 * p.half_o; }, red,
            [&](int k, int j, float s, float) {
              p.part_o[(size_t)(ids_o[k] / tiles) * H + (ids_o[k] % tiles) * kUnitCols + j] = s;
            });
  grid_arrive(p.bar);
  grid_wait(p.bar, gridDim.x);

  // phase 2: x2 and the norm (every block); gate|up units -> act
  {
    float o[kPerThread];
    sum_splits(p.part_o, p.ko, H, o);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int k = threadIdx.x + i * kResThreads;
      if (k < H) x2s[k] = __bfloat162float(p.x[k]) + o[i];
    }
  }
  mbar_wait(mbar + 1, 0);
  __syncthreads();
  rmsnorm_bf16(x2s, reinterpret_cast<const float*>(img_g) - H, H, Kin, p.eps, xs, sm);
  run_units(img_g, ug, n_g, [&](int) { return xs; }, red, [&](int k, int j, float g, float u) {
    p.act[ids_g[k] * kUnitCols + j] = __float2bfloat16(g / (1.f + expf(-g)) * u);
  });
  grid_arrive(p.bar);
  grid_wait(p.bar, 2 * gridDim.x);

  // phase 3: down units -> f32 partials; the last unit of a column tile (a ticket, returned to 0) writes
  // out = bf16(x2 + the tile's partials summed in split order)
  mbar_wait(mbar + 2, 0);
  __syncthreads();
  if (n_d > 0) {
    stage_bf16(xs, p.act, p.I, p.I);
    run_units(img_d, ud, n_d, [&](int k) { return xs + (ids_d[k] / tiles) * ud.nb * 2 * p.half_d; }, red,
              [&](int k, int j, float s, float) {
                p.part_d[(size_t)(ids_d[k] / tiles) * H + (ids_d[k] % tiles) * kUnitCols + j] = s;
              });
    for (int k = 0; k < n_d; ++k) {
      const int tile = ids_d[k] % tiles;
      if (threadIdx.x == 0) last_flag = ticket_add(p.bar + 2 + tile) == (unsigned)(p.kd - 1);
      __syncthreads();
      if (last_flag) {
        if (threadIdx.x < kUnitCols) {
          const int c = tile * kUnitCols + threadIdx.x;
          float d[kMaxSplits];
#pragma unroll
          for (int s = 0; s < kMaxSplits; ++s) d[s] = s < p.kd ? ld_cg(p.part_d + (size_t)s * H + c) : 0.f;
          float sum = 0.f;
#pragma unroll
          for (int s = 0; s < kMaxSplits; ++s) sum += d[s];
          p.out[c] = __float2bfloat16(x2s[c] + sum);
        }
        if (threadIdx.x == 0) p.bar[2 + tile] = 0;
      }
      __syncthreads();
    }
  }
  grid_exit(p.bar);
}

// ---- K5: mma.sync over resident unit images (int4_resident.cuh), every decoded weight serving all rows
constexpr int kMlpMaxItems = 16;  // items of one batch of units: red holds 16 * 16 * NH f32 per lane for each

// One 16-input k-step of 16 weight columns (the A operand): four registers of bf16 pairs, each a nibble of
// packed rows k and k + 1 of one column (low halves row k). A nibble sits in the mantissa of bf16 0x4300
// (128 + nibble; the high nibble's sign bit flipped makes it offset-binary like the low one), and one bf16x2
// subtraction of 136 leaves q exactly.
__device__ __forceinline__ uint32_t nib_pair(uint32_t a, uint32_t b, uint32_t sel, uint32_t magic) {
  const uint32_t v = __byte_perm(a, b, sel);  // byte 0 from a, byte 2 from b
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(r) : "r"(v), "r"(0x000F000Fu), "r"(magic));  // (v & mask) ^ magic
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));  // * 1 - 136
  return r;
}

// d += A (16 x 16, row-major) . B (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The items of n_units units whose images lie at img + k * u.bytes(), NH * 8 rows of activations at
// x + k * x_unit (row stride sx, scale block b's inputs at + b * 2 * half): warp w takes items w, w + 16, ...;
// an item is a part of one (plane, scale block), u.half / u.parts packed rows, read 8 at a time.
//
// Lane (g, t) = (lane / 4, lane % 4) of a k-step over packed rows R..R+7 loads 8 bytes (columns 8g..8g+7) of
// rows R + 2t and R + 2t + 1: byte j of its first word is column 8g + j, row g of the product's A operand in
// m-tile j; byte j of its second word is column 8g + 4 + j, row g + 8. The k index 2t + e (e = 0, 1) is input
// R + 2t + e of the scale block (low nibbles), 8 + 2t + e input half + R + 2t + e (high nibbles), so x's B
// operand is two 32-bit loads per 8 rows. The sums land as the accumulator fragments: element c of m-tile j,
// row half h is column 8g + j + 4 (c / 2), row 8h + 2t + c % 2; times the column's scale, each is stored at
// red[(item * V + v) * 32 + lane], v = (j * NH + h) * 4 + c, V = 16 * NH. Ends with a __syncthreads().
template <int NH>
__device__ void mma_items(const uint8_t* img, const UnitShape& u, int n_units, const __nv_bfloat16* x, size_t x_unit,
                          int sx, float* red) {
  constexpr int V = 16 * NH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int per_unit = u.items(), steps = u.half / 8 / u.parts;
  for (int it = warp; it < n_units * per_unit; it += kResWarps) {
    const int k = it / per_unit, r = it % per_unit;
    const int pl = r / (u.nb * u.parts), b = (r / u.parts) % u.nb, row0 = (r % u.parts) * steps * 8;
    const uint8_t* im = img + (size_t)k * u.bytes();
    const uint8_t* wp = im + ((size_t)(pl * u.nb + b) * u.half + row0 + 2 * t) * kUnitCols + 8 * g;
    const __nv_bfloat16* xp = x + k * x_unit + (size_t)g * sx + b * 2 * u.half + row0 + 2 * t;
    float acc[4][NH][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][h][c] = 0.f;
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const uint2 wa = *reinterpret_cast<const uint2*>(wp + s * 8 * kUnitCols);
      const uint2 wb = *reinterpret_cast<const uint2*>(wp + (s * 8 + 1) * kUnitCols);
      uint32_t bx[NH][2];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const __nv_bfloat16* xr = xp + (size_t)h * 8 * sx + s * 8;
        bx[h][0] = *reinterpret_cast<const uint32_t*>(xr);
        bx[h][1] = *reinterpret_cast<const uint32_t*>(xr + u.half);
      }
      const uint32_t ax4 = wa.x >> 4, bx4 = wb.x >> 4, ay4 = wa.y >> 4, by4 = wb.y >> 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = 0x4400u + 0x1111u * j;
        const uint32_t a[4] = {nib_pair(wa.x, wb.x, sel, 0x43004300u), nib_pair(wa.y, wb.y, sel, 0x43004300u),
                               nib_pair(ax4, bx4, sel, 0x43084308u), nib_pair(ay4, by4, sel, 0x43084308u)};
#pragma unroll
        for (int h = 0; h < NH; ++h) mma_bf16(acc[j][h], a, bx[h][0], bx[h][1]);
      }
    }
    const float* sc = reinterpret_cast<const float*>(im + u.row_bytes()) + (pl * u.nb + b) * kUnitCols + 8 * g;
    const float4 s_lo = *reinterpret_cast<const float4*>(sc), s_hi = *reinterpret_cast<const float4*>(sc + 4);
    const float slo[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w}, shi[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
    float* dst = red + (size_t)it * V * 32 + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int v = (j * NH + h) * 4;
        dst[(v + 0) * 32] = acc[j][h][0] * slo[j];
        dst[(v + 1) * 32] = acc[j][h][1] * slo[j];
        dst[(v + 2) * 32] = acc[j][h][2] * shi[j];
        dst[(v + 3) * 32] = acc[j][h][3] * shi[j];
      }
  }
  __syncthreads();
}

// The n units of a phase (images at img + k * u.bytes(), activations at x + k * x_unit), in batches whose
// items fit red: out(k, row, col, s0, s1) receives row `row`, column `col` of unit k, summed over its items in
// order, of plane 0 and plane 1 (0 for one plane).
template <int NH, typename Out>
__device__ void run_mma_units(const uint8_t* img, const UnitShape& u, int n, const __nv_bfloat16* x, size_t x_unit,
                              int sx, float* red, Out out) {
  constexpr int V = 16 * NH;
  const int per_unit = u.items(), per_plane = u.nb * u.parts, batch = kMlpMaxItems / per_unit;
  for (int k0 = 0; k0 < n; k0 += batch) {
    const int nk = min(batch, n - k0);
    mma_items<NH>(img + (size_t)k0 * u.bytes(), u, nk, x + k0 * x_unit, x_unit, sx, red);
    for (int idx = threadIdx.x; idx < nk * V * 32; idx += kResThreads) {
      const int k = idx / (V * 32), v = idx / 32 % V, lane = idx % 32;
      const int c = v % 4, h = v / 4 % NH, j = v / 4 / NH;
      const float* r = red + (size_t)k * per_unit * V * 32 + idx % (V * 32);
      float s0 = 0.f, s1 = 0.f;
      for (int i = 0; i < per_plane; ++i) s0 += r[(size_t)i * V * 32];
      if (u.planes > 1)
        for (int i = per_plane; i < 2 * per_plane; ++i) s1 += r[(size_t)i * V * 32];
      out(k0 + k, 8 * h + 2 * (lane % 4) + c % 2, 8 * (lane / 4) + j + 4 * (c / 2), s0, s1);
    }
    __syncthreads();
  }
}

// 8 values of src (16-byte aligned) as bf16: bf16 as it is, f32 rounded to the nearest even. kL2: src was
// written by other blocks of this launch (read through L2).
template <bool kL2>
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* src) {
  const uint4* p = reinterpret_cast<const uint4*>(src);
  return kL2 ? __ldcg(p) : __ldg(p);
}
template <bool kL2>
__device__ __forceinline__ uint4 load8_bf16(const float* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
  const float4 a = kL2 ? __ldcg(p) : __ldg(p), b = kL2 ? __ldcg(p + 1) : __ldg(p + 1);
  __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                         __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  return *reinterpret_cast<const uint4*>(h);
}

// xs[r * sx + c] = bf16(src[r * ld + c]) for r < live, c < n (a multiple of 8, 16-byte aligned rows), zero up to
// K columns and `rows` rows.
template <bool kL2, typename T>
__device__ void stage_rows(__nv_bfloat16* xs, const T* src, int live, int rows, int n, int K, size_t ld, int sx) {
  constexpr int kBatch = 4;  // loads in flight per thread before their stores
  const int per = K / 8, total = rows * per;
  for (int q0 = threadIdx.x; q0 < total; q0 += kBatch * kResThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int q = q0 + i * kResThreads, r = q / per, c = q % per * 8;
      v[i] = make_uint4(0, 0, 0, 0);
      if (q < total && r < live && c < n) v[i] = load8_bf16<kL2>(src + r * ld + c);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int q = q0 + i * kResThreads;
      if (q < total) *reinterpret_cast<uint4*>(xs + (size_t)(q / per) * sx + q % per * 8) = v[i];
    }
  }
}

struct MlpParams {
  const __nv_bfloat16* x;  // [B, n_in]
  WeightMaps mg, md;       // tensor maps: gate|up [2, nb_in, half_in, I], down [nd, half_d, H]
  __nv_bfloat16* act;      // [B, I] scratch
  float* part_d;           // [kd, B, H] scratch
  __nv_bfloat16* out;      // [B, H]
  unsigned* bar;           // [2] grid barrier, then [H / 64] down tickets; 0 between launches
  const int* plan;         // [grid, 2, 1 + maxu]: count, unit ids (gate|up, down)
  int B, n_in, nb_in, half_in, I, nd, half_d, H, kd, maxu, parts_g, parts_d, xs_bytes, red_bytes;
};

template <int NH>
__global__ void __launch_bounds__(kResThreads, 1) int4_mlp_kernel(const __grid_constant__ MlpParams p) {
  constexpr int kRows = 8 * NH;
  extern __shared__ __align__(128) uint8_t dyn[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dyn);  // the phase's bf16 activations, kRows rows
  float* red = reinterpret_cast<float*>(dyn + p.xs_bytes);    // the items' sums
  uint8_t* img = dyn + p.xs_bytes + p.red_bytes;              // gate|up images, then down images
  __shared__ int last_flag;
  __shared__ __align__(8) uint64_t mbar[2];  // gate|up, down: their copies have landed
  const int H = p.H, tiles = H / kUnitCols;
  const int* mine = p.plan + (size_t)blockIdx.x * 2 * (1 + p.maxu);
  const int n_g = mine[0], n_d = mine[1 + p.maxu];
  const int *ids_g = mine + 1, *ids_d = mine + 2 + p.maxu;
  const UnitShape ug = {2, p.nb_in, p.half_in, p.I, p.parts_g}, ud = {1, p.nd / p.kd, p.half_d, H, p.parts_d};
  uint8_t* img_d = img + n_g * ug.bytes();

  // every copy of the launch goes out first: gate|up, then down
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) mbar_init(mbar + s);
    mbar_fence_init();
    mbar_expect(mbar, n_g * ug.bytes());
    for (int k = 0; k < n_g; ++k)
      copy_unit(img + k * ug.bytes(), ug, p.mg, 0, p.nb_in * p.half_in, 0, p.nb_in, 0, ids_g[k] * kUnitCols, mbar);
    mbar_expect(mbar + 1, n_d * ud.bytes());
    for (int k = 0; k < n_d; ++k)
      copy_unit(img_d + k * ud.bytes(), ud, p.md, 0, 0, 0, 0, (ids_d[k] / tiles) * ud.nb, (ids_d[k] % tiles) * kUnitCols,
                mbar + 1);
  }

  // phase 1: x staged (zero past n_in and past B); gate|up units -> act
  const int Kin = p.nb_in * 2 * p.half_in, sx = Kin + 8;  // 16 bytes of padding: lanes' rows on other banks
  if (n_g > 0) stage_rows<false>(xs, p.x, p.B, kRows, p.n_in, Kin, p.n_in, sx);
  __syncthreads();
  mbar_wait(mbar, 0);
  run_mma_units<NH>(img, ug, n_g, xs, 0, sx, red, [&](int k, int r, int j, float g, float u) {
    if (r < p.B) p.act[(size_t)r * p.I + ids_g[k] * kUnitCols + j] = __float2bfloat16(g / (1.f + expf(-g)) * u);
  });
  grid_arrive(p.bar);
  grid_wait(p.bar, gridDim.x);

  // phase 2: down units over their split of act -> f32 partials; the last unit of a column tile (a ticket,
  // returned to 0) writes out = bf16(the tile's partials summed in split order)
  if (n_d > 0) {
    const int Kd = ud.nb * 2 * p.half_d, sd = Kd + 8;
    for (int k = 0; k < n_d; ++k)
      stage_rows<true>(xs + (size_t)k * kRows * sd, p.act + (size_t)(ids_d[k] / tiles) * Kd, p.B, kRows, Kd, Kd, p.I,
                       sd);
    mbar_wait(mbar + 1, 0);
    __syncthreads();
    run_mma_units<NH>(img_d, ud, n_d, xs, (size_t)kRows * sd, sd, red,
                      [&](int k, int r, int j, float s, float) {
                        if (r < p.B)
                          p.part_d[((size_t)(ids_d[k] / tiles) * p.B + r) * H + (ids_d[k] % tiles) * kUnitCols + j] = s;
                      });
    for (int k = 0; k < n_d; ++k) {
      const int tile = ids_d[k] % tiles;
      if (threadIdx.x == 0) last_flag = ticket_add(p.bar + 2 + tile) == (unsigned)(p.kd - 1);
      __syncthreads();
      if (last_flag) {
        for (int idx = threadIdx.x; idx < p.B * kUnitCols; idx += kResThreads) {
          const size_t o = (size_t)(idx / kUnitCols) * H + tile * kUnitCols + idx % kUnitCols;
          float d[kMaxSplits];
#pragma unroll
          for (int s = 0; s < kMaxSplits; ++s) d[s] = s < p.kd ? ld_cg(p.part_d + (size_t)s * p.B * H + o) : 0.f;
          float sum = 0.f;
#pragma unroll
          for (int s = 0; s < kMaxSplits; ++s) sum += d[s];
          p.out[o] = __float2bfloat16(sum);
        }
        if (threadIdx.x == 0) p.bar[2 + tile] = 0;
      }
      __syncthreads();
    }
  }
  grid_exit(p.bar);
}

// ---- K6 at B = 2..16: K6's units and phases (as at B=1), K5's tensor-core products (every decoded weight
// serving all rows)
struct TailRowsParams {
  const void* attn;        // [B, n_attn] f32 or bf16
  const __nv_bfloat16* x;  // [B, H] residual
  const float* norm_w;     // [H]
  WeightMaps mo, mg, md;   // tensor maps: o [nb_o, half_o, H], gate|up [2, nb_in, half_in, I], down [nd, half_d, H]
  float* part_o;           // [ko, B, H] scratch
  float* part_d;           // [kd, B, H] scratch
  __nv_bfloat16* act;      // [B, I] scratch
  __nv_bfloat16* out;      // [B, H]
  unsigned* bar;           // [2] grid barrier, then [H / 64] down tickets; 0 between launches
  const int* plan;         // [grid, 3, 1 + maxu]: count, unit ids (o, gate|up, down)
  int attn_bf16, B, n_attn, H, nb_o, half_o, nb_in, half_in, I, nd, half_d, ko, kd, maxu, parts_o, parts_g, parts_d;
  int xs_bytes, red_bytes;
  float eps;
};

// x2[r, c..c+3] = x + the o_proj partials of row r summed in split order, in f32: the same bits in every block
// and in the last down unit of a tile. Every load goes out before the first add.
__device__ __forceinline__ float4 x2_quad(const TailRowsParams& p, int r, int c) {
  float4 v[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    v[s] = s < p.ko ? __ldcg(reinterpret_cast<const float4*>(p.part_o + ((size_t)s * p.B + r) * p.H + c))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  const uint2 xr = __ldg(reinterpret_cast<const uint2*>(p.x + (size_t)r * p.H + c));
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    o.x += v[s].x;
    o.y += v[s].y;
    o.z += v[s].z;
    o.w += v[s].w;
  }
  const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
  const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
  return make_float4(x01.x + o.x, x01.y + o.y, x23.x + o.z, x23.y + o.w);
}

template <int NH>
__global__ void __launch_bounds__(kResThreads, 1) int4_o_mlp_rows_kernel(const __grid_constant__ TailRowsParams p) {
  constexpr int kRows = 8 * NH;
  extern __shared__ __align__(128) uint8_t dyn[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dyn);  // the phase's bf16 activations, kRows rows
  float* red = reinterpret_cast<float*>(dyn + p.xs_bytes);    // the items' sums; x2 [B, H] in phase 2
  uint8_t* img = dyn + p.xs_bytes + p.red_bytes;              // o images, norm weight, gate|up, down images
  __shared__ float inv[kRows];                                // each row's 1 / rms(x2)
  __shared__ int last_flag;
  __shared__ __align__(8) uint64_t mbar[3];  // o, norm weight + gate|up, down: their copies have landed
  const int H = p.H, tiles = H / kUnitCols, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* mine = p.plan + (size_t)blockIdx.x * 3 * (1 + p.maxu);
  const int n_o = mine[0], n_g = mine[1 + p.maxu], n_d = mine[2 * (1 + p.maxu)];
  const int *ids_o = mine + 1, *ids_g = mine + 2 + p.maxu, *ids_d = mine + 3 + 2 * p.maxu;
  const UnitShape uo = {1, p.nb_o / p.ko, p.half_o, H, p.parts_o}, ug = {2, p.nb_in, p.half_in, p.I, p.parts_g},
                  ud = {1, p.nd / p.kd, p.half_d, H, p.parts_d};
  uint8_t* img_g = img + n_o * uo.bytes() + H * 4;
  uint8_t* img_d = img_g + n_g * ug.bytes();

  // every copy of the launch goes out first: o, then the norm weight and gate|up, then down
  if (threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) mbar_init(mbar + s);
    mbar_fence_init();
    mbar_expect(mbar, n_o * uo.bytes());
    for (int k = 0; k < n_o; ++k)
      copy_unit(img + k * uo.bytes(), uo, p.mo, 0, 0, 0, 0, (ids_o[k] / tiles) * uo.nb, (ids_o[k] % tiles) * kUnitCols,
                mbar);
    mbar_expect(mbar + 1, H * 4 + n_g * ug.bytes());
    bulk_copy(img_g - H * 4, p.norm_w, H * 4, mbar + 1);
    for (int k = 0; k < n_g; ++k)
      copy_unit(img_g + k * ug.bytes(), ug, p.mg, 0, p.nb_in * p.half_in, 0, p.nb_in, 0, ids_g[k] * kUnitCols, mbar + 1);
    mbar_expect(mbar + 2, n_d * ud.bytes());
    for (int k = 0; k < n_d; ++k)
      copy_unit(img_d + k * ud.bytes(), ud, p.md, 0, 0, 0, 0, (ids_d[k] / tiles) * ud.nb, (ids_d[k] % tiles) * kUnitCols,
                mbar + 2);
  }

  // phase 1: each o unit's split of attn staged in bf16 (zero past n_attn and past B); o_proj units -> f32
  // partials per split of the input
  const int Ko = uo.nb * 2 * p.half_o, so = Ko + 8;  // 16 bytes of padding: lanes' rows on other banks
  for (int k = 0; k < n_o; ++k) {
    const int c0 = (ids_o[k] / tiles) * Ko;
    __nv_bfloat16* dst = xs + (size_t)k * kRows * so;
    const int live = p.n_attn - c0;
    if (p.attn_bf16)
      stage_rows<false>(dst, static_cast<const __nv_bfloat16*>(p.attn) + c0, p.B, kRows, live, Ko, p.n_attn, so);
    else
      stage_rows<false>(dst, static_cast<const float*>(p.attn) + c0, p.B, kRows, live, Ko, p.n_attn, so);
  }
  __syncthreads();  // also orders the mbarriers' initialisation before any wait on them
  mbar_wait(mbar, 0);
  run_mma_units<NH>(img, uo, n_o, xs, (size_t)kRows * so, so, red, [&](int k, int r, int j, float s, float) {
    if (r < p.B) p.part_o[((size_t)(ids_o[k] / tiles) * p.B + r) * H + (ids_o[k] % tiles) * kUnitCols + j] = s;
  });
  grid_arrive(p.bar);
  grid_wait(p.bar, gridDim.x);

  // phase 2 (blocks with gate|up units): x2 in f32 and each row's norm, the same bits in every block; h2 staged;
  // gate|up units -> act
  mbar_wait(mbar + 1, 0);
  if (n_g > 0) {
    const int Kin = p.nb_in * 2 * p.half_in, sx = Kin + 8;
    float* x2s = red;  // free until the gate|up units' first items
    for (int q = threadIdx.x; q < p.B * (H / 4); q += kResThreads) {
      const int r = q / (H / 4), c = q % (H / 4) * 4;
      *reinterpret_cast<float4*>(x2s + (size_t)r * H + c) = x2_quad(p, r, c);
    }
    __syncthreads();
    if (warp < p.B) {  // warp r sums row r's squares in a fixed order
      float ss = 0.f;
      for (int k = lane; k < H; k += 32) ss += x2s[(size_t)warp * H + k] * x2s[(size_t)warp * H + k];
      ss = warp_sum(ss);
      if (lane == 0) inv[warp] = rsqrtf(ss / H + p.eps);
    }
    __syncthreads();
    const float* nw = reinterpret_cast<const float*>(img_g) - H;
    for (int q = threadIdx.x; q < kRows * (Kin / 2); q += kResThreads) {
      const int r = q / (Kin / 2), k = q % (Kin / 2) * 2;
      float a = 0.f, b = 0.f;
      if (r < p.B && k < H) {  // H is even
        a = x2s[(size_t)r * H + k] * inv[r] * nw[k];
        b = x2s[(size_t)r * H + k + 1] * inv[r] * nw[k + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(xs + (size_t)r * sx + k) = __floats2bfloat162_rn(a, b);
    }
    __syncthreads();
    run_mma_units<NH>(img_g, ug, n_g, xs, 0, sx, red, [&](int k, int r, int j, float g, float u) {
      if (r < p.B) p.act[(size_t)r * p.I + ids_g[k] * kUnitCols + j] = __float2bfloat16(g / (1.f + expf(-g)) * u);
    });
  }
  grid_arrive(p.bar);
  grid_wait(p.bar, 2 * gridDim.x);

  // phase 3: down units over their split of act -> f32 partials; the last unit of a column tile (a ticket,
  // returned to 0) writes out = bf16(x2 + the tile's partials summed in split order)
  mbar_wait(mbar + 2, 0);
  if (n_d > 0) {
    const int Kd = ud.nb * 2 * p.half_d, sd = Kd + 8;
    for (int k = 0; k < n_d; ++k)
      stage_rows<true>(xs + (size_t)k * kRows * sd, p.act + (size_t)(ids_d[k] / tiles) * Kd, p.B, kRows, Kd, Kd, p.I,
                       sd);
    __syncthreads();
    run_mma_units<NH>(img_d, ud, n_d, xs, (size_t)kRows * sd, sd, red, [&](int k, int r, int j, float s, float) {
      if (r < p.B) p.part_d[((size_t)(ids_d[k] / tiles) * p.B + r) * H + (ids_d[k] % tiles) * kUnitCols + j] = s;
    });
    for (int k = 0; k < n_d; ++k) {
      const int tile = ids_d[k] % tiles;
      if (threadIdx.x == 0) last_flag = ticket_add(p.bar + 2 + tile) == (unsigned)(p.kd - 1);
      __syncthreads();
      if (last_flag) {
        for (int q = threadIdx.x; q < p.B * (kUnitCols / 4); q += kResThreads) {
          const int r = q / (kUnitCols / 4), c = tile * kUnitCols + q % (kUnitCols / 4) * 4;
          const size_t o = (size_t)r * H + c;
          float4 d[kMaxSplits];
#pragma unroll
          for (int s = 0; s < kMaxSplits; ++s)
            d[s] = s < p.kd ? __ldcg(reinterpret_cast<const float4*>(p.part_d + (size_t)s * p.B * H + o))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int s = 0; s < kMaxSplits; ++s) {
            sum.x += d[s].x;
            sum.y += d[s].y;
            sum.z += d[s].z;
            sum.w += d[s].w;
          }
          const float4 x2 = x2_quad(p, r, c);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(x2.x + sum.x, x2.y + sum.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x2.z + sum.z, x2.w + sum.w);
          *reinterpret_cast<uint2*>(p.out + o) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
        }
        if (threadIdx.x == 0) p.bar[2 + tile] = 0;
      }
      __syncthreads();
    }
  }
  grid_exit(p.bar);
}

}  // namespace

extern "C" {

// tiles and cluster come from gemv_plan in ops/int4_fused.py.
int cvt_int4_gemv(const void* x, const void* packed, const float* scale, void* y, int B, int n_in, int nb,
                  int half, int O, int tiles, int cluster, void* stream) {
  if (B < 1 || B > kMaxRows || O % kColsPerThread != 0 || half <= 0 || half % 8 != 0 || nb < 1 ||
      n_in > nb * 2 * half || gemv_rows(B) * 2 * half > kGemvXElems || tiles != (O + kGemvCols - 1) / kGemvCols ||
      cluster < 1 || cluster > kGemvMaxCluster || cluster > nb || !aligned16(packed) || !aligned16(scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pb = static_cast<const int8_t*>(packed);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const int x_vec = n_in % 8 == 0 && aligned16(x);
  switch (gemv_rows(B)) {
    case 1: return launch_gemv<1>(xb, pb, scale, yb, B, n_in, nb, half, O, tiles, cluster, x_vec, s);
    case 2: return launch_gemv<2>(xb, pb, scale, yb, B, n_in, nb, half, O, tiles, cluster, x_vec, s);
    case 4: return launch_gemv<4>(xb, pb, scale, yb, B, n_in, nb, half, O, tiles, cluster, x_vec, s);
    case 8: return launch_gemv<8>(xb, pb, scale, yb, B, n_in, nb, half, O, tiles, cluster, x_vec, s);
    default: return launch_gemv<16>(xb, pb, scale, yb, B, n_in, nb, half, O, tiles, cluster, x_vec, s);
  }
}

// K6 at B=1. plan, the splits ko and kd, maxu, parts_*, xs_bytes, img_bytes and grid come from
// ops/int4_fused.py:o_mlp_plan.
int cvt_int4_o_mlp_resident(const void* attn, int attn_bf16, const void* x, const float* norm_w, const void* o_p,
                            const float* o_s, const void* gu_p, const float* gu_s, const void* d_p, const float* d_s,
                            float* work, void* out, void* counters, const int* plan, int n_attn, int H, int nb_o,
                            int half_o, int nb_in, int half_in, int I, int nd, int half_d, int ko, int kd, int maxu,
                            int parts_o, int parts_g, int parts_d, int xs_bytes, int img_bytes, int grid, float eps,
                            void* stream) {
  const int Ko = nb_o * 2 * half_o, Kin = nb_in * 2 * half_in;
  const bool splits_ok = ko >= 1 && kd >= 1 && ko <= kMaxSplits && kd <= kMaxSplits && nb_o % ko == 0 && nd % kd == 0;
  const bool halves_ok = half_o % (8 * parts_o) == 0 && half_in % (8 * parts_g) == 0 &&
                         half_d % (8 * parts_d) == 0 && half_o <= 256 && half_in <= 256 && half_d <= 256;
  const bool items_ok = nb_o / ko * parts_o <= kMaxItems && 2 * nb_in * parts_g <= kMaxItems &&
                        nd / kd * parts_d <= kMaxItems;
  const bool aligned = aligned16(o_p) && aligned16(o_s) && aligned16(gu_p) && aligned16(gu_s) && aligned16(d_p) &&
                       aligned16(d_s) && aligned16(norm_w) && aligned16(work);
  if (!splits_ok || !halves_ok || !items_ok || !aligned || H % kUnitCols != 0 || I % kUnitCols != 0 ||
      H > kResMaxHid || Ko > 4 * kResThreads || n_attn > Ko || H > Kin || nd * 2 * half_d != I ||
      xs_bytes < 2 * Ko || xs_bytes < 2 * Kin || xs_bytes < 2 * I || xs_bytes % 128 || img_bytes % 16 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(int4_o_mlp_resident_kernel);
  const int dyn = xs_bytes + img_bytes;
  int sms = 0, per_sm = 0;
  const int rc = resident_blocks(kernel, dyn, &sms, &per_sm);
  if (rc != 0) return rc;
  if (per_sm < 1 || grid > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  TailParams p;
  p.attn = attn;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.norm_w = norm_w;
  int rc_map = weight_maps(&p.mo, o_p, o_s, H, (uint64_t)nb_o * half_o, half_o, nb_o, nb_o / ko);
  if (rc_map == 0)
    rc_map = weight_maps(&p.mg, gu_p, gu_s, I, (uint64_t)2 * nb_in * half_in, half_in, 2 * nb_in, nb_in);
  if (rc_map == 0) rc_map = weight_maps(&p.md, d_p, d_s, H, (uint64_t)nd * half_d, half_d, nd, nd / kd);
  if (rc_map != 0) return rc_map;
  // one f32 workspace: o partials [ko, H], down partials [kd, H], then act [I] bf16
  p.part_o = work;
  p.part_d = work + (size_t)ko * H;
  p.act = reinterpret_cast<__nv_bfloat16*>(work + (size_t)(ko + kd) * H);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.bar = static_cast<unsigned*>(counters);
  p.plan = plan;
  p.attn_bf16 = attn_bf16;
  p.n_attn = n_attn;
  p.H = H;
  p.nb_o = nb_o;
  p.half_o = half_o;
  p.nb_in = nb_in;
  p.half_in = half_in;
  p.I = I;
  p.nd = nd;
  p.half_d = half_d;
  p.ko = ko;
  p.kd = kd;
  p.maxu = maxu;
  p.parts_o = parts_o;
  p.parts_g = parts_g;
  p.parts_d = parts_d;
  p.xs_bytes = xs_bytes;
  p.eps = eps;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kResThreads), args, dyn,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K6 at B = 2..16. plan, the splits ko and kd, maxu, parts_*, xs_bytes, red_bytes, img_bytes and grid come from
// ops/int4_fused.py:o_mlp_plan(..., B); work holds the o partials [ko, B, H] f32, the down partials [kd, B, H]
// f32, then act [B, I] bf16; counters 2 + H / 64 ints, 0 on entry.
int cvt_int4_o_mlp_rows(const void* attn, int attn_bf16, const void* x, const float* norm_w, const void* o_p,
                        const float* o_s, const void* gu_p, const float* gu_s, const void* d_p, const float* d_s,
                        float* work, void* out, void* counters, const int* plan, int B, int n_attn, int H, int nb_o,
                        int half_o, int nb_in, int half_in, int I, int nd, int half_d, int ko, int kd, int maxu,
                        int parts_o, int parts_g, int parts_d, int xs_bytes, int red_bytes, int img_bytes, int grid,
                        float eps, void* stream) {
  const int NH = B <= 8 ? 1 : 2, rows = 8 * NH, Kin = nb_in * 2 * half_in;
  const bool splits_ok = ko >= 1 && kd >= 1 && ko <= kMaxSplits && kd <= kMaxSplits && nb_o % ko == 0 && nd % kd == 0;
  const bool halves_ok = parts_o >= 1 && parts_g >= 1 && parts_d >= 1 && half_o % (8 * parts_o) == 0 &&
                         half_in % (8 * parts_g) == 0 && half_d % (8 * parts_d) == 0 && half_o <= 256 &&
                         half_in <= 256 && half_d <= 256;
  const bool items_ok = nb_o / ko * parts_o <= kMlpMaxItems && 2 * nb_in * parts_g <= kMlpMaxItems &&
                        nd / kd * parts_d <= kMlpMaxItems;
  const bool aligned = aligned16(attn) && aligned16(x) && aligned16(norm_w) && aligned16(o_p) && aligned16(o_s) &&
                       aligned16(gu_p) && aligned16(gu_s) && aligned16(d_p) && aligned16(d_s) && aligned16(work) &&
                       aligned16(out);
  const int stage = maxu * rows * (nb_o / ko * 2 * half_o + 8) > rows * (Kin + 8)
                        ? maxu * rows * (nb_o / ko * 2 * half_o + 8)
                        : rows * (Kin + 8);
  const bool smem_ok = xs_bytes >= 2 * stage && xs_bytes >= 2 * maxu * rows * (nd / kd * 2 * half_d + 8) &&
                       red_bytes >= kMlpMaxItems * 16 * NH * 32 * 4 && red_bytes >= B * H * 4 && xs_bytes % 128 == 0 &&
                       red_bytes % 128 == 0 && img_bytes % 16 == 0;
  if (B < 1 || B > kMaxRows || !splits_ok || !halves_ok || !items_ok || !aligned || !smem_ok || n_attn < 8 ||
      n_attn % 8 != 0 || n_attn > nb_o * 2 * half_o || H % kUnitCols != 0 || I % kUnitCols != 0 || H > Kin ||
      nd * 2 * half_d != I || maxu < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const void* kernel = NH == 1 ? reinterpret_cast<const void*>(int4_o_mlp_rows_kernel<1>)
                               : reinterpret_cast<const void*>(int4_o_mlp_rows_kernel<2>);
  const int dyn = xs_bytes + red_bytes + img_bytes;
  int sms = 0, per_sm = 0;
  const int rc = resident_blocks(kernel, dyn, &sms, &per_sm);
  if (rc != 0) return rc;
  if (per_sm < 1 || grid > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  TailRowsParams p;
  p.attn = attn;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.norm_w = norm_w;
  int rc_map = weight_maps(&p.mo, o_p, o_s, H, (uint64_t)nb_o * half_o, half_o, nb_o, nb_o / ko);
  if (rc_map == 0)
    rc_map = weight_maps(&p.mg, gu_p, gu_s, I, (uint64_t)2 * nb_in * half_in, half_in, 2 * nb_in, nb_in);
  if (rc_map == 0) rc_map = weight_maps(&p.md, d_p, d_s, H, (uint64_t)nd * half_d, half_d, nd, nd / kd);
  if (rc_map != 0) return rc_map;
  p.part_o = work;
  p.part_d = work + (size_t)ko * B * H;
  p.act = reinterpret_cast<__nv_bfloat16*>(work + (size_t)(ko + kd) * B * H);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.bar = static_cast<unsigned*>(counters);
  p.plan = plan;
  p.attn_bf16 = attn_bf16;
  p.B = B;
  p.n_attn = n_attn;
  p.H = H;
  p.nb_o = nb_o;
  p.half_o = half_o;
  p.nb_in = nb_in;
  p.half_in = half_in;
  p.I = I;
  p.nd = nd;
  p.half_d = half_d;
  p.ko = ko;
  p.kd = kd;
  p.maxu = maxu;
  p.parts_o = parts_o;
  p.parts_g = parts_g;
  p.parts_d = parts_d;
  p.xs_bytes = xs_bytes;
  p.red_bytes = red_bytes;
  p.eps = eps;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kResThreads), args, dyn,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K5. plan, kd, maxu, parts_*, xs_bytes, red_bytes, img_bytes and grid come from ops/int4_fused.py:mlp_plan;
// work holds the down partials [kd, B, H] f32, then act [B, I] bf16; counters 2 + H / 64 ints, 0 on entry.
int cvt_int4_mlp(const void* x, const void* gu_p, const float* gu_s, const void* d_p, const float* d_s, float* work,
                 void* out, void* counters, const int* plan, int B, int n_in, int nb_in, int half_in, int I, int nd,
                 int half_d, int H, int kd, int maxu, int parts_g, int parts_d, int xs_bytes, int red_bytes,
                 int img_bytes, int grid, void* stream) {
  const int NH = B <= 8 ? 1 : 2, rows = 8 * NH, Kin = nb_in * 2 * half_in;
  const bool splits_ok = kd >= 1 && kd <= kMaxSplits && nd % kd == 0;
  const bool halves_ok = parts_g >= 1 && parts_d >= 1 && half_in % (8 * parts_g) == 0 && half_d % (8 * parts_d) == 0 &&
                         half_in <= 256 && half_d <= 256;
  const bool items_ok = 2 * nb_in * parts_g <= kMlpMaxItems && nd / kd * parts_d <= kMlpMaxItems;
  const bool aligned = aligned16(x) && aligned16(gu_p) && aligned16(gu_s) && aligned16(d_p) && aligned16(d_s) &&
                       aligned16(work);
  const bool smem_ok = xs_bytes >= rows * (Kin + 8) * 2 && xs_bytes >= maxu * rows * (nd / kd * 2 * half_d + 8) * 2 &&
                       red_bytes >= kMlpMaxItems * 16 * NH * 32 * 4 && xs_bytes % 128 == 0 && red_bytes % 128 == 0 &&
                       img_bytes % 16 == 0;
  if (B < 1 || B > kMaxRows || !splits_ok || !halves_ok || !items_ok || !aligned || !smem_ok || n_in % 8 != 0 ||
      n_in > Kin || H % kUnitCols != 0 || I % kUnitCols != 0 || nd * 2 * half_d != I || maxu < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      NH == 1 ? reinterpret_cast<const void*>(int4_mlp_kernel<1>) : reinterpret_cast<const void*>(int4_mlp_kernel<2>);
  const int dyn = xs_bytes + red_bytes + img_bytes;
  int sms = 0, per_sm = 0;
  const int rc = resident_blocks(kernel, dyn, &sms, &per_sm);
  if (rc != 0) return rc;
  if (per_sm < 1 || grid > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  MlpParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  int rc_map = weight_maps(&p.mg, gu_p, gu_s, I, (uint64_t)2 * nb_in * half_in, half_in, 2 * nb_in, nb_in);
  if (rc_map == 0) rc_map = weight_maps(&p.md, d_p, d_s, H, (uint64_t)nd * half_d, half_d, nd, nd / kd);
  if (rc_map != 0) return rc_map;
  p.part_d = work;
  p.act = reinterpret_cast<__nv_bfloat16*>(work + (size_t)kd * B * H);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.bar = static_cast<unsigned*>(counters);
  p.plan = plan;
  p.B = B;
  p.n_in = n_in;
  p.nb_in = nb_in;
  p.half_in = half_in;
  p.I = I;
  p.nd = nd;
  p.half_d = half_d;
  p.H = H;
  p.kd = kd;
  p.maxu = maxu;
  p.parts_g = parts_g;
  p.parts_d = parts_d;
  p.xs_bytes = xs_bytes;
  p.red_bytes = red_bytes;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kResThreads), args, dyn,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
