// Device code shared by the int4 decode kernels whose weights stream into shared memory ahead of use
// (csrc/int4_fused.cu: K5, K6; csrc/int4_block.cu: K7): TMA copies through tensor maps, completing on
// mbarriers; a grid barrier that a launch returns to 0; the unit of work over a weight image resident in
// shared memory.
//
// Weight layout: the blocked half-split int4 layout of int4_layout.cuh, packed [nb, half, O] int8 and
// scale [nb, O] f32 (a plane; gate|up has two).
//
// A unit is 64 output columns of one weight over a range of its scale blocks (ops/int4_fused.py:
// resident_plan assigns every unit of a phase to one block, fixed on the host). Its image in shared memory
// is, per plane, its packed rows (64 bytes each: the unit's columns) of every scale block in turn, then
// every plane's scales (64 f32 per scale block). The copies of an image are issued long before it is read
// (one TMA box per scale block and plane, through tensor maps of the weights), so they run through the grid
// barriers in between. (One bulk copy per 64-byte row was tried
// first: ~1600 copies per block to issue, and K6 took 60 us at B=1 on an H100; so was cp.async, 16 bytes a
// thread, which delayed each phase's reads.)
//
// Reading a unit at one row (K6 at B=1, K7; K5 and K6 at B > 1 take the tensor cores, csrc/int4_fused.cu:
// mma_items): its rows are cut into items (plane, scale block, part of the block's rows); a warp takes
// one item at a time, four lanes a row (16 columns each) and eight rows at a time. Nibbles are decoded
// without integer-to-float conversions: a nibble at bits [4m, 4m+4) of a 32-bit word (m <= 4) is masked
// into the mantissa of 2^23 (one LOP3, the sign bit of the high nibble flipped on the way, which makes it
// offset-binary like the low one), so the float is 2^23 + (q + 8) 16^m exactly; subtracting
// 2^23 + 8 * 16^m leaves q 16^m exactly, and the activation is pre-scaled by 16^-m (exact). So every
// product is the exact x * q of the plain version, summed in f32; the item's sums times its block's scales
// are reduced over the eight rows of the warp (a reduce-scatter: 14 shuffles for 16 columns) into shared
// memory, and the items of a unit are summed in a fixed order. No atomics on data: results repeat bit
// for bit.
//
// Every definition sits in an anonymous namespace: each .cu that includes this header gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_layout.cuh"

namespace {

constexpr int kResThreads = 512;  // 16 warps: four per scheduler hide the decode's latencies
constexpr int kResWarps = kResThreads / 32;
constexpr int kUnitCols = 64;  // output columns of a unit: one 64-byte segment of each packed row
constexpr int kMaxItems = 32;  // items of one batch of units (red holds 64 sums each)
constexpr unsigned kFull = 0xffffffffu;

// ---- copies by the TMA engine (cp.async.bulk), completing on an mbarrier per stage. A tensor map
// describes a weight as a 2-D array of rows; one copy moves a box of up to 256 rows of a 64-column (64-byte
// or 256-byte) slice into shared memory, rows packed. One thread issues a stage's few copies, and they
// leave the SM's load/store path free for the latency-bound reads of each phase (16-byte cp.async copies of
// the same bytes queue in front of those and delay them by a microsecond or more).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
// Makes the initialised mbarriers visible to the copy engine (after the inits, before a __syncthreads()).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
}
// The one arrival of a stage's phase, announcing the bytes its copies bring (0: the phase completes now).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Waits until the phase of the given parity has completed (every byte of the stage landed); traps rather
// than spin for ever if it never does.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (long long spin = 0;; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}
// bytes (a multiple of 16, both ends 16-byte aligned) of contiguous global memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}
// The box of `map` at (column c0, row r0).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

// Host: a 2-D tensor map of rows x cols elements (esize bytes each, rows contiguous) with boxes of box_rows x
// box_cols, encoded by cuTensorMapEncodeTiled (looked up through the runtime); cached by its arguments. Returns 0 or a
// CUDA error code.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline int tensor_map(CUtensorMap* out, const void* base, CUtensorMapDataType type, int esize, uint64_t cols,
                      uint64_t rows, uint32_t box_cols, uint32_t box_rows) {
  struct Entry {
    const void* base;
    uint64_t cols, rows;
    uint32_t box_cols, box_rows;
    int type;
    CUtensorMap map;
  };
  static Entry cache[512];
  static int n_cache = 0, next = 0;
  for (int i = 0; i < n_cache; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.cols == cols && e.rows == rows && e.box_cols == box_cols && e.box_rows == box_rows &&
        e.type == (int)type) {
      *out = e.map;
      return 0;
    }
  }
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (fn == nullptr || q != cudaDriverEntryPointSuccess) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult r = encode(out, type, 2, const_cast<void*>(base), dims, strides, box, estrides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  Entry& e = cache[n_cache < 512 ? n_cache++ : (next++ % 512)];
  e = {base, cols, rows, box_cols, box_rows, (int)type, *out};
  return 0;
}

// The two maps of one weight: packed rows (uint8, rows x O, boxes of `half` rows) and scale rows (f32,
// srows x O, boxes of `nb` rows), boxes of 64 columns.
struct WeightMaps {
  CUtensorMap packed, scale;
};
inline int weight_maps(WeightMaps* m, const void* packed, const float* scale, int O, uint64_t rows, int half,
                       uint64_t srows, int nb) {
  int rc = tensor_map(&m->packed, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, rows, 64, half);
  if (rc == 0) rc = tensor_map(&m->scale, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, O, srows, 64, nb);
  return rc;
}

// ---- scratch written by one block and read by another after a wait: through L2, never L1
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }

constexpr int kMaxSplits = 10;  // f32 partials per output that a reader sums
constexpr int kResMaxHid = 2048;  // hidden size the kernels keep in static shared memory
constexpr int kPerThread = kResMaxHid / kResThreads;  // elements of a hidden vector per thread

// v[i] = sum over s < n (in order) of part[s * H + k], k = threadIdx.x + i * kResThreads (0 past H). Every
// load goes out before the first add: one round trip to L2, not n.
__device__ __forceinline__ void sum_splits(const float* part, int n, int H, float (&v)[kPerThread]) {
  float buf[kPerThread][kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int k = threadIdx.x + i * kResThreads;
      buf[i][s] = s < n && k < H ? ld_cg(part + (size_t)s * H + k) : 0.f;
    }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) a += buf[i][s];
    v[i] = a;
  }
}

// Atomic add with release (this thread's writes, and through a preceding __syncthreads() its block's) and
// acquire (what the earlier adders released) at GPU scope; returns the old value.
__device__ __forceinline__ unsigned ticket_add(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// ---- grid barrier over a cooperative launch. bar[0] counts arrivals over the whole launch (barrier k waits
// for (k + 1) * gridDim.x), bar[1] counts the blocks that have passed the last one; the last block out returns
// both to 0, so the next launch (or a CUDA-graph replay) finds them zeroed. Arrival is a release, the wait
// an acquire, at GPU scope.
__device__ __forceinline__ void grid_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar) : "memory");
}
__device__ __forceinline__ void grid_wait(unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(bar) : "memory");
    } while (v < target);
  }
  __syncthreads();
}
__device__ __forceinline__ void grid_exit(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    bar[0] = 0;
    bar[1] = 0;
  }
}

// ---- unit images
struct UnitShape {
  int planes;  // 1, or 2 for gate|up
  int nb;      // scale blocks of the unit
  int half;    // packed rows per scale block
  int O;       // columns of the weight (row stride of packed and scale)
  int parts;   // items per (plane, scale block): half / parts rows each, a multiple of 8
  __device__ int row_bytes() const { return planes * nb * half * kUnitCols; }
  __device__ int bytes() const { return row_bytes() + planes * nb * kUnitCols * 4; }
  __device__ int items() const { return planes * nb * parts; }
};

// Issues (one thread) the copies of one unit's image into dst: scale blocks [b0, b0 + nb) of columns [c0, c0 + 64)
// of every plane; plane pl's packed rows start at row row0 + pl * prow and its scale rows at srow0 + pl * psrow
// of the weight's maps. Returns the image's bytes.
__device__ int copy_unit(uint8_t* dst, const UnitShape& u, const WeightMaps& m, int row0, int prow, int srow0,
                         int psrow, int b0, int c0, uint64_t* bar) {
  for (int pl = 0; pl < u.planes; ++pl)
    for (int b = 0; b < u.nb; ++b)
      tma_box(dst + ((size_t)(pl * u.nb + b) * u.half) * kUnitCols, &m.packed, c0, row0 + pl * prow + (b0 + b) * u.half,
              bar);
  for (int pl = 0; pl < u.planes; ++pl)
    tma_box(dst + u.row_bytes() + (size_t)pl * u.nb * kUnitCols * 4, &m.scale, c0, srow0 + pl * psrow + b0, bar);
  return u.bytes();
}

// Sums v[j] over the eight lanes of a warp that share lane % 4 (lane bits 2..4): halving exchanges, 14
// shuffles. Lane L keeps the sums of its columns 8*b4 + 4*b3 + 2*b2 + {0, 1} (b_k bit k of L) in out[0..1].
__device__ __forceinline__ void reduce_rows8(const float (&v)[16], float (&out)[2]) {
  const int lane = threadIdx.x & 31;
  float a[8], b[4];
  bool hi = lane & 16;
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = (hi ? v[j + 8] : v[j]) + __shfl_xor_sync(kFull, hi ? v[j] : v[j + 8], 16);
  hi = lane & 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = (hi ? a[j + 4] : a[j]) + __shfl_xor_sync(kFull, hi ? a[j] : a[j + 4], 8);
  hi = lane & 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) out[j] = (hi ? b[j + 2] : b[j]) + __shfl_xor_sync(kFull, hi ? b[j] : b[j + 2], 4);
}

// The float 2^23 + (nibble at `mask`, high nibbles offset by their sign bit in magic) * 16^m: one LOP3,
// (w & mask) ^ magic (the compiler left alone splits it in two).
__device__ __forceinline__ float nib(uint32_t w, uint32_t mask, uint32_t magic) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(r) : "r"(w), "r"(mask), "r"(magic));
  return __uint_as_float(r);
}
constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
// 2^23 + 8 * 16^m
constexpr float kOff0 = 8388616.f, kOff1 = 8388736.f, kOff2 = 8390656.f, kOff3 = 8421376.f, kOff4 = 8912896.f;

// part[0..3] += the row's products for the four columns of word a (x_lo pre-scaled in l, x_hi in h): per
// nibble one LOP3, one FADD and one FFMA.
__device__ __forceinline__ void word_dot(uint32_t a, const float (&l)[4], const float (&h)[4], float* part) {
  const uint32_t b = a >> 12;
  part[0] = fmaf(l[0], nib(a, 0xFu, kMagic) - kOff0, part[0]);
  part[0] = fmaf(h[0], nib(a, 0xF0u, kMagic | 0x80u) - kOff1, part[0]);
  part[1] = fmaf(l[1], nib(a, 0xF00u, kMagic) - kOff2, part[1]);
  part[1] = fmaf(h[1], nib(a, 0xF000u, kMagic | 0x8000u) - kOff3, part[1]);
  part[2] = fmaf(l[2], nib(a, 0xF0000u, kMagic) - kOff4, part[2]);
  part[2] = fmaf(h[2], nib(b, 0xF00u, kMagic | 0x800u) - kOff2, part[2]);
  part[3] = fmaf(l[3], nib(b, 0xF000u, kMagic) - kOff3, part[3]);
  part[3] = fmaf(h[3], nib(b, 0xF0000u, kMagic | 0x80000u) - kOff4, part[3]);
}

// The items of n_units units whose images lie at img + k * u.bytes(): warp w takes items w, w + 8, ...; the
// 64 column sums of item i (its rows' products times its scale block's scales) land in red[i * 64 + col].
// x_of(k) gives unit k's activations in shared memory (bf16, scale block b's rows at x + b * 2 * half).
// Ends with a __syncthreads(), after which red is complete.
template <typename XOf>
__device__ void unit_items(const uint8_t* img, const UnitShape& u, int n_units, XOf x_of, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane % 4, slot = lane / 4;  // 16 columns of the row, one of 8 rows
  const int per_unit = u.items(), rows = u.half / u.parts;
  for (int it = warp; it < n_units * per_unit; it += kResWarps) {
    const int k = it / per_unit, r = it % per_unit;
    const int pl = r / (u.nb * u.parts), b = (r / u.parts) % u.nb, part = r % u.parts;
    const uint8_t* im = img + (size_t)k * u.bytes();
    const uint8_t* rowp = im + ((size_t)(pl * u.nb + b) * u.half + part * rows) * kUnitCols + group * 16;
    const __nv_bfloat16* xb = x_of(k) + (size_t)b * 2 * u.half + part * rows;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int i = slot; i < rows; i += 8) {
      const uint4 w = *reinterpret_cast<const uint4*>(rowp + (size_t)i * kUnitCols);
      const float xl = __bfloat162float(xb[i]), xh = __bfloat162float(xb[u.half + i]);
      const float l[4] = {xl, xl * 0x1p-8f, xl * 0x1p-16f, xl * 0x1p-12f};
      const float h[4] = {xh * 0x1p-4f, xh * 0x1p-12f, xh * 0x1p-8f, xh * 0x1p-16f};
      word_dot(w.x, l, h, acc);
      word_dot(w.y, l, h, acc + 4);
      word_dot(w.z, l, h, acc + 8);
      word_dot(w.w, l, h, acc + 12);
    }
    const float4* sc =
        reinterpret_cast<const float4*>(im + u.row_bytes() + (size_t)(pl * u.nb + b) * kUnitCols * 4) + group * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 s = sc[q];
      acc[4 * q] *= s.x;
      acc[4 * q + 1] *= s.y;
      acc[4 * q + 2] *= s.z;
      acc[4 * q + 3] *= s.w;
    }
    float out[2];
    reduce_rows8(acc, out);
    const int col = group * 16 + 8 * ((lane >> 4) & 1) + 4 * ((lane >> 3) & 1) + 2 * ((lane >> 2) & 1);
    *reinterpret_cast<float2*>(red + it * kUnitCols + col) = make_float2(out[0], out[1]);
  }
  __syncthreads();
}

// Sum of the items of unit k (of a batch), plane pl, column j, in item order.
__device__ __forceinline__ float unit_sum(const float* red, const UnitShape& u, int k, int pl, int j) {
  const float* r = red + ((size_t)k * u.items() + pl * u.nb * u.parts) * kUnitCols + j;
  float s = 0.f;
  for (int i = 0; i < u.nb * u.parts; ++i) s += r[i * kUnitCols];
  return s;
}

// The n units of a phase (images at img + k * u.bytes()), in batches whose items fit red: out(k, j, s0, s1)
// receives column j of unit k, summed over its items in order, of plane 0 and plane 1 (0 for one plane).
template <typename XOf, typename Out>
__device__ void run_units(const uint8_t* img, const UnitShape& u, int n, XOf x_of, float* red, Out out) {
  const int batch = kMaxItems / u.items();
  for (int k0 = 0; k0 < n; k0 += batch) {
    const int nk = min(batch, n - k0);
    unit_items(img + (size_t)k0 * u.bytes(), u, nk, [&](int k) { return x_of(k0 + k); }, red);
    for (int idx = threadIdx.x; idx < nk * kUnitCols; idx += kResThreads) {
      const int k = idx / kUnitCols, j = idx % kUnitCols;
      out(k0 + k, j, unit_sum(red, u, k, 0, j), u.planes > 1 ? unit_sum(red, u, k, 1, j) : 0.f);
    }
    __syncthreads();
  }
}

// xs[k] = bf16(x[k] * rsqrt(mean(x^2) + eps) * w[k]) for k < H, zero up to n (every block, the same bits).
__device__ void rmsnorm_bf16(const float* x, const float* w, int H, int n, float eps, __nv_bfloat16* xs,
                             float* sm) {
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += kResThreads) ss += x[k] * x[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
  if (threadIdx.x % 32 == 0) sm[threadIdx.x / 32] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < kResWarps; ++i) tot += sm[i];
  const float inv = rsqrtf(tot / H + eps);
  for (int k = threadIdx.x; k < n; k += kResThreads) xs[k] = __float2bfloat16(k < H ? x[k] * inv * w[k] : 0.f);
  __syncthreads();
}

// Loads a bf16 vector of n (a multiple of 8, 16-byte aligned) written by other blocks into shared memory,
// zero from n up to n_pad (a multiple of 8).
__device__ void stage_bf16(__nv_bfloat16* xs, const __nv_bfloat16* src, int n, int n_pad) {
  for (int q = threadIdx.x; q < n_pad / 8; q += kResThreads) {
    uint4 t = make_uint4(0, 0, 0, 0);
    if (q * 8 < n) t = __ldcg(reinterpret_cast<const uint4*>(src) + q);
    reinterpret_cast<uint4*>(xs)[q] = t;
  }
  __syncthreads();
}

// The co-resident blocks per SM of `kernel` at dyn bytes of dynamic shared memory, after raising the
// kernel's limit to dyn; cached per (kernel, dyn). Returns 0 or a CUDA error code.
inline int resident_blocks(const void* kernel, int dyn, int* sms_out, int* per_sm_out) {
  struct Entry {
    const void* kernel;
    int dyn, sms, per_sm;
  };
  static Entry cache[8];
  static int n_cache = 0;
  for (int i = 0; i < n_cache; ++i)
    if (cache[i].kernel == kernel && cache[i].dyn == dyn) {
      *sms_out = cache[i].sms;
      *per_sm_out = cache[i].per_sm;
      return 0;
    }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kResThreads, dyn);
  if (e != cudaSuccess) return (int)e;
  if (n_cache < 8) cache[n_cache++] = {kernel, dyn, sms, per_sm};
  *sms_out = sms;
  *per_sm_out = per_sm;
  return 0;
}

}  // namespace
