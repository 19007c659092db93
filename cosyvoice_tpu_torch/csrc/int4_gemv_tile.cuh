// Device code shared by the int4 decode kernels (csrc/int4_fused.cu: K4, K5,
// K6; csrc/int4_block.cu: K7): the block-level GEMV work item over the
// blocked half-split int4 layout (K6 at B > 1), the layout itself, and the
// fixed-order block reductions.
//
// Weight layout (ops/int4_fused.py packers, the JAX package's "blocked
// half-split"): packed [nb, half, O] int8 and scale [nb, O] f32. In scale
// block b, the LOW nibble of packed[b, i, o] is input row b*2*half + i,
// stored offset-binary (q + 8); the HIGH nibble is input row
// b*2*half + half + i, signed; q is in [-7, 7]. The block's scale multiplies
// the block's partial dot (here: each thread's share of it), not the weights.
//
// gemv_tile is one work item: 64 output columns of y = x @ dequant(W) over a
// range of scale blocks, for up to BT activation rows. 256 threads = 4 column
// groups x 64 row slices; a thread owns 16 neighbouring columns and reads
// them with one 16-byte load per packed row, so the 4 column-group lanes of a
// warp read 64 contiguous bytes of a row and the warp's 8 row slices read 8
// rows. Activations come from shared memory as bf16; sums are f32. The 64
// slices are reduced with warp shuffles, then across the 8 warps through
// shared memory, in a fixed order: results repeat bit for bit.
//
// Every definition sits in an anonymous namespace: each .cu that includes
// this header gets its own copy (the library is built without -rdc).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 16;  // one 16-byte load of packed bytes
constexpr int kColGroups = 4;       // column groups per block (lane % 4)
constexpr int kTileCols = kColGroups * kColsPerThread;  // 64
constexpr int kRowSlices = kThreads / kColGroups;       // 64

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum of v over the block, the same fixed order in every block.
__device__ float block_sum(float v, float* sm) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) sm[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sm[w];
  __syncthreads();
  return s;
}

// res[r * 64 + c] = sum over scale blocks [b0, b1) of x[r0 + r] . W[:, col0 + c]
// for r < nr <= BT. xs holds the activation rows of that input range, row
// stride xs_stride (row r0 + r starts at xs + (r0 + r) * xs_stride). O must be
// a multiple of 16; column groups past O contribute nothing. Ends with a
// __syncthreads(), after which res is complete.
template <int BT>
__device__ void gemv_tile(const int8_t* __restrict__ packed, const float* __restrict__ scale, int half,
                          int O, int b0, int b1, const __nv_bfloat16* xs, int xs_stride, int r0, int nr,
                          int col0, float* red, float* res) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane % kColGroups;
  const int slice = warp * (32 / kColGroups) + lane / kColGroups;
  const int col = col0 + group * kColsPerThread;
  float acc[BT][kColsPerThread];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;

  if (col < O) {
    for (int b = b0; b < b1; ++b) {
      float part[BT][kColsPerThread];
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) part[r][j] = 0.f;
      const int8_t* pb = packed + (size_t)b * half * O + col;
      const __nv_bfloat16* xb = xs + (size_t)(b - b0) * 2 * half;
#pragma unroll 2
      for (int i = slice; i < half; i += kRowSlices) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(pb + (size_t)i * O));
        float xl[BT], xh[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const bool live = r < nr;
          xl[r] = live ? __bfloat162float(xb[(size_t)(r0 + r) * xs_stride + i]) : 0.f;
          xh[r] = live ? __bfloat162float(xb[(size_t)(r0 + r) * xs_stride + half + i]) : 0.f;
        }
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          // byte j, sign-extended: the high nibble is then the signed q_hi,
          // the low nibble q_lo + 8
          const int byte = static_cast<int>(words[j / 4] << (24 - 8 * (j % 4))) >> 24;
          const float lo = static_cast<float>((byte & 15) - 8);
          const float hi = static_cast<float>(byte >> 4);
#pragma unroll
          for (int r = 0; r < BT; ++r) part[r][j] += xl[r] * lo + xh[r] * hi;
        }
      }
      const float4* sp = reinterpret_cast<const float4*>(scale + (size_t)b * O + col);
#pragma unroll
      for (int q = 0; q < kColsPerThread / 4; ++q) {
        const float4 s = __ldg(sp + q);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          acc[r][4 * q + 0] += part[r][4 * q + 0] * s.x;
          acc[r][4 * q + 1] += part[r][4 * q + 1] * s.y;
          acc[r][4 * q + 2] += part[r][4 * q + 2] * s.z;
          acc[r][4 * q + 3] += part[r][4 * q + 3] * s.w;
        }
      }
    }
  }

  // the 8 row slices of a warp sit in lane bits 2..4
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      float v = acc[r][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][j] = v;
    }
  if (lane < kColGroups) {
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        red[(warp * BT + r) * kTileCols + group * kColsPerThread + j] = acc[r][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BT * kTileCols; idx += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * BT * kTileCols + idx];
    res[idx] = s;
  }
  __syncthreads();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
