// Device code shared by the int4 decode kernels (csrc/int4_fused.cu: K4, K5,
// K6; csrc/int4_block.cu: K7): the blocked half-split int4 layout, K4's
// block geometry, a warp sum and an alignment test.
//
// Weight layout (ops/int4_fused.py packers, the JAX package's "blocked
// half-split"): packed [nb, half, O] int8 and scale [nb, O] f32. In scale
// block b, the LOW nibble of packed[b, i, o] is input row b*2*half + i,
// stored offset-binary (q + 8); the HIGH nibble is input row
// b*2*half + half + i, signed; q is in [-7, 7]. The block's scale multiplies
// the block's partial dot (in the kernels: each item's share of it), not the
// weights.
//
// Every definition sits in an anonymous namespace: each .cu that includes
// this header gets its own copy (the library is built without -rdc).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // K4's block
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 16;  // one 16-byte load of packed bytes: widths are multiples of 16

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
