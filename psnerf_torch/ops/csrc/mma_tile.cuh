// Building blocks of the f32-operand fused_radiance kernels
// (fused_radiance_f32.cu): one CTA of 8 warps owns a tile of points, and
// the products are "3xTF32" wgmma built from split_tf32 below: x = hi + lo
// with hi = tf32(x), lo = tf32(x - hi), and lo·hi' + hi·lo' + hi·hi'
// keeps ~2^-22 of |x x'|, close to an f32 product.
//
// Accumulator ("fragment") layout of a warp that owns NT n-tiles of 8
// columns starting at n_base (g = lane / 4, t = lane % 4), the m16n8
// layout that wgmma's accumulators also take, each warp its 16 rows:
//   acc[i][j][r]  row = i * 16 + g + (r >> 1) * 8
//                 col = n_base + j * 8 + 2 * t + (r & 1)
// Every element of a [rows, W] tile has exactly one owning thread, so
// elementwise work, per-column sums (a shuffle over g) and thread-private
// scratch in device memory need no synchronisation.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace psnerf {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// x = hi + lo (+ ~2^-22 |x|), both as tf32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ int frag_row(int i, int r) {
  return i * 16 + ((threadIdx.x & 31) >> 2) + (r >> 1) * 8;
}

__device__ __forceinline__ int frag_col(int n_base, int j, int r) {
  return n_base + j * 8 + 2 * (threadIdx.x & 3) + (r & 1);
}

template <int MI, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][NT][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

}  // namespace psnerf
