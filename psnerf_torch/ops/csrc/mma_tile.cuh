// Building blocks shared by the stage-1 kernels (fused_occ.cu,
// fused_radiance.cu, fused_radiance_f32.cu): one CTA of 8 warps owns a
// tile of MI * 16 points; a [rows, K] operand tile sits in shared memory
// and each warp runs mma.sync (f32 accumulators) over all rows of the tile
// for its own output columns.
// bf16 operands run mma.sync m16n8k16 (one product per k-step of 16). The
// f32-operand kernels (fused_radiance_f32.cu) build "3xTF32" wgmma
// products from split_tf32 below: x = hi + lo with hi = tf32(x), lo =
// tf32(x - hi), and lo·hi' + hi·lo' + hi·hi' keeps ~2^-22 of |x x'|, close
// to an f32 product.
//
// Accumulator ("fragment") layout of a warp that owns NT n-tiles of 8
// columns starting at n_base (g = lane / 4, t = lane % 4), the same for
// m16n8k16 bf16 and m16n8k8 tf32:
//   acc[i][j][r]  row = i * 16 + g + (r >> 1) * 8
//                 col = n_base + j * 8 + 2 * t + (r & 1)
// Every element of a [rows, W] tile has exactly one owning thread, so
// elementwise work, per-column sums (a shuffle over g) and thread-private
// scratch in device memory need no synchronisation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace psnerf {

constexpr int BM = 64;             // points per tile (bf16 operands)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// What an operand type sets besides the tile product: the row padding of
// shared tiles (conflict-free fragment loads: a row stride of 4 mod 32
// words) and the rounding of an f32 value to the operand type.
template <typename T> struct Operand;

template <> struct Operand<__nv_bfloat16> {
  static constexpr int PAD = 8;
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x = hi + lo (+ ~2^-22 |x|), both as tf32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
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

// acc (+)= act[0:16 MI, 0:K] @ wT[n_base + 0 : n_base + 8 * NT, 0:K]^T.
// act: shared, row stride lda. wT: [n][k] with row stride ldw, in global
// memory (B_GLOBAL, read through the read-only path) or shared. K is a
// multiple of the form's k-step; zero = start from 0 rather than
// accumulate.
// bf16, m16n8k16:
//   A regs: (row g, k 2t..) (row g+8, k 2t..) (row g, k 2t+8..) (row g+8, k 2t+8..)
//   B regs: (k 2t.., col g) (k 2t+8.., col g)
template <int NT, bool B_GLOBAL, int MI = BM / 16>
__device__ __forceinline__ void warp_gemm(const __nv_bfloat16* act, int lda,
                                          int K,
                                          const __nv_bfloat16* __restrict__ wT,
                                          int ldw, int n_base,
                                          float (&acc)[MI][NT][4], bool zero) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (zero) zero_acc(acc);
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* pb = wT + (size_t)(n_base + j * 8 + g) * ldw + k0 + 2 * t;
      b[j][0] = B_GLOBAL ? ldg_u32(pb) : lds_u32(pb);
      b[j][1] = B_GLOBAL ? ldg_u32(pb + 8) : lds_u32(pb + 8);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const __nv_bfloat16* pa = act + (i * 16 + g) * lda + k0 + 2 * t;
      const uint32_t a0 = lds_u32(pa);
      const uint32_t a1 = lds_u32(pa + 8 * lda);
      const uint32_t a2 = lds_u32(pa + 8);
      const uint32_t a3 = lds_u32(pa + 8 * lda + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_bf16_16816(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
    }
  }
}

// act[row][col] = operand(v) for this thread's fragment elements.
template <int NT, int MI = BM / 16>
__device__ __forceinline__ void put_act(__nv_bfloat16* act, int lda,
                                        const float (&v)[MI][NT][4],
                                        int n_base) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = frag_row(i, 2 * h), col = frag_col(n_base, j, 0);
        *reinterpret_cast<__nv_bfloat162*>(act + row * lda + col) =
            __floats2bfloat162_rn(v[i][j][2 * h], v[i][j][2 * h + 1]);
      }
}

// Partial row sums of v * w[col] over this warp's columns, into
// red[warp * 16 MI + row]; the caller sums the NWARPS partials after a sync.
template <int NT, int MI = BM / 16>
__device__ __forceinline__ void rowsum_partial(const float (&v)[MI][NT][4],
                                               const float* __restrict__ w,
                                               int n_base, float* red) {
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = frag_col(n_base, j, 0);
        s += v[i][j][2 * h] * __ldg(w + col) + v[i][j][2 * h + 1] * __ldg(w + col + 1);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) red[warp * MI * 16 + frag_row(i, 2 * h)] = s;
    }
}

}  // namespace psnerf
