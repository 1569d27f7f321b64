// Fused per-(light, pixel) visibility MLP, and the same trunk followed by
// SG shading, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of psnerf_tpu/ops/fused_vis.py:
//   * fused_visibility (_vis_kernel over _accumulate_vis): raw, pre-clip
//     visibility [L, N] of the relu 8x256 trunk with a skip at layer 4;
//   * fused_vis_shade (_vis_shade_kernel): that trunk, then clip to [0, 1]
//     and the SG shading epilogue, as rgb [L, N, 3], [3, N, L] or the light
//     sum [N, 3].
//
// What bounds it: operations. Each (light, pixel) pair runs seven dependent
// 256x256 bf16 products (about 0.92 MFLOP); a 512x512 x 96-light frame is
// about 23 TFLOP against well under 1 GB of inputs and outputs, so the
// tensor cores, not memory, are the limit.
//
// Design: one CTA of 8 warps owns 64 pixel rows and loops over every light,
// as the TPU grid step does. The light-independent halves of layer 0 and of
// the skip layer (A0 = em @ W0x, B5 = em @ W5x) are computed once per CTA
// and kept in shared memory as f32. A [64, W] bf16 activation tile stays in
// shared memory across the layers; each warp owns W/8 output columns and
// runs bf16 mma.sync (m16n8k16, f32 accumulators) over the whole tile, with
// its weight fragments read straight from global memory: the ~1 MB trunk
// stays resident in the 50 MB L2. The last layer's dot with w8 is reduced in
// f32 from the relu output, without rounding it to bf16. Every output
// element has exactly one writer, so nothing needs atomics. wgmma, TMA and
// warp specialisation are left for later.
//
// Rounding points, as in the TPU kernel: activations are rounded to bf16
// before each trunk product; A0 + r0 and (acc + B5) + r5 are added in f32;
// the skip layer's bias lives in r5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // pixel rows per CTA
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PIXW = 40;           // floats per pixel of shading inputs
constexpr int MAX_BASIS = 9;

// shading inputs, per pixel (row of `pix`):
//   0-2 normal, 3-5 view (= -ray dir), 6 v.n, 7 mask, 8-10 albedo,
//   11.. SG weights (nbasis, or 3*nbasis when specular_rgb)
constexpr int PIX_VN = 6, PIX_MASK = 7, PIX_ALB = 8, PIX_W = 11;

enum Mode { RAW = 0, LNC = 1, CNL = 2, SUM = 3 };

struct Params {
  const __nv_bfloat16* em;       // [N, ke] bf16 point embedding (zero-padded)
  const __nv_bfloat16* w0xT;     // [W, ke] layer-0 point rows, transposed
  const __nv_bfloat16* w5xT;     // [W, ke] skip-layer point rows, transposed
  const float* r0;               // [L, W] layer-0 light rows + bias
  const float* r5;               // [L, W] skip-layer light rows + bias
  const __nv_bfloat16* trunk_wT; // [n_trunk, W, W] (out, in)
  const float* trunk_b;          // [n_trunk, W] (skip row unused)
  const float* w8;               // [W] bf16-rounded output row
  const float* b8;               // [1] output bias (read on the device)
  const float* pix;              // [N, PIXW] shading inputs (shade modes)
  const float* ld;               // [L, 3] light dirs
  const float* lint;             // [L, 3] per-channel intensity
  float* out;
  float lobes[MAX_BASIS];
  int n, ke, n_lights, n_trunk, n_pre, nbasis, specular_rgb;
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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// acc[i][j] = act[i*16.., :K] @ wT[n_base + j*8.., :K]^T for this warp's
// columns. act: shared [BM][W + 8] bf16; wT: global [W][K] bf16.
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: (row g, k 2t..) (row g+8, k 2t..) (row g, k 2t+8..) (row g+8, k 2t+8..)
//   B regs: (k 2t.., col g) (k 2t+8.., col g)
//   C: c0,c1 row g cols 2t, 2t+1; c2,c3 row g+8.
template <int W>
__device__ __forceinline__ void warp_gemm(const __nv_bfloat16* act, int K,
                                          const __nv_bfloat16* __restrict__ wT,
                                          float (&acc)[4][W / 64][4],
                                          int n_base, int g, int t) {
  constexpr int NT = W / 64;
  constexpr int LDA = W + 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* p = wT + (size_t)(n_base + j * 8 + g) * K + k0 + 2 * t;
      b[j][0] = ldg_u32(p);
      b[j][1] = ldg_u32(p + 8);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16* pa = act + (i * 16 + g) * LDA + k0 + 2 * t;
      const uint32_t a0 = ld_u32(pa);
      const uint32_t a1 = ld_u32(pa + 8 * LDA);
      const uint32_t a2 = ld_u32(pa + 8);
      const uint32_t a3 = ld_u32(pa + 8 * LDA + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_bf16_16816(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
    }
  }
}

template <int W, int MODE>
__global__ void __launch_bounds__(NTHREADS, 1) fused_vis_kernel(const Params p) {
  constexpr int NT = W / 64;
  constexpr int LDA = W + 8;     // bf16 activation row stride (bank spread)
  constexpr int LDF = W + 8;     // f32 A0/B5 row stride
  extern __shared__ __align__(16) unsigned char smem[];
  float* a0s = reinterpret_cast<float*>(smem);                 // [BM][LDF]
  float* b5s = a0s + BM * LDF;                                 // [BM][LDF]
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(b5s + BM * LDF);
  float* red = reinterpret_cast<float*>(act + BM * LDA);       // [NWARPS][BM]
  float* pixs = red + NWARPS * BM;                             // [BM][PIXW]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_base = warp * (W / NWARPS);
  const int row0 = blockIdx.x * BM;
  const int N = p.n, L = p.n_lights;
  const float b8 = __ldg(p.b8);

  // point embedding tile -> act (rows past N are zero)
  const int kw = p.ke / 2;
  for (int idx = tid; idx < BM * kw; idx += NTHREADS) {
    const int r = idx / kw, c = (idx % kw) * 2;
    uint32_t v = 0;
    if (row0 + r < N) v = ld_u32(p.em + (size_t)(row0 + r) * p.ke + c);
    *reinterpret_cast<uint32_t*>(act + r * LDA + c) = v;
  }
  if (MODE != RAW) {
    for (int idx = tid; idx < BM * PIXW; idx += NTHREADS) {
      const int r = idx / PIXW;
      pixs[idx] = (row0 + r < N) ? p.pix[(size_t)row0 * PIXW + idx] : 0.f;
    }
  }
  __syncthreads();

  float acc[4][NT][4];
  // A0 and B5: the light-independent halves, once per tile
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    warp_gemm<W>(act, p.ke, pass == 0 ? p.w0xT : p.w5xT, acc, n_base, g, t);
    float* dst = pass == 0 ? a0s : b5s;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = i * 16 + g + (r >> 1) * 8;
          const int col = n_base + j * 8 + 2 * t + (r & 1);
          dst[row * LDF + col] = acc[i][j][r];
        }
  }
  __syncthreads();

  float rgb_sum[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < L; ++l) {
    // layer 0: relu(A0 + r0[l]), rounded to bf16 for the first trunk product
    const float* r0l = p.r0 + (size_t)l * W;
    for (int idx = tid; idx < BM * W; idx += NTHREADS) {
      const int r = idx / W, c = idx % W;
      act[r * LDA + c] = __float2bfloat16_rn(fmaxf(a0s[r * LDF + c] + r0l[c], 0.f));
    }
    __syncthreads();

    for (int li = 0; li < p.n_trunk; ++li) {
      warp_gemm<W>(act, W, p.trunk_wT + (size_t)li * W * W, acc, n_base, g, t);
      __syncthreads();  // every warp has finished reading act
      const bool skip = li == p.n_pre;
      const bool last = li == p.n_trunk - 1;
      const float* bias = p.trunk_b + (size_t)li * W;
      const float* r5l = p.r5 + (size_t)l * W;
      float part[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = i * 16 + g + h * 8;
            const int col = n_base + j * 8 + 2 * t;
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = acc[i][j][h * 2 + e];
              const float pre = skip ? (a + b5s[row * LDF + col + e]) + r5l[col + e]
                                     : a + bias[col + e];
              y[e] = fmaxf(pre, 0.f);
            }
            if (last) {
              part[i][h] += y[0] * p.w8[col] + y[1] * p.w8[col + 1];
            } else {
              *reinterpret_cast<__nv_bfloat162*>(act + row * LDA + col) =
                  __floats2bfloat162_rn(y[0], y[1]);
            }
          }
      if (last) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = part[i][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t == 0) red[warp * BM + i * 16 + g + h * 8] = v;
          }
      }
      __syncthreads();
    }

    if (tid < BM && row0 + tid < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[w * BM + tid];
      const float raw = s + b8;
      const int n = row0 + tid;
      if (MODE == RAW) {
        p.out[(size_t)l * N + n] = raw;
      } else {
        const float* px = pixs + tid * PIXW;
        const float lx = p.ld[l * 3], ly = p.ld[l * 3 + 1], lz = p.ld[l * 3 + 2];
        const float cosv = px[0] * lx + px[1] * ly + px[2] * lz;
        const float lv = px[3] * lx + px[4] * ly + px[5] * lz;
        const float vis = fminf(fmaxf(raw, 0.f), 1.f);
        // h.n = (l.n + v.n) / max(|l + v|, eps), |l + v|^2 = 2 + 2 l.v for
        // unit l, v; the clamps keep near-antipodal lights finite
        const float hn = (cosv + px[PIX_VN]) /
                         fmaxf(sqrtf(fmaxf(2.f + 2.f * lv, 0.f)), 1e-12f);
        const float em1 = fminf(hn - 1.f, 0.f);
        float ds[MAX_BASIS];
#pragma unroll
        for (int b = 0; b < MAX_BASIS; ++b)
          ds[b] = b < p.nbasis ? expf(p.lobes[b] * em1) : 0.f;
        const float cv = cosv * vis;
        const bool inside = px[PIX_MASK] > 0.5f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float s_c = 0.f;
#pragma unroll
          for (int b = 0; b < MAX_BASIS; ++b) {
            if (b < p.nbasis) {
              const int col = p.specular_rgb ? c * p.nbasis + b : b;
              s_c = s_c + px[PIX_W + col] * ds[b];
            }
          }
          s_c = fmaxf(s_c, 0.f);
          float v = fminf(fmaxf((px[PIX_ALB + c] + s_c) * p.lint[l * 3 + c] * cv, 0.f), 1.f);
          v = inside ? v : 1.f;
          if (MODE == LNC) p.out[((size_t)l * N + n) * 3 + c] = v;
          if (MODE == CNL) p.out[((size_t)c * N + n) * L + l] = v;
          if (MODE == SUM) rgb_sum[c] += v;
        }
      }
    }
  }
  if (MODE == SUM && tid < BM && row0 + tid < N) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p.out[(size_t)(row0 + tid) * 3 + c] = rgb_sum[c];
  }
}

template <int W>
constexpr size_t smem_bytes(int mode) {
  return 2 * (size_t)BM * (W + 8) * sizeof(float) +
         (size_t)BM * (W + 8) * sizeof(__nv_bfloat16) +
         (size_t)NWARPS * BM * sizeof(float) +
         (mode == RAW ? 0 : (size_t)BM * PIXW * sizeof(float));
}

template <int W, int MODE>
cudaError_t launch_mode(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<W>(MODE);
  cudaError_t err = cudaFuncSetAttribute(
      fused_vis_kernel<W, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (p.n + BM - 1) / BM;
  fused_vis_kernel<W, MODE><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_width(int mode, const Params& p, cudaStream_t stream) {
  switch (mode) {
    case RAW: return launch_mode<W, RAW>(p, stream);
    case LNC: return launch_mode<W, LNC>(p, stream);
    case CNL: return launch_mode<W, CNL>(p, stream);
    case SUM: return launch_mode<W, SUM>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = cudaSuccess). mode: 0 raw vis [L, N];
// 1 rgb [L, N, 3]; 2 rgb [3, N, L]; 3 light-sum rgb [N, 3].
// width must be 64, 128 or 256; ke a multiple of 16 no larger than width;
// nbasis at most 9. Shading pointers may be null in mode 0.
extern "C" int psnerf_fused_vis(
    int mode, int width, const void* em, int n, int ke, const void* w0xT,
    const void* w5xT, const void* r0, const void* r5, int n_lights,
    const void* trunk_wT, const void* trunk_b, int n_trunk, int n_pre,
    const void* w8, const void* b8, const void* pix, const void* ld,
    const void* lint, const float* lobes, int nbasis, int specular_rgb,
    void* out, void* stream) {
  if (n <= 0 || n_lights <= 0) return cudaSuccess;
  if (ke <= 0 || ke % 16 != 0 || ke > width || nbasis < 0 ||
      nbasis > MAX_BASIS || n_trunk < 1 || n_pre < 0 || n_pre >= n_trunk)
    return cudaErrorInvalidValue;
  Params p;
  p.em = static_cast<const __nv_bfloat16*>(em);
  p.w0xT = static_cast<const __nv_bfloat16*>(w0xT);
  p.w5xT = static_cast<const __nv_bfloat16*>(w5xT);
  p.r0 = static_cast<const float*>(r0);
  p.r5 = static_cast<const float*>(r5);
  p.trunk_wT = static_cast<const __nv_bfloat16*>(trunk_wT);
  p.trunk_b = static_cast<const float*>(trunk_b);
  p.w8 = static_cast<const float*>(w8);
  p.pix = static_cast<const float*>(pix);
  p.ld = static_cast<const float*>(ld);
  p.lint = static_cast<const float*>(lint);
  p.out = static_cast<float*>(out);
  p.b8 = static_cast<const float*>(b8);
  for (int i = 0; i < MAX_BASIS; ++i) p.lobes[i] = i < nbasis ? lobes[i] : 0.f;
  p.n = n;
  p.ke = ke;
  p.n_lights = n_lights;
  p.n_trunk = n_trunk;
  p.n_pre = n_pre;
  p.nbasis = nbasis;
  p.specular_rgb = specular_rgb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64: return launch_width<64>(mode, p, s);
    case 128: return launch_width<128>(mode, p, s);
    case 256: return launch_width<256>(mode, p, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* psnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
