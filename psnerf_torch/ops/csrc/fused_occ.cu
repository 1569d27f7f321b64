// Fused occupancy-logit MLP for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel psnerf_tpu/ops/fused_occ.py
// (fused_occ_logit, kernel _occ_kernel): the raw occupancy logit of the
// weight-normed 8x256 geometry MLP (softplus(beta=100) with the linear
// cutover at 100 x > 20, one skip whose PE half is a row split), for every
// point of the stage-1 march.
//
// What bounds it: operations. Each point runs seven dependent 256x256 bf16
// products plus the two narrow embedding products (about 0.97 MFLOP); the
// march's 524,288 points are ~0.5 TFLOP against ~50 MB of inputs and 2 MB
// of outputs, so the tensor cores, not memory, are the limit.
//
// Design: the trunk of fused_vis.cu without the light axis. One CTA of 8
// warps owns 64 points; the [64, ke] bf16 embedding and a [64, W] bf16
// activation tile stay in shared memory across the layers; each warp owns
// W/8 output columns and runs bf16 mma.sync over the whole tile, with its
// weight fragments read from global memory (the ~1 MB trunk stays in L2).
// The skip layer accumulates its PE half (em @ wskip) into the same
// accumulators. The logit row is dotted in f32 with the f32 softplus
// output. Rows past N are loaded as zeros and never written. One writer per
// output element: no atomics. wgmma, TMA and warp specialisation are left
// for later.

#include "mma_tile.cuh"

using namespace psnerf;

namespace {

constexpr int LDE = 64 + 8;        // embedding tile row stride (ke <= 64)

struct OccParams {
  const __nv_bfloat16* em;       // [N, ke] point embedding (zero-padded)
  const __nv_bfloat16* w0T;      // [W, ke] layer 0, (out, in)
  const float* b0;               // [W]
  const __nv_bfloat16* wskipT;   // [W, ke] skip layer's PE rows / sqrt 2
  const __nv_bfloat16* trunk_wT; // [n_trunk, W, W] (out, in)
  const float* trunk_b;          // [n_trunk, W]
  const float* w8;               // [W] bf16-rounded logit row
  const float* b8;               // [1] logit bias (read on the device)
  float* out;                    // [N] raw logits
  int n, ke, n_trunk, n_pre;
};

__device__ __forceinline__ float sp100(float x) {
  const float bx = 100.f * x;
  return bx > 20.f ? x : (fmaxf(bx, 0.f) + log1pf(expf(-fabsf(bx)))) / 100.f;
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 2) occ_kernel(const OccParams p) {
  constexpr int NT = W / 64;
  constexpr int LDA = W + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][LDA]
  __nv_bfloat16* ems = act + BM * LDA;                            // [BM][LDE]
  float* red = reinterpret_cast<float*>(ems + BM * LDE);          // [NWARPS][BM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_base = warp * (W / NWARPS);
  const int row0 = blockIdx.x * BM;
  const int N = p.n;

  const int kw = p.ke / 2;
  for (int idx = tid; idx < BM * kw; idx += NTHREADS) {
    const int r = idx / kw, c = (idx % kw) * 2;
    uint32_t v = 0;
    if (row0 + r < N) v = ldg_u32(p.em + (size_t)(row0 + r) * p.ke + c);
    *reinterpret_cast<uint32_t*>(ems + r * LDE + c) = v;
  }
  __syncthreads();

  float acc[4][NT][4];
  warp_gemm<NT, true>(ems, LDE, p.ke, p.w0T, p.ke, n_base, acc, true);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[i][j][r] = sp100(acc[i][j][r] + __ldg(p.b0 + frag_col(n_base, j, r)));
  put_act<NT>(act, LDA, acc, n_base);
  __syncthreads();

  for (int li = 0; li < p.n_trunk; ++li) {
    warp_gemm<NT, true>(act, LDA, W, p.trunk_wT + (size_t)li * W * W, W,
                        n_base, acc, true);
    if (li == p.n_pre)
      warp_gemm<NT, true>(ems, LDE, p.ke, p.wskipT, p.ke, n_base, acc, false);
    __syncthreads();                 // every warp has finished reading act
    const float* bias = p.trunk_b + (size_t)li * W;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] = sp100(acc[i][j][r] + __ldg(bias + frag_col(n_base, j, r)));
    if (li == p.n_trunk - 1) {
      rowsum_partial<NT>(acc, p.w8, n_base, red);
    } else {
      put_act<NT>(act, LDA, acc, n_base);
    }
    __syncthreads();
  }

  if (tid < BM && row0 + tid < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w * BM + tid];
    p.out[row0 + tid] = s + __ldg(p.b8);
  }
}

template <int W>
cudaError_t launch(const OccParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)BM * (W + 8) * sizeof(__nv_bfloat16) +
                      (size_t)BM * LDE * sizeof(__nv_bfloat16) +
                      (size_t)NWARPS * BM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      occ_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (p.n + BM - 1) / BM;
  occ_kernel<W><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = cudaSuccess).
// ptrs: em, w0T, b0, wskipT, trunk_wT, trunk_b, w8, b8, out.
// ints: n, width (128 or 256), ke (multiple of 16, <= 64), n_trunk, n_pre.
extern "C" int psnerf_fused_occ(void* const* ptrs, const int* ints,
                                void* stream) {
  OccParams p;
  p.em = static_cast<const __nv_bfloat16*>(ptrs[0]);
  p.w0T = static_cast<const __nv_bfloat16*>(ptrs[1]);
  p.b0 = static_cast<const float*>(ptrs[2]);
  p.wskipT = static_cast<const __nv_bfloat16*>(ptrs[3]);
  p.trunk_wT = static_cast<const __nv_bfloat16*>(ptrs[4]);
  p.trunk_b = static_cast<const float*>(ptrs[5]);
  p.w8 = static_cast<const float*>(ptrs[6]);
  p.b8 = static_cast<const float*>(ptrs[7]);
  p.out = static_cast<float*>(ptrs[8]);
  p.n = ints[0];
  const int width = ints[1];
  p.ke = ints[2];
  p.n_trunk = ints[3];
  p.n_pre = ints[4];
  if (p.n <= 0) return cudaSuccess;
  if (p.ke <= 0 || p.ke % 16 != 0 || p.ke > 64 || p.n_trunk < 1 ||
      p.n_pre < 0 || p.n_pre >= p.n_trunk)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 128: return launch<128>(p, s);
    case 256: return launch<256>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* psnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
