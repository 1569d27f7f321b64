// Fused occupancy-logit MLP for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel psnerf_tpu/ops/fused_occ.py
// (fused_occ_logit, kernel _occ_kernel): the raw occupancy logit of the
// weight-normed 8x256 geometry MLP (softplus(beta=100) with the linear
// cutover at 100 x > 20, one skip whose PE half is a row split), for every
// point of the stage-1 march.
//
// What bounds it: the epilogue's instructions, then the tensor cores. Per
// point the trunk runs seven dependent 256x256 bf16 products plus the two
// narrow embedding products (about 0.97 MFLOP: 0.51 ms at 524,288 points at
// 989 TFLOP/s), and eight softplus layers of 256 values. Each softplus is
// two special-function instructions (ex2, lg2) and about ten FP32 ones, so
// the epilogue's MUFU issue alone (16 lanes per SM) takes about as long as
// the products. Inputs and outputs are ~50 MB: memory is not the limit.
//
// Design (the engine of trunk_wgmma.cuh): a CTA owns 128 points, 64 per
// consumer warpgroup, and walks tiles of 128 points persistently. The
// producer streams the packed weights (layer 0's point rows, the trunk, the
// skip layer's PE rows after its trunk matrix) once per tile through the
// slab ring; every weight byte read from L2 serves 128 points. Each layer
// is wgmma m64nWk16 with A from registers; the softplus epilogue writes the
// next layer's bf16 A fragments in registers. The two consumer warpgroups
// take turns at the tensor cores (ping-pong), so one warpgroup's softplus
// runs under the other's products. The skip layer's PE half (em @ wskip,
// A from the embedding tile in shared memory) goes into the same
// accumulator after the trunk product. The softplus uses ex2.approx and
// lg2.approx: log1p(e^-|100 x|) = ln 2 * log2(1 + 2^(-|100 x| log2 e)),
// whose absolute error (~1e-7 before the /100) lies far below the bf16
// rounding of the activation that follows. The logit row w8 is dotted in
// f32 with the unrounded softplus output. Rows past N are loaded as zeros
// and never written; each output has one writer.

#include "trunk_wgmma.cuh"

using namespace trunk;

namespace {

struct OccParams {
  const __nv_bfloat16* em;       // [N, ke] point embedding (zero-padded)
  const unsigned char* slabs;    // w0 | trunk 0..n_pre | wskip | trunk rest
  const float* b0;               // [W]
  const float* trunk_b;          // [n_trunk, W]
  const float* w8;               // [W] bf16-rounded logit row
  const float* b8;               // [1] logit bias (read on the device)
  float* out;                    // [N] raw logits
  int n, ke, n_trunk, n_pre, ring;
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// softplus(100 x) / 100, linear where 100 x > 20
__device__ __forceinline__ float sp100(float x) {
  const float bx = 100.f * x;
  const float e = ex2_approx(fabsf(bx) * -1.4426950408889634f);
  const float l = lg2_approx(1.f + e) * 0.6931471805599453f;
  return bx > 20.f ? x : (fmaxf(bx, 0.f) + l) * 0.01f;
}

// y = sp100(acc + bias[col]) for the thread's accumulators
template <int W>
__device__ __forceinline__ void softplus_bias(float (&acc)[W / 2],
                                              const float* bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    acc[4 * j + 0] = sp100(acc[4 * j + 0] + b.x);
    acc[4 * j + 1] = sp100(acc[4 * j + 1] + b.y);
    acc[4 * j + 2] = sp100(acc[4 * j + 2] + b.x);
    acc[4 * j + 3] = sp100(acc[4 * j + 3] + b.y);
  }
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) occ_kernel(const OccParams p) {
  constexpr int KS = W / 16;
  constexpr uint32_t SLAB = W * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kes = p.ke / 16;
  RingSpec rs;
  rs.ring = p.ring;
  rs.slab = SLAB;
  rs.slots = smem;
  unsigned char* ems = smem + (size_t)p.ring * SLAB;          // [NCONS] A tiles
  float* bias = reinterpret_cast<float*>(ems + NCONS * kes * A_KSTEP);
  // bias: b0 [W], trunk_b [n_trunk, W], then w8 [W]
  float* w8s = bias + (size_t)(1 + p.n_trunk) * W;
  rs.full = reinterpret_cast<uint64_t*>(w8s + W);
  rs.empty = rs.full + MAX_RING;

  for (int i = threadIdx.x; i < W; i += NTHREADS) {
    bias[i] = p.b0[i];
    w8s[i] = p.w8[i];
  }
  for (int i = threadIdx.x; i < p.n_trunk * W; i += NTHREADS)
    bias[W + i] = p.trunk_b[i];
  ring_init(rs);
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int tiles = (p.n + NCONS * ROWS - 1) / (NCONS * ROWS);
  const int per_tile = 2 * kes + p.n_trunk * KS;

  if (wg == NCONS) {                       // producer
    set_max_regs_dec<24>();
    if ((threadIdx.x & 127) == 0) {
      Producer pr;
      pr.s = rs;
      pr.src = p.slabs;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        pr.stream(0, per_tile);
    }
    return;
  }

  set_max_regs_inc<240>();
  Consumer c;
  c.s = rs;
  const int my_tiles =
      (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  PingPong pp{wg, my_tiles * (1 + p.n_trunk)};
  pp.open();
  unsigned char* emt = ems + wg * kes * A_KSTEP;
  const float b8 = __ldg(p.b8);
  const int tw = threadIdx.x & 127, t = threadIdx.x & 3;
  float acc[W / 2];
  uint32_t a[KS][4];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * NCONS * ROWS + wg * ROWS;
    load_a_tile(emt, p.em, row0, p.n, p.ke, tw, 128);
    fence_async_shared();
    bar_sync(BAR_WG + wg, 128);

    pp.begin();
    c.product_smem<W>(acc, emt, kes, false);             // layer 0
    pp.end();
    c.drain(acc);
    softplus_bias<W>(acc, bias);
    to_afrag<W>(acc, a);

#pragma unroll 1
    for (int li = 0; li < p.n_trunk; ++li) {
      pp.begin();
      c.product<W>(acc, a, false);
      if (li == p.n_pre) c.product_smem<W>(acc, emt, kes, true);
      pp.end();
      c.drain(acc);
      softplus_bias<W>(acc, bias + (size_t)(1 + li) * W);
      if (li < p.n_trunk - 1) {
        to_afrag<W>(acc, a);
      } else {
        float lo, hi;
        row_dot<W>(acc, w8s, lo, hi);
        const int row = row0 + row_lo() + (t == 1 ? 8 : 0);
        if (t < 2 && row < p.n) p.out[row] = (t == 0 ? lo : hi) + b8;
      }
    }
  }
}

template <int W>
cudaError_t launch(OccParams p, cudaStream_t stream) {
  constexpr int KS = W / 16;
  const int kes = p.ke / 16;
  const size_t fixed = (size_t)NCONS * kes * A_KSTEP +
                       (size_t)(2 + p.n_trunk) * W * sizeof(float);
  p.ring = ring_slots(fixed, (size_t)W * 32);
  // the ping-pong needs a whole turn's slabs in the ring (R >= the skip
  // layer's KS + kes, plus the LAG in flight)
  if (p.ring < KS + kes + LAG) return cudaErrorInvalidValue;
  const size_t smem = (size_t)p.ring * W * 32 + fixed +
                      2 * MAX_RING * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      occ_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.n + NCONS * ROWS - 1) / (NCONS * ROWS);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  occ_kernel<W><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = cudaSuccess).
// ptrs: em, slabs, b0, trunk_b, w8, b8, out.
// ints: n, width (128 or 256), ke (multiple of 16, <= 64), n_trunk, n_pre.
extern "C" int psnerf_fused_occ(void* const* ptrs, const int* ints,
                                void* stream) {
  OccParams p;
  p.em = static_cast<const __nv_bfloat16*>(ptrs[0]);
  p.slabs = static_cast<const unsigned char*>(ptrs[1]);
  p.b0 = static_cast<const float*>(ptrs[2]);
  p.trunk_b = static_cast<const float*>(ptrs[3]);
  p.w8 = static_cast<const float*>(ptrs[4]);
  p.b8 = static_cast<const float*>(ptrs[5]);
  p.out = static_cast<float*>(ptrs[6]);
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
