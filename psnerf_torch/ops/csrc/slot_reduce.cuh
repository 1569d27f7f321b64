// The fixed-order slot reduction engine for Hopper (sm_90a), shared by
// fused_radiance.cu (the bf16 backward's CTA slots, psnerf_radiance_slot_sum)
// and fused_radiance_f32.cu (the f32 backward's split-K slots,
// psnerf_rf32_reduce):
//
//   out[i] = (((0 + in[0][i]) + in[1][i]) + ...) + in[S - 1][i]
//
// in slot order, so every run gives the same bits; in is [S, total] f32 and
// out [total], both 16-byte aligned, total a multiple of 4. It replaces the
// weight-gradient accumulation of the TPU kernel in
// psnerf_tpu/ops/fused_radiance.py (_bwd_kernel, :262-273; pallas_call at
// :410), which zeroes the gradient blocks at grid step 0 and adds each
// tile's sums in grid order (:24-25).
//
// What bounds it: bytes. Each slot byte is read once (S x total x 4 bytes
// in, total x 4 out), and one add per 4 bytes read is nothing to the FP32
// units. The work is float4 columns (an item: S 16-byte loads added in
// slot order, one 16-byte store), and what keeps device memory busy to the
// end, as measured on an H100 (PERF.md):
//   * every column its own thread in one resident wave: THREADS threads a
//     CTA at most 32 registers each, so PER_SM CTAs (64 warps) fit on an
//     SM and 270,336 columns go in one pass on 132 SMs. The grid is one CTA
//     per THREADS columns, at most the CTAs the card holds, striding over
//     the columns past that (both callers' slots, at most 206,274 columns,
//     fit one wave). The slot sum kernel this replaced held 44
//     registers, so 5 CTAs an SM, and left 37,000 of the bf16 slots'
//     206,273 columns to a second pass after the others had finished;
//   * the whole grid walks the slots in step, so each slot row is read
//     across its full width at about the same time;
//   * ROUND slots' loads issued before their adds (ptxas keeps as many in
//     flight as the 32 registers hold), then the remaining slots one by
//     one. (A predicated last round in place of that loop spilled under
//     the 32-register cap and ran several times slower.)
// A register ring refilled as each slot is added, on a persistent grid of
// a few CTAs per SM, and one producer thread's cp.async.bulk copies into a
// shared-memory ring under mbarriers were both measured slower (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slot_reduce {

constexpr int THREADS = 256;
constexpr int PER_SM = 8;    // CTAs an SM holds at 32 registers a thread
constexpr int ROUND = 16;    // slots' loads issued before their adds

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
}

// Thread g = blockIdx.x THREADS + threadIdx.x adds columns g, g + gridDim.x
// THREADS, ... below n, each over its slots in order, R loads a round.
template <int R>
__global__ void __launch_bounds__(THREADS, PER_SM)
    ordered_sum_kernel(const float4* __restrict__ in,
                       float4* __restrict__ out, long long n, int slots) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    int k = 0;
    for (; k + R <= slots; k += R) {
      float4 v[R];
#pragma unroll
      for (int u = 0; u < R; ++u)
        v[u] = __ldg(in + (size_t)(k + u) * n + i);
#pragma unroll
      for (int u = 0; u < R; ++u) add4(s, v[u]);
    }
    for (; k < slots; ++k) add4(s, __ldg(in + (size_t)k * n + i));
    out[i] = s;
  }
}

// Launches the engine on `stream`: out = the slots of in summed in order,
// on one CTA per THREADS columns, at most the CTAs the current device
// holds at once.
inline cudaError_t launch(const void* in, void* out, long long total,
                          int slots, cudaStream_t stream) {
  if (total <= 0) return cudaSuccess;
  if (slots < 1 || total % 4 || reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n = total / 4;
  long long grid = (n + THREADS - 1) / THREADS;
  if (grid > (long long)sms * PER_SM) grid = (long long)sms * PER_SM;
  ordered_sum_kernel<ROUND><<<(unsigned)grid, THREADS, 0, stream>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out), n, slots);
  return cudaGetLastError();
}

}  // namespace slot_reduce
