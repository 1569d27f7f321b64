// Fused per-(light, pixel) visibility MLP, and the same trunk followed by
// SG shading, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of psnerf_tpu/ops/fused_vis.py:
//   * fused_visibility (_vis_kernel over _accumulate_vis): raw, pre-clip
//     visibility [L, N] of the relu 8x256 trunk with a skip at layer 4
//     (mode RAW below);
//   * fused_vis_shade (_vis_shade_kernel): that trunk, then clip to [0, 1]
//     and the SG shading epilogue, as rgb [L, N, 3], [3, N, L] or the light
//     sum [N, 3] (modes LNC, CNL, SUM).
//
// What bounds it: the tensor cores, and about as much each SM's intake of
// weights. Each (light, pixel) pair runs seven dependent 256x256 bf16
// products (about 0.92 MFLOP); a 65,536-pixel x 96-light frame is 5.8 ms
// of them at 989 TFLOP/s, against well under 1 GB of inputs and outputs.
// But the ~0.9 MB trunk reaches an SM once for every 128 rows that share
// it: ~45 GB of L2 reads per such frame, ~6 ms at the ~7 TB/s the card's
// L2 delivers (tools/attribute_trunk.py measures both).
//
// Design (the engine of trunk_wgmma.cuh): a CTA owns 64 pixels and walks
// pixel tiles persistently; its two consumer warpgroups take the tile's
// lights in turn (warpgroup w the lights w, w + 2, ...), so each weight
// byte read from L2 serves 128 (pixel, light) rows, as the TPU kernel
// stacks light pairs along its rows. The light-independent halves of layer 0 and of the skip layer (A0 = em @ W0x, B5 = em @ W5x, A
// from the embedding tile in shared memory) are computed once per tile and
// kept in shared memory as f32, in the accumulator layout (each thread
// reads its own values, conflict-free). Each layer is wgmma m64nWk16 with A from
// registers; the relu epilogue writes the next layer's bf16 A fragments in
// registers. The last layer's dot with w8 is reduced in f32 from the relu
// output, without rounding it to bf16; the shading epilogue runs per
// (pixel, light) on the lanes that hold the row's sum. The light sum adds
// each warpgroup's lights in order, then warpgroup 0's partial and
// warpgroup 1's, so it is the same from run to run. Every output element
// has one writer. The relu epilogue is short, so the warpgroups share the
// ring without a ping-pong (the W = 256 ring, beside A0 and B5, holds less
// than one layer of slabs).
//
// Rounding points, as in the TPU kernel: activations are rounded to bf16
// before each trunk product; A0 + r0 and (acc + B5) + r5 are added in f32;
// the skip layer's bias lives in r5.

#include "trunk_wgmma.cuh"

using namespace trunk;

namespace {

constexpr int PIXW = 40;           // floats per pixel of shading inputs
constexpr int MAX_BASIS = 9;

// shading inputs, per pixel (row of `pix`):
//   0-2 normal, 3-5 view (= -ray dir), 6 v.n, 7 mask, 8-10 albedo,
//   11.. SG weights (nbasis, or 3*nbasis when specular_rgb)
constexpr int PIX_VN = 6, PIX_MASK = 7, PIX_ALB = 8, PIX_W = 11;

enum Mode { RAW = 0, LNC = 1, CNL = 2, SUM = 3 };

struct Params {
  const __nv_bfloat16* em;       // [N, ke] bf16 point embedding (zero-padded)
  const unsigned char* slabs;    // w0x | w5x | trunk, packed (ops/fused_vis.py)
  const float* r0;               // [L, W] layer-0 light rows + bias
  const float* r5;               // [L, W] skip-layer light rows + bias
  const float* trunk_b;          // [n_trunk, W] (skip row unused)
  const float* w8;               // [W] bf16-rounded output row
  const float* b8;               // [1] output bias (read on the device)
  const float* pix;              // [N, PIXW] shading inputs (shade modes)
  const float* ld;               // [L, 3] light dirs
  const float* lint;             // [L, 3] per-channel intensity
  float* out;
  float lobes[MAX_BASIS];
  int n, ke, n_lights, n_trunk, n_pre, nbasis, specular_rgb, ring;
};

// acc (the accumulator layout) <-> a [W/8 x 128] float4 tile in shared
// memory, element (j, thread) at j * 128 + thread
template <int W>
__device__ __forceinline__ void store_frag(float4* dst, const float (&acc)[W / 2]) {
  const int tw = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
    dst[j * 128 + tw] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                                    acc[4 * j + 3]);
}

// SG shading of one (pixel, light): rgb in [0, 1], 1.0 off the mask
__device__ __forceinline__ void shade(const Params& p, const float* px, int l,
                                      float raw, float (&rgb)[3]) {
  const float lx = __ldg(p.ld + l * 3), ly = __ldg(p.ld + l * 3 + 1),
              lz = __ldg(p.ld + l * 3 + 2);
  const float cosv = px[0] * lx + px[1] * ly + px[2] * lz;
  const float lv = px[3] * lx + px[4] * ly + px[5] * lz;
  const float vis = fminf(fmaxf(raw, 0.f), 1.f);
  // h.n = (l.n + v.n) / max(|l + v|, eps), |l + v|^2 = 2 + 2 l.v for unit
  // l, v; the clamps keep near-antipodal lights finite
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
    const float v = fminf(
        fmaxf((px[PIX_ALB + c] + s_c) * __ldg(p.lint + l * 3 + c) * cv, 0.f),
        1.f);
    rgb[c] = inside ? v : 1.f;
  }
}

template <int W, int MODE>
__global__ void __launch_bounds__(NTHREADS, 1) vis_kernel(const Params p) {
  constexpr int KS = W / 16;
  constexpr uint32_t SLAB = W * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kes = p.ke / 16;
  RingSpec rs;
  rs.ring = p.ring;
  rs.slab = SLAB;
  rs.slots = smem;
  float4* a0s = reinterpret_cast<float4*>(smem + (size_t)p.ring * SLAB);
  float4* b5s = a0s + (W / 8) * 128;
  unsigned char* emt = reinterpret_cast<unsigned char*>(b5s + (W / 8) * 128);
  float* pixs = reinterpret_cast<float*>(emt + kes * A_KSTEP);  // [ROWS][PIXW]
  float* tb = pixs + ROWS * PIXW;                               // [n_trunk][W]
  float* w8s = tb + (size_t)p.n_trunk * W;                      // [W]
  float* xsum = w8s + W;                                        // [ROWS][4]
  rs.full = reinterpret_cast<uint64_t*>(xsum + ROWS * 4);
  rs.empty = rs.full + MAX_RING;

  for (int i = threadIdx.x; i < p.n_trunk * W; i += NTHREADS) tb[i] = p.trunk_b[i];
  for (int i = threadIdx.x; i < W; i += NTHREADS) w8s[i] = p.w8[i];
  ring_init(rs);
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int N = p.n, L = p.n_lights;
  const int tiles = (N + ROWS - 1) / ROWS;
  const int pairs = (L + NCONS - 1) / NCONS;       // light turns per warpgroup

  if (wg == NCONS) {                       // producer
    set_max_regs_dec<24>();
    if ((threadIdx.x & 127) == 0) {
      Producer pr;
      pr.s = rs;
      pr.src = p.slabs;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        pr.stream(0, 2 * kes);
        for (int lp = 0; lp < pairs; ++lp) pr.stream(2 * kes, p.n_trunk * KS);
      }
    }
    return;
  }

  set_max_regs_inc<240>();
  Consumer c;
  c.s = rs;
  const int tc = threadIdx.x;                      // 0..255 over consumers
  const int tw = threadIdx.x & 127, t = threadIdx.x & 3;
  const int rl = row_lo() + (t == 1 ? 8 : 0);      // the row this lane shades
  const float b8 = __ldg(p.b8);
  float acc[W / 2];
  uint32_t a[KS][4];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    bar_sync(BAR_CONS, NCONS * 128);     // the previous tile is done with smem
    load_a_tile(emt, p.em, row0, N, p.ke, tc, NCONS * 128);
    if (MODE != RAW) {
      for (int idx = tc; idx < ROWS * PIXW; idx += NCONS * 128) {
        const int r = idx / PIXW;
        pixs[idx] = (row0 + r < N) ? p.pix[(size_t)row0 * PIXW + idx] : 0.f;
      }
    }
    fence_async_shared();
    bar_sync(BAR_CONS, NCONS * 128);

    // A0 and B5, the light-independent halves, once per tile
    c.product_smem<W>(acc, emt, kes, false);
    c.drain(acc);
    if (wg == 0) store_frag<W>(a0s, acc);
    c.product_smem<W>(acc, emt, kes, false);
    c.drain(acc);
    if (wg == 1) store_frag<W>(b5s, acc);
    bar_sync(BAR_CONS, NCONS * 128);

    float rgb_sum[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
    for (int lp = 0; lp < pairs; ++lp) {
      const int l_real = lp * NCONS + wg;
      const bool live = l_real < L;      // the last turn may have no light
      const int l = live ? l_real : L - 1;

      // layer 0: relu(A0 + r0[l]), rounded to bf16 for the first product
      const float* r0l = p.r0 + (size_t)l * W;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float4 v = a0s[j * 128 + tw];
        const float2 r = __ldg(reinterpret_cast<const float2*>(r0l + 8 * j + 2 * t));
        acc[4 * j + 0] = fmaxf(v.x + r.x, 0.f);
        acc[4 * j + 1] = fmaxf(v.y + r.y, 0.f);
        acc[4 * j + 2] = fmaxf(v.z + r.x, 0.f);
        acc[4 * j + 3] = fmaxf(v.w + r.y, 0.f);
      }
      to_afrag<W>(acc, a);

#pragma unroll 1
      for (int li = 0; li < p.n_trunk; ++li) {
        c.product<W>(acc, a, false);
        c.drain(acc);
        if (li == p.n_pre) {
          const float* r5l = p.r5 + (size_t)l * W;
#pragma unroll
          for (int j = 0; j < W / 8; ++j) {
            const float4 v = b5s[j * 128 + tw];
            const float2 r = __ldg(reinterpret_cast<const float2*>(r5l + 8 * j + 2 * t));
            acc[4 * j + 0] = fmaxf((acc[4 * j + 0] + v.x) + r.x, 0.f);
            acc[4 * j + 1] = fmaxf((acc[4 * j + 1] + v.y) + r.y, 0.f);
            acc[4 * j + 2] = fmaxf((acc[4 * j + 2] + v.z) + r.x, 0.f);
            acc[4 * j + 3] = fmaxf((acc[4 * j + 3] + v.w) + r.y, 0.f);
          }
        } else {
          const float* bias = tb + (size_t)li * W;
#pragma unroll
          for (int j = 0; j < W / 8; ++j) {
            const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
            acc[4 * j + 0] = fmaxf(acc[4 * j + 0] + b.x, 0.f);
            acc[4 * j + 1] = fmaxf(acc[4 * j + 1] + b.y, 0.f);
            acc[4 * j + 2] = fmaxf(acc[4 * j + 2] + b.x, 0.f);
            acc[4 * j + 3] = fmaxf(acc[4 * j + 3] + b.y, 0.f);
          }
        }
        if (li < p.n_trunk - 1) to_afrag<W>(acc, a);
      }

      float lo, hi;
      row_dot<W>(acc, w8s, lo, hi);
      const int n = row0 + rl;
      if (t < 2 && live && n < N) {
        const float raw = (t == 0 ? lo : hi) + b8;
        if (MODE == RAW) {
          p.out[(size_t)l * N + n] = raw;
        } else {
          float rgb[3];
          shade(p, pixs + rl * PIXW, l, raw, rgb);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            if (MODE == LNC) p.out[((size_t)l * N + n) * 3 + ch] = rgb[ch];
            if (MODE == CNL) p.out[((size_t)ch * N + n) * L + l] = rgb[ch];
            if (MODE == SUM) rgb_sum[ch] += rgb[ch];
          }
        }
      }
    }

    if (MODE == SUM) {                   // warpgroup 0's lights, then 1's
      if (wg == 1 && t < 2) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) xsum[rl * 4 + ch] = rgb_sum[ch];
      }
      bar_sync(BAR_CONS, NCONS * 128);
      const int n = row0 + rl;
      if (wg == 0 && t < 2 && n < N) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          p.out[(size_t)n * 3 + ch] = rgb_sum[ch] + xsum[rl * 4 + ch];
      }
    }
  }
}

template <int W, int MODE>
cudaError_t launch_mode(Params p, cudaStream_t stream) {
  const int kes = p.ke / 16;
  const size_t fixed = 2 * (size_t)ROWS * W * sizeof(float) +
                       (size_t)kes * A_KSTEP +
                       (size_t)ROWS * PIXW * sizeof(float) +
                       (size_t)(p.n_trunk + 1) * W * sizeof(float) +
                       (size_t)ROWS * 4 * sizeof(float);
  p.ring = ring_slots(fixed, (size_t)W * 32);
  if (p.ring < LAG + 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)p.ring * W * 32 + fixed +
                      2 * MAX_RING * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      vis_kernel<W, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.n + ROWS - 1) / ROWS;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  vis_kernel<W, MODE><<<grid, NTHREADS, smem, stream>>>(p);
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
// nbasis at most 9. slabs: w0x, w5x and the trunk packed as k-step slabs
// (trunk_wgmma.cuh). Shading pointers may be null in mode 0.
extern "C" int psnerf_fused_vis(
    int mode, int width, const void* em, int n, int ke, const void* slabs,
    const void* r0, const void* r5, int n_lights, const void* trunk_b,
    int n_trunk, int n_pre, const void* w8, const void* b8, const void* pix,
    const void* ld, const void* lint, const float* lobes, int nbasis,
    int specular_rgb, void* out, void* stream) {
  if (n <= 0 || n_lights <= 0) return cudaSuccess;
  if (ke <= 0 || ke % 16 != 0 || ke > width || nbasis < 0 ||
      nbasis > MAX_BASIS || n_trunk < 1 || n_pre < 0 || n_pre >= n_trunk)
    return cudaErrorInvalidValue;
  Params p;
  p.em = static_cast<const __nv_bfloat16*>(em);
  p.slabs = static_cast<const unsigned char*>(slabs);
  p.r0 = static_cast<const float*>(r0);
  p.r5 = static_cast<const float*>(r5);
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
