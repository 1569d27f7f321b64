// Fused radiance+alpha, forward and second-order backward, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of psnerf_tpu/ops/fused_radiance.py
// (fused_radiance_and_alpha) in their bf16-operand form (wdt = bf16; the
// f32 form is fused_radiance_f32.cu):
//   * forward (_fwd_kernel over _forward_core): geometry trunk -> feature
//     and logit (split head), reverse sweep g_e = d logit / d emb, normals
//     n = (d emb / d x)^T g_e, ReLU appearance MLP -> pre-tanh rgb;
//   * backward (_bwd_kernel): recompute with the saved g_e, appearance
//     backward, tangent forward of the normal path, and one doubled reverse
//     sweep carrying (h_bar, t_bar) through softplus'' = 100 s (1 - s);
//     weight gradients only.
//
// What bounds it: operations. Per point the forward runs ~19 and the
// backward ~57 products of 2 W^2 FLOPs (W = 256): ~2.6 and ~7.7 MFLOP,
// against a few hundred bytes of inputs per point.
//
// Design. One CTA of 8 warps owns a tile of points; a persistent grid (one
// CTA per SM) loops over the tiles. Each product runs mma.sync over an
// operand tile in shared memory, with the weight fragments read from
// global memory (L2-resident); each warp owns W/8 output columns
// (mma_tile.cuh). The per-layer f32 values the sweeps need again (sigmoid
// s, tangents tz, h_bar) and the operands of the weight gradients (trunk
// and appearance activations, tangents) do not fit in shared memory (eight
// layers of s alone are 512 KB per 64-point tile): each CTA keeps them in
// its own slot of device memory, in the fragment layout, so every thread
// reads back exactly the values it wrote (coalesced, no synchronisation;
// the slots of all CTAs are a few hundred MB, mostly L2 traffic). They
// stay f32 where the TPU kernel keeps them f32.
//
// Weight gradients x^T y (a reduction over points) run as mma.sync over
// transposed [feature][point] tiles in shared memory (the trunk's two
// terms a^T z_bar + t^T tz_bar as one product of depth 2 x tile).
// Bias-like gradients are column sums (a shuffle over the fragment's rows).
// Every CTA adds its tiles' sums into its own zeroed f32 slot of the
// gradients (slot blockIdx.x, the gradients' concatenation in the packed
// order, each at a multiple of 4 floats, so a thread's two adjacent
// columns go as one float2 reduction). The sums come out the same on every
// run: the persistent grid gives each CTA the same tiles in the same
// order, and inside a CTA each gradient element has exactly one owning
// thread (the g == 0 lane of colsum_atomic's shuffle, the fragment's own
// elements in dtn_atomic, tid in the rgb head's sums), whose atomicAdds to
// one address take effect in program order. The slot reduction engine
// (slot_reduce.cuh, psnerf_radiance_slot_sum) then adds the slots in a
// fixed order (slot 0, then 1, ...), as the TPU kernel adds its tiles over
// a sequential grid. The slots (132 x 3.3 MB at W = 256) do not fit in L2,
// so each tile's sums go to device memory and back: the cost of
// determinism here.
//
// Rounding points as in the TPU kernel at wdt = bf16: every product's
// operands are bf16; accumulation, biases, softplus, sigmoid and the
// sweeps' elementwise work are f32; the logit row w8l and the normals' and
// position rows of appearance layer 0 (wn, wp) are f32. Tiles of 64
// points; bf16 m16n8k16. The kernels are templated on the operand type T
// (instantiated at bf16 only).
//
// ptxas reports registers, spills and shared memory per instantiation
// into ops/_build/fused_radiance.ptxas.txt.

#include "mma_tile.cuh"
#include "slot_reduce.cuh"

using namespace psnerf;

namespace {

constexpr int ROWF = 16;             // per-point f32 values in shared memory
// ROWF slots: 0-2 p, 3 logit (fwd) / g_logit (bwd), 4-6 n, 7-9 g_n,
// 10-12 g_rgb
constexpr int RF_P = 0, RF_L = 3, RF_N = 4, RF_GN = 7, RF_GRGB = 10;
// scratch buffers per slot (each TBM * W values in the fragment layout):
// f32 buffers, then operand-type buffers
constexpr int F_SP = 0, F_TZ = 8, F_HB = 16, N_F32_BWD = 17, N_F32_FWD = 8;
constexpr int H_A = 0, H_T = 8, H_AA = 15, H_FEAT = 19, H_TZB = 20,
              N_OP_BWD = 21;

typedef __nv_bfloat16 bf16;

// Tile shape of one operand form.
template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int BM = psnerf::BM;      // 64 points
  static constexpr int LDK = 64 + 8;         // narrow tiles (ke, kv <= 64)
  static constexpr int LDT = 2 * BM + 8;     // transposed [feature][point]
};

template <typename T>
struct RadParams {
  const T* em; const float* de; const T* vpe; const float* p3;
  const float* g_e_in; const float* g_out;
  const T *w0T, *w0; const float* b0;
  const T *wskipT, *wskip;
  const T *trunkT, *trunk; const float* trunk_b;
  const T *w8fT, *w8f; const float *b8f, *w8l, *b8l, *wp, *wn;
  const T *wvT, *wfT, *wf; const float* ba0;
  const T *waT, *wa; const float* bab;
  const T *wa4T, *wa4; const float* ba4;
  float* out; float* g_e;
  float *d_w0, *d_b0, *d_wskip, *d_trunk_w, *d_trunk_b, *d_w8f, *d_b8f,
      *d_w8l, *d_b8l, *d_wp, *d_wv, *d_wn, *d_wf, *d_ba0, *d_wa, *d_bab,
      *d_wa4, *d_ba4;
  unsigned char* scratch;
  int n, ke, kv, n_trunk, skip_pos;
  long long slot_floats;      // backward: floats in one CTA's gradient slot
};

__device__ __forceinline__ void sp_sig(float x, float& sp, float& sg) {
  const float bx = 100.f * x;
  const float e = expf(-fabsf(bx));
  sp = (fmaxf(bx, 0.f) + log1pf(e)) / 100.f;
  const float inv = 1.f / (1.f + e);
  sg = bx >= 0.f ? inv : e * inv;
}

// x rounded to the operand type and back (exact for T = float)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Operand<T>::to_f(Operand<T>::from_f(x));
}

// thread-private scratch: element q of this thread's fragment
__device__ __forceinline__ size_t sq(int q) {
  return (size_t)q * NTHREADS + threadIdx.x;
}

template <int NT>
__device__ __forceinline__ int fq(int i, int j, int r) {
  return (i * NT + j) * 4 + r;
}

// xT[col][koff + row] = operand(v): the tile transposed to [feature][point]
template <typename T, int MI, int NT>
__device__ __forceinline__ void put_T(T* xT, int koff,
                                      const float (&v)[MI][NT][4], int n_base) {
  constexpr int LDT = Tile<T>::LDT;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xT[frag_col(n_base, j, r) * LDT + koff + frag_row(i, r)] =
            Operand<T>::from_f(v[i][j][r]);
}

// the same from an operand-type scratch buffer (exact)
template <typename T, int MI, int NT>
__device__ __forceinline__ void put_T_scr(T* xT, int koff, const T* buf,
                                          int n_base) {
  constexpr int LDT = Tile<T>::LDT;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xT[frag_col(n_base, j, r) * LDT + koff + frag_row(i, r)] =
            buf[sq(fq<NT>(i, j, r))];
}

// dst[0:2] += (a, b) as one vector reduction (sm_90; dst 8-byte aligned:
// every leaf starts at a multiple of 4 floats of its slot). Each element's
// adds keep their order: one owning thread, in program order.
__device__ __forceinline__ void add2(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}

// dst[col] += sum over the tile's rows of rw[row] * v (rw null: 1)
template <int MI, int NT>
__device__ __forceinline__ void colsum_atomic(float* dst,
                                              const float (&v)[MI][NT][4],
                                              int n_base, const float* rw) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float s[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[e] = 0.f;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = v[i][j][2 * h + e];
          s[e] += rw ? rw[frag_row(i, 2 * h) * ROWF] * x : x;
        }
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], 4);
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], 8);
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], 16);
    }
    if (g == 0) add2(dst + frag_col(n_base, j, 0), s[0], s[1]);
  }
}

// dst[a_rows, W] += xT[0:a_rows, 0:K] @ yT[0:W, 0:K]^T (a reduction over
// K points, both tiles transposed in shared memory)
template <typename T, int W>
__device__ __forceinline__ void dtn_atomic(const T* xT, int a_rows,
                                           const T* yT, int K, float* dst,
                                           int n_base) {
  constexpr int NT = W / 64, TBM = Tile<T>::BM, MI = TBM / 16;
  constexpr int LDT = Tile<T>::LDT;
  for (int mc = 0; mc < a_rows; mc += TBM) {
    float acc[MI][NT][4];
    warp_gemm<NT, false, MI>(xT + mc * LDT, LDT, K, yT, LDT, n_base, acc,
                             true);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {      // the fragment's two rows
          const int row = mc + frag_row(i, 2 * h);
          if (row < a_rows)
            add2(dst + (size_t)row * W + frag_col(n_base, j, 0),
                 acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  }
}

// [rows, cols] rows of a [N, cols] input into a shared tile (zeros past N)
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          int cols, int rows, int row0,
                                          int n) {
  const int kw = cols / 2;
  for (int idx = threadIdx.x; idx < rows * kw; idx += NTHREADS) {
    const int r = idx / kw, c = (idx % kw) * 2;
    uint32_t v = 0;
    if (row0 + r < n) v = ldg_u32(src + (size_t)(row0 + r) * cols + c);
    *reinterpret_cast<uint32_t*>(dst + r * ld + c) = v;
  }
}

// the geometry trunk's forward over the tile in ems; leaves a_last (f32)
// in acc and operand(a_last) in act. Stores s per layer (f32 scratch) and,
// with abuf, every activation (operand scratch). With rw_last, adds
// sum_rows rw * a_last into d_w8l.
template <typename T, int W>
__device__ __forceinline__ void trunk_forward(
    const RadParams<T>& p, T* act, const T* ems,
    float (&acc)[Tile<T>::BM / 16][W / 64][4], float* spbuf, T* abuf,
    const float* rw_last, int n_base) {
  constexpr int NT = W / 64, LDA = W + Operand<T>::PAD;
  constexpr int MI = Tile<T>::BM / 16, LDK = Tile<T>::LDK;
  constexpr size_t TILE = (size_t)Tile<T>::BM * W;
  for (int li = 0; li <= p.n_trunk; ++li) {
    if (li == 0) {
      warp_gemm<NT, true, MI>(ems, LDK, p.ke, p.w0T, p.ke, n_base, acc, true);
    } else {
      warp_gemm<NT, true, MI>(act, LDA, W, p.trunkT + (size_t)(li - 1) * W * W,
                              W, n_base, acc, true);
      if (li - 1 == p.skip_pos)
        warp_gemm<NT, true, MI>(ems, LDK, p.ke, p.wskipT, p.ke, n_base, acc,
                                false);
    }
    __syncthreads();                 // every warp has finished reading act
    const float* bias = li == 0 ? p.b0 : p.trunk_b + (size_t)(li - 1) * W;
    float* sp_l = spbuf + li * TILE;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float s, sg;
          sp_sig(acc[i][j][r] + __ldg(bias + frag_col(n_base, j, r)), s, sg);
          acc[i][j][r] = s;
          sp_l[sq(fq<NT>(i, j, r))] = sg;
          if (abuf)
            abuf[li * TILE + sq(fq<NT>(i, j, r))] = Operand<T>::from_f(s);
        }
    put_act<NT, MI>(act, LDA, acc, n_base);
    if (li == p.n_trunk && rw_last)
      colsum_atomic<MI, NT>(p.d_w8l, acc, n_base, rw_last);
    __syncthreads();
  }
}

// n[row][j] = sum over columns c % 3 == j of g_e[row][c] * de[row][c]
template <typename T>
__device__ __forceinline__ void normals(const RadParams<T>& p, const float* ge,
                                        int ldg, float* rowf, int row0) {
  const int tid = threadIdx.x;
  if (tid < Tile<T>::BM * 3) {
    const int row = tid / 3, j = tid % 3;
    float s = 0.f;
    if (row0 + row < p.n) {
      const float* de = p.de + (size_t)(row0 + row) * p.ke;
      for (int c = j; c < p.ke; c += 3) s += ge[row * ldg + c] * __ldg(de + c);
    }
    rowf[row * ROWF + RF_N + j] = s;
  }
}

// appearance layer 0 epilogue: relu(acc + ba0 + sum_j p_j wp[j] + n_j wn[j])
template <typename T, int W>
__device__ __forceinline__ void app0_epilogue(
    const RadParams<T>& p, float (&acc)[Tile<T>::BM / 16][W / 64][4],
    const float* rowf, int n_base) {
  constexpr int NT = W / 64, MI = Tile<T>::BM / 16;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = frag_row(i, r), col = frag_col(n_base, j, r);
        float z = acc[i][j][r] + __ldg(p.ba0 + col);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          z = z + rowf[row * ROWF + RF_P + c] * __ldg(p.wp + c * W + col);
          z = z + rowf[row * ROWF + RF_N + c] * __ldg(p.wn + c * W + col);
        }
        acc[i][j][r] = fmaxf(z, 0.f);
      }
}

// ------------------------------------------------------------- forward

template <typename T, int W>
__global__ void __launch_bounds__(NTHREADS, 1)
    rad_fwd_kernel(const RadParams<T> p) {
  constexpr int NT = W / 64, LDA = W + Operand<T>::PAD;
  constexpr int TBM = Tile<T>::BM, MI = TBM / 16, LDK = Tile<T>::LDK;
  constexpr size_t TILE = (size_t)TBM * W;
  extern __shared__ __align__(16) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);                     // [TBM][LDA]
  T* feats = act + TBM * LDA;                              // [TBM][LDA]
  T* ems = feats + TBM * LDA;                              // [TBM][LDK]
  T* vps = ems + TBM * LDK;                                // [TBM][LDK]
  float* ges = reinterpret_cast<float*>(vps + TBM * LDK);  // [TBM][LDK]
  float* rowf = ges + TBM * LDK;                           // [TBM][ROWF]
  float* red = rowf + TBM * ROWF;                          // [NWARPS][TBM]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_base = warp * (W / NWARPS);
  const int n_tiles = (p.n + TBM - 1) / TBM;
  float* spbuf = reinterpret_cast<float*>(p.scratch) +
                 (size_t)blockIdx.x * N_F32_FWD * TILE;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TBM;
    load_rows(ems, LDK, p.em, p.ke, TBM, row0, p.n);
    load_rows(vps, LDK, p.vpe, p.kv, TBM, row0, p.n);
    for (int idx = tid; idx < TBM * 3; idx += NTHREADS) {
      const int r = idx / 3, c = idx % 3;
      rowf[r * ROWF + RF_P + c] =
          row0 + r < p.n ? __ldg(p.p3 + (size_t)(row0 + r) * 3 + c) : 0.f;
    }
    __syncthreads();

    float acc[MI][NT][4];
    trunk_forward<T, W>(p, act, ems, acc, spbuf, nullptr, nullptr, n_base);
    rowsum_partial<NT, MI>(acc, p.w8l, n_base, red);
    __syncthreads();
    if (tid < TBM) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[w * TBM + tid];
      rowf[tid * ROWF + RF_L] = s + __ldg(p.b8l);
    }
    // feature head: feat = a_last @ w8f + b8f
    warp_gemm<NT, true, MI>(act, LDA, W, p.w8fT, W, n_base, acc, true);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] += __ldg(p.b8f + frag_col(n_base, j, r));
    put_act<NT, MI>(feats, LDA, acc, n_base);
    __syncthreads();

    // reverse sweep: g = d logit / d a, from g = w8l down to the embedding
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] = __ldg(p.w8l + frag_col(n_base, j, r));
    const bool owns_e = warp * 8 < p.ke;       // warps holding g_e columns
    float ge_skip[MI][1][4];
    for (int li = p.n_trunk; li >= 0; --li) {
      const float* sp_l = spbuf + li * TILE;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] *= sp_l[sq(fq<NT>(i, j, r))];
      put_act<NT, MI>(act, LDA, acc, n_base);
      __syncthreads();
      if (li == 0) break;
      if (li == p.skip_pos + 1 && owns_e)
        warp_gemm<1, true, MI>(act, LDA, W, p.wskip, W, warp * 8, ge_skip,
                               true);
      warp_gemm<NT, true, MI>(act, LDA, W, p.trunk + (size_t)(li - 1) * W * W,
                              W, n_base, acc, true);
      __syncthreads();
    }
    // g_e = (g s0) @ w0^T + gz_skip @ wskip^T
    if (owns_e) {
      float ge[MI][1][4];
      warp_gemm<1, true, MI>(act, LDA, W, p.w0, W, warp * 8, ge, true);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = frag_row(i, r), col = frag_col(warp * 8, 0, r);
          const float v = ge[i][0][r] + ge_skip[i][0][r];
          ges[row * LDK + col] = v;
          if (row0 + row < p.n) p.g_e[(size_t)(row0 + row) * p.ke + col] = v;
        }
    }
    __syncthreads();
    normals(p, ges, LDK, rowf, row0);
    __syncthreads();

    // appearance: relu layers on [p, view PE, n, feat] -> pre-tanh rgb
    warp_gemm<NT, true, MI>(vps, LDK, p.kv, p.wvT, p.kv, n_base, acc, true);
    warp_gemm<NT, true, MI>(feats, LDA, W, p.wfT, W, n_base, acc, false);
    app0_epilogue<T, W>(p, acc, rowf, n_base);
    put_act<NT, MI>(act, LDA, acc, n_base);
    __syncthreads();
    for (int jl = 0; jl < 3; ++jl) {
      warp_gemm<NT, true, MI>(act, LDA, W, p.waT + (size_t)jl * W * W, W,
                              n_base, acc, true);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[i][j][r] = fmaxf(
                acc[i][j][r] + __ldg(p.bab + jl * W + frag_col(n_base, j, r)),
                0.f);
      put_act<NT, MI>(act, LDA, acc, n_base);
      __syncthreads();
    }
    if (warp == 0) {
      float rgb[MI][1][4];
      warp_gemm<1, true, MI>(act, LDA, W, p.wa4T, W, 0, rgb, true);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = frag_row(i, r), col = frag_col(0, 0, r);
          if (col < 3 && row0 + row < p.n)
            p.out[(size_t)(row0 + row) * 4 + col] = rgb[i][0][r] + __ldg(p.ba4 + col);
        }
    }
    if (tid < TBM && row0 + tid < p.n)
      p.out[(size_t)(row0 + tid) * 4 + 3] = rowf[tid * ROWF + RF_L];
    __syncthreads();
  }
}

// ------------------------------------------------------------ backward

template <typename T, int W>
__global__ void __launch_bounds__(NTHREADS, 1)
    rad_bwd_kernel(const RadParams<T> slot0) {
  // the gradient pointers of this CTA's own slot
  RadParams<T> p = slot0;
  const size_t so = (size_t)blockIdx.x * slot0.slot_floats;
  p.d_w0 += so; p.d_b0 += so; p.d_wskip += so; p.d_trunk_w += so;
  p.d_trunk_b += so; p.d_w8f += so; p.d_b8f += so; p.d_w8l += so;
  p.d_b8l += so; p.d_wp += so; p.d_wv += so; p.d_wn += so; p.d_wf += so;
  p.d_ba0 += so; p.d_wa += so; p.d_bab += so; p.d_wa4 += so; p.d_ba4 += so;
  typedef Operand<T> Op;
  constexpr int NT = W / 64, LDA = W + Op::PAD;
  constexpr int TBM = Tile<T>::BM, MI = TBM / 16;
  constexpr int LDK = Tile<T>::LDK, LDT = Tile<T>::LDT;
  constexpr size_t TILE = (size_t)TBM * W;
  extern __shared__ __align__(16) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);                     // [TBM][LDA]
  T* ems = act + TBM * LDA;                                // [TBM][LDK]
  T* ces = ems + TBM * LDK;                                // [TBM][LDK]
  T* vps = ces + TBM * LDK;                                // [TBM][LDK]
  T* xT = vps + TBM * LDK;                                 // [W][LDT]
  T* yT = xT + W * LDT;                                    // [W][LDT]
  float* rowf = reinterpret_cast<float*>(yT + W * LDT);    // [TBM][ROWF]
  float* red = rowf + TBM * ROWF;                          // [3][NWARPS][TBM]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_base = warp * (W / NWARPS);
  const int n_tiles = (p.n + TBM - 1) / TBM;
  const size_t slot_bytes = N_F32_BWD * TILE * 4 + N_OP_BWD * TILE * sizeof(T);
  float* fbuf = reinterpret_cast<float*>(p.scratch + blockIdx.x * slot_bytes);
  T* hbuf = reinterpret_cast<T*>(fbuf + N_F32_BWD * TILE);
  float* spbuf = fbuf + F_SP * TILE;
  float* tzbuf = fbuf + F_TZ * TILE;
  float* hb = fbuf + F_HB * TILE;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TBM;
    load_rows(ems, LDK, p.em, p.ke, TBM, row0, p.n);
    load_rows(vps, LDK, p.vpe, p.kv, TBM, row0, p.n);
    for (int idx = tid; idx < TBM * 4; idx += NTHREADS) {
      const int r = idx / 4, c = idx % 4;
      const bool in = row0 + r < p.n;
      if (c < 3)
        rowf[r * ROWF + RF_P + c] =
            in ? __ldg(p.p3 + (size_t)(row0 + r) * 3 + c) : 0.f;
      rowf[r * ROWF + (c < 3 ? RF_GRGB + c : RF_L)] =
          in ? __ldg(p.g_out + (size_t)(row0 + r) * 4 + c) : 0.f;
    }
    __syncthreads();

    // ---- forward recompute (the reverse sweep's g_e is an input)
    float acc[MI][NT][4];
    trunk_forward<T, W>(p, act, ems, acc, spbuf, hbuf + H_A * TILE,
                        rowf + RF_L, n_base);
    warp_gemm<NT, true, MI>(act, LDA, W, p.w8fT, W, n_base, acc, true);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[i][j][r] += __ldg(p.b8f + frag_col(n_base, j, r));
          hbuf[H_FEAT * TILE + sq(fq<NT>(i, j, r))] = Op::from_f(acc[i][j][r]);
        }
    put_act<NT, MI>(act, LDA, acc, n_base);
    if (tid < TBM * 3) {
      // n from the saved g_e, in the forward's summation order
      const int row = tid / 3, j = tid % 3;
      float s = 0.f;
      if (row0 + row < p.n) {
        const float* ge = p.g_e_in + (size_t)(row0 + row) * p.ke;
        const float* de = p.de + (size_t)(row0 + row) * p.ke;
        for (int c = j; c < p.ke; c += 3) s += __ldg(ge + c) * __ldg(de + c);
      }
      rowf[row * ROWF + RF_N + j] = s;
    }
    __syncthreads();
    warp_gemm<NT, true, MI>(vps, LDK, p.kv, p.wvT, p.kv, n_base, acc, true);
    warp_gemm<NT, true, MI>(act, LDA, W, p.wfT, W, n_base, acc, false);
    __syncthreads();
    app0_epilogue<T, W>(p, acc, rowf, n_base);
    for (int jl = 0; jl <= 3; ++jl) {
      // acc holds aa[jl]
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            hbuf[(H_AA + jl) * TILE + sq(fq<NT>(i, j, r))] =
                Op::from_f(acc[i][j][r]);
      put_act<NT, MI>(act, LDA, acc, n_base);
      __syncthreads();
      if (jl == 3) break;
      warp_gemm<NT, true, MI>(act, LDA, W, p.waT + (size_t)jl * W * W, W,
                              n_base, acc, true);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[i][j][r] = fmaxf(
                acc[i][j][r] + __ldg(p.bab + jl * W + frag_col(n_base, j, r)),
                0.f);
    }

    // ---- appearance backward
    // d_wa4 = aa3^T g_rgb and d_ba4 on the CUDA cores (3 output columns)
    if (tid < W) {
      float s[3] = {0.f, 0.f, 0.f};
      for (int row = 0; row < TBM; ++row) {
        const float a = Op::to_f(act[row * LDA + tid]);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          s[c] += a * rnd<T>(rowf[row * ROWF + RF_GRGB + c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(p.d_wa4 + tid * 3 + c, s[c]);
    }
    if (tid < 3) {
      float s = 0.f;
      for (int row = 0; row < TBM; ++row) s += rowf[row * ROWF + RF_GRGB + tid];
      atomicAdd(p.d_ba4 + tid, s);
    }
    if (tid == 3) {
      float s = 0.f;
      for (int row = 0; row < TBM; ++row) s += rowf[row * ROWF + RF_L];
      atomicAdd(p.d_b8l, s);
    }
    // gz = operand(g_rgb) @ wa4^T
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = frag_row(i, r), col = frag_col(n_base, j, r);
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            s += rnd<T>(rowf[row * ROWF + RF_GRGB + c]) *
                 Op::to_f(p.wa4[col * 3 + c]);
          acc[i][j][r] = s;
        }
    __syncthreads();                 // act (aa3) is read; free to overwrite
    for (int jl = 2; jl >= 0; --jl) {
      const T* aa_next = hbuf + (H_AA + jl + 1) * TILE;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (!(Op::to_f(aa_next[sq(fq<NT>(i, j, r))]) > 0.f))
              acc[i][j][r] = 0.f;
      put_T<T, MI, NT>(yT, 0, acc, n_base);
      put_T_scr<T, MI, NT>(xT, 0, hbuf + (H_AA + jl) * TILE, n_base);
      colsum_atomic<MI, NT>(p.d_bab + jl * W, acc, n_base, nullptr);
      put_act<NT, MI>(act, LDA, acc, n_base);
      __syncthreads();
      dtn_atomic<T, W>(xT, W, yT, TBM, p.d_wa + (size_t)jl * W * W, n_base);
      warp_gemm<NT, true, MI>(act, LDA, W, p.wa + (size_t)jl * W * W, W,
                              n_base, acc, true);
      __syncthreads();
    }
    {
      const T* aa0 = hbuf + H_AA * TILE;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (!(Op::to_f(aa0[sq(fq<NT>(i, j, r))]) > 0.f))
              acc[i][j][r] = 0.f;
    }
    // gz is appearance layer 0's z_bar: d_wf, d_wv, d_ba0, d_wp, d_wn, g_n
    put_T<T, MI, NT>(yT, 0, acc, n_base);
    put_T_scr<T, MI, NT>(xT, 0, hbuf + H_FEAT * TILE, n_base);
    colsum_atomic<MI, NT>(p.d_ba0, acc, n_base, nullptr);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      colsum_atomic<MI, NT>(p.d_wp + c * W, acc, n_base, rowf + RF_P + c);
      colsum_atomic<MI, NT>(p.d_wn + c * W, acc, n_base, rowf + RF_N + c);
      rowsum_partial<NT, MI>(acc, p.wn + c * W, n_base,
                             red + c * NWARPS * TBM);
    }
    put_act<NT, MI>(act, LDA, acc, n_base);
    __syncthreads();
    if (tid < TBM * 3) {
      const int row = tid / 3, c = tid % 3;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[(c * NWARPS + w) * TBM + row];
      rowf[row * ROWF + RF_GN + c] = s;
    }
    dtn_atomic<T, W>(xT, W, yT, TBM, p.d_wf, n_base);
    __syncthreads();
    for (int idx = tid; idx < TBM * p.kv; idx += NTHREADS) {
      const int c = idx / TBM, row = idx % TBM;
      xT[c * LDT + row] = vps[row * LDK + c];
    }
    __syncthreads();
    dtn_atomic<T, W>(xT, p.kv, yT, TBM, p.d_wv, n_base);
    // g_feat = operand(gz) @ wf^T
    warp_gemm<NT, true, MI>(act, LDA, W, p.wf, W, n_base, acc, true);
    __syncthreads();

    // ---- first-order seeds through the split geometry head
    put_T<T, MI, NT>(yT, 0, acc, n_base);
    put_T_scr<T, MI, NT>(xT, 0, hbuf + (H_A + p.n_trunk) * TILE, n_base);
    colsum_atomic<MI, NT>(p.d_b8f, acc, n_base, nullptr);
    put_act<NT, MI>(act, LDA, acc, n_base);
    __syncthreads();
    dtn_atomic<T, W>(xT, W, yT, TBM, p.d_w8f, n_base);
    // h_bar = operand(g_feat) @ w8f^T + g_logit w8l
    warp_gemm<NT, true, MI>(act, LDA, W, p.w8f, W, n_base, acc, true);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          hb[sq(fq<NT>(i, j, r))] =
              acc[i][j][r] + rowf[frag_row(i, r) * ROWF + RF_L] *
                                 __ldg(p.w8l + frag_col(n_base, j, r));
    __syncthreads();

    // ---- tangent forward of the normal path: c_e = de * g_n[c % 3]
    for (int idx = tid; idx < TBM * p.ke; idx += NTHREADS) {
      const int row = idx / p.ke, c = idx % p.ke;
      const float v = row0 + row < p.n
                          ? __ldg(p.de + (size_t)(row0 + row) * p.ke + c) *
                                rowf[row * ROWF + RF_GN + c % 3]
                          : 0.f;
      ces[row * LDK + c] = Op::from_f(v);
    }
    __syncthreads();
    for (int li = 0; li <= p.n_trunk; ++li) {
      if (li == 0) {
        warp_gemm<NT, true, MI>(ces, LDK, p.ke, p.w0T, p.ke, n_base, acc,
                                true);
      } else {
        warp_gemm<NT, true, MI>(act, LDA, W,
                                p.trunkT + (size_t)(li - 1) * W * W, W,
                                n_base, acc, true);
        if (li - 1 == p.skip_pos)
          warp_gemm<NT, true, MI>(ces, LDK, p.ke, p.wskipT, p.ke, n_base,
                                  acc, false);
      }
      __syncthreads();
      const float* sp_l = spbuf + li * TILE;
      float* tz_l = tzbuf + li * TILE;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int q = fq<NT>(i, j, r);
            tz_l[sq(q)] = acc[i][j][r];
            acc[i][j][r] *= sp_l[sq(q)];
            if (li < p.n_trunk)
              hbuf[(H_T + li) * TILE + sq(q)] = Op::from_f(acc[i][j][r]);
          }
      if (li < p.n_trunk) {
        put_act<NT, MI>(act, LDA, acc, n_base);
      } else {
        colsum_atomic<MI, NT>(p.d_w8l, acc, n_base, nullptr);
      }
      __syncthreads();
    }

    // ---- doubled reverse sweep: (h_bar, t_bar) through s and s'
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] = __ldg(p.w8l + frag_col(n_base, j, r));   // t_bar
    for (int li = p.n_trunk; li >= 0; --li) {
      const float* sp_l = spbuf + li * TILE;
      const float* tz_l = tzbuf + li * TILE;
      // z_bar = h_bar s + t_bar s'' tz -> act, yT[:, 0:TBM]
      // tz_bar = t_bar s               -> scratch, yT[:, TBM:2 TBM]
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int q = fq<NT>(i, j, r);
            const float s = sp_l[sq(q)];
            const float tb = acc[i][j][r];
            const float zb = hb[sq(q)] * s + tb * (100.f * s * (1.f - s)) * tz_l[sq(q)];
            const float tzb = tb * s;
            const int row = frag_row(i, r), col = frag_col(n_base, j, r);
            yT[col * LDT + row] = Op::from_f(zb);
            yT[col * LDT + TBM + row] = Op::from_f(tzb);
            hbuf[H_TZB * TILE + sq(q)] = Op::from_f(tzb);
            acc[i][j][r] = zb;
          }
      colsum_atomic<MI, NT>(
          li == 0 ? p.d_b0 : p.d_trunk_b + (size_t)(li - 1) * W, acc, n_base,
          nullptr);
      if (li == 0) {
        for (int idx = tid; idx < TBM * p.ke; idx += NTHREADS) {
          const int c = idx / TBM, row = idx % TBM;
          xT[c * LDT + row] = ems[row * LDK + c];
          xT[c * LDT + TBM + row] = ces[row * LDK + c];
        }
        __syncthreads();
        dtn_atomic<T, W>(xT, p.ke, yT, 2 * TBM, p.d_w0, n_base);
        break;
      }
      put_act<NT, MI>(act, LDA, acc, n_base);
      put_T_scr<T, MI, NT>(xT, 0, hbuf + (H_A + li - 1) * TILE, n_base);
      put_T_scr<T, MI, NT>(xT, TBM, hbuf + (H_T + li - 1) * TILE, n_base);
      __syncthreads();
      dtn_atomic<T, W>(xT, W, yT, 2 * TBM,
                       p.d_trunk_w + (size_t)(li - 1) * W * W, n_base);
      if (li - 1 == p.skip_pos) {
        __syncthreads();             // xT is read; its rows take [em; c_e]
        for (int idx = tid; idx < TBM * p.ke; idx += NTHREADS) {
          const int c = idx / TBM, row = idx % TBM;
          xT[c * LDT + row] = ems[row * LDK + c];
          xT[c * LDT + TBM + row] = ces[row * LDK + c];
        }
        __syncthreads();
        dtn_atomic<T, W>(xT, p.ke, yT, 2 * TBM, p.d_wskip, n_base);
      }
      // h_bar = operand(z_bar) @ W^T, then t_bar = operand(tz_bar) @ W^T
      const T* wl = p.trunk + (size_t)(li - 1) * W * W;
      warp_gemm<NT, true, MI>(act, LDA, W, wl, W, n_base, acc, true);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) hb[sq(fq<NT>(i, j, r))] = acc[i][j][r];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[i][j][r] = Op::to_f(hbuf[H_TZB * TILE + sq(fq<NT>(i, j, r))]);
      put_act<NT, MI>(act, LDA, acc, n_base);
      __syncthreads();
      warp_gemm<NT, true, MI>(act, LDA, W, wl, W, n_base, acc, true);
      __syncthreads();
    }
    __syncthreads();
  }
}

template <typename T, int W>
size_t fwd_smem() {
  constexpr size_t TBM = Tile<T>::BM, LDK = Tile<T>::LDK;
  return 2 * TBM * (W + Operand<T>::PAD) * sizeof(T) + 2 * TBM * LDK * sizeof(T) +
         TBM * LDK * sizeof(float) + TBM * ROWF * sizeof(float) +
         (size_t)NWARPS * TBM * sizeof(float);
}

template <typename T, int W>
size_t bwd_smem() {
  constexpr size_t TBM = Tile<T>::BM, LDK = Tile<T>::LDK, LDT = Tile<T>::LDT;
  return TBM * (W + Operand<T>::PAD) * sizeof(T) + 3 * TBM * LDK * sizeof(T) +
         2 * (size_t)W * LDT * sizeof(T) + TBM * ROWF * sizeof(float) +
         3 * (size_t)NWARPS * TBM * sizeof(float);
}

template <typename T>
size_t scratch_bytes(int which, int width) {
  const size_t tile = (size_t)Tile<T>::BM * width;
  return which == 0 ? N_F32_FWD * tile * 4
                    : N_F32_BWD * tile * 4 + N_OP_BWD * tile * sizeof(T);
}

template <typename T, int W, bool FWD>
cudaError_t launch(const RadParams<T>& p, int slots, cudaStream_t stream) {
  const size_t smem = FWD ? fwd_smem<T, W>() : bwd_smem<T, W>();
  auto kernel = FWD ? rad_fwd_kernel<T, W> : rad_bwd_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.n + Tile<T>::BM - 1) / Tile<T>::BM;
  const int grid = n_tiles < slots ? n_tiles : slots;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ptrs: em, de, vpe, p3, [g_e, g_out (bwd)], 25 weights (w0T, w0, b0,
// wskipT, wskip, trunkT, trunk, trunk_b, w8fT, w8f, b8f, w8l, b8l, wp, wn,
// wvT, wfT, wf, ba0, waT, wa, bab, wa4T, wa4, ba4), then the outputs
// (fwd: out, g_e; bwd: slot 0 of the 18 gradients in the packed order),
// then the scratch. ints: n, width, ke, kv, n_trunk, skip_pos, slots and
// (bwd) the floats of one gradient slot; the grid is min(tiles, slots).
// em, vpe and the product weights are of the operand type T, everything
// else f32.
template <typename T>
int run(bool fwd, void* const* ptrs, const int* ints, void* stream) {
  RadParams<T> p = {};
  int k = 0;
  auto tp = [&]() { return static_cast<const T*>(ptrs[k++]); };
  auto fp = [&]() { return static_cast<const float*>(ptrs[k++]); };
  auto op = [&]() { return static_cast<float*>(ptrs[k++]); };
  p.em = tp(); p.de = fp(); p.vpe = tp(); p.p3 = fp();
  if (!fwd) { p.g_e_in = fp(); p.g_out = fp(); }
  p.w0T = tp(); p.w0 = tp(); p.b0 = fp();
  p.wskipT = tp(); p.wskip = tp();
  p.trunkT = tp(); p.trunk = tp(); p.trunk_b = fp();
  p.w8fT = tp(); p.w8f = tp(); p.b8f = fp(); p.w8l = fp(); p.b8l = fp();
  p.wp = fp(); p.wn = fp();
  p.wvT = tp(); p.wfT = tp(); p.wf = tp(); p.ba0 = fp();
  p.waT = tp(); p.wa = tp(); p.bab = fp();
  p.wa4T = tp(); p.wa4 = tp(); p.ba4 = fp();
  if (fwd) {
    p.out = op(); p.g_e = op();
  } else {
    p.d_w0 = op(); p.d_b0 = op(); p.d_wskip = op(); p.d_trunk_w = op();
    p.d_trunk_b = op(); p.d_w8f = op(); p.d_b8f = op(); p.d_w8l = op();
    p.d_b8l = op(); p.d_wp = op(); p.d_wv = op(); p.d_wn = op();
    p.d_wf = op(); p.d_ba0 = op(); p.d_wa = op(); p.d_bab = op();
    p.d_wa4 = op(); p.d_ba4 = op();
  }
  p.scratch = static_cast<unsigned char*>(ptrs[k++]);
  p.n = ints[0];
  const int width = ints[1];
  p.ke = ints[2];
  p.kv = ints[3];
  p.n_trunk = ints[4];
  p.skip_pos = ints[5];
  const int slots = ints[6];
  if (!fwd) {
    // the float2 reductions: every slot and leaf 8-byte aligned
    p.slot_floats = ints[7];
    bool aligned = p.slot_floats % 4 == 0;
    for (int g = k - 19; g < k - 1; ++g)
      aligned = aligned && reinterpret_cast<uintptr_t>(ptrs[g]) % 8 == 0;
    if (!aligned) return cudaErrorInvalidValue;
  }
  if (p.n <= 0) return cudaSuccess;
  if (p.ke <= 0 || p.ke % 16 || p.ke > 64 || p.kv <= 0 || p.kv % 16 ||
      p.kv > 64 || p.n_trunk < 1 || p.n_trunk > 7 || p.skip_pos < 0 ||
      p.skip_pos >= p.n_trunk || slots < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 128: return fwd ? launch<T, 128, true>(p, slots, s) : launch<T, 128, false>(p, slots, s);
    case 256: return fwd ? launch<T, 256, true>(p, slots, s) : launch<T, 256, false>(p, slots, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of device scratch one CTA slot needs (which: 0 forward, 1
// backward).
extern "C" long long psnerf_radiance_scratch_bytes(int which, int width) {
  return (long long)scratch_bytes<bf16>(which, width);
}

// Return a cudaError_t (0 = cudaSuccess). The backward adds into its
// gradient slots (one per CTA, laid out back to back), which the caller
// zeroes and then sums with psnerf_radiance_slot_sum.
extern "C" int psnerf_radiance_fwd(void* const* ptrs, const int* ints,
                                   void* stream) {
  return run<bf16>(true, ptrs, ints, stream);
}

extern "C" int psnerf_radiance_bwd(void* const* ptrs, const int* ints,
                                   void* stream) {
  return run<bf16>(false, ptrs, ints, stream);
}

// The slots summed in fixed order by the engine (slot_reduce.cuh). ptrs:
// in [slots, total], out [total] (f32, 16-byte aligned); ints: total (a
// multiple of 4), slots.
extern "C" int psnerf_radiance_slot_sum(void* const* ptrs, const int* ints,
                                        void* stream) {
  return slot_reduce::launch(ptrs[0], ptrs[1], ints[0], ints[1],
                             static_cast<cudaStream_t>(stream));
}

extern "C" const char* psnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
