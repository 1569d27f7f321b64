// Fused radiance+alpha in the bf16-operand form (compute="bfloat16"),
// forward and second-order backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of psnerf_tpu/ops/fused_radiance.py
// (fused_radiance_and_alpha) at wdt = bf16 (the f32 form is
// fused_radiance_f32.cu): the forward (_fwd_kernel, pallas_call at :390)
// and the backward (_bwd_kernel, :410). Rounding points as in the TPU
// kernel: every product operand is bf16, accumulation is f32; biases,
// softplus, sigmoid and the sweeps' elementwise work are f32; the logit
// row w8l and the position and normal rows of appearance layer 0 (wp, wn)
// are f32; the bias-like gradients are column sums of f32 values.
//
// Four launches, made by ops/fused_radiance.py:
//   * fwd_kernel (K2): geometry trunk -> feature and logit, reverse sweep
//     g_e = d logit / d emb, normals n = (d emb / d x)^T g_e, appearance
//     MLP -> pre-tanh rgb;
//   * sweep_kernel (K3, part 1, per chunk of points): recompute with the
//     saved g_e, appearance backward, tangent forward of the normal path,
//     and the doubled reverse sweep carrying (h_bar, t_bar) through
//     softplus'' = 100 s (1 - s). It computes no weight-gradient product:
//     it writes each product's operand pair, bf16, to a device workspace
//     (WsRows below, ~41 W + 2 ke + kv + 8 rows, 21.8 KB a point at W =
//     256), and each 64-point tile's f32 column sums (the bias-like
//     gradients, wp, wn and w8l) onto its consumer's own slot, the chunks
//     one after another onto the same zeroed slots;
//   * wgrad_kernel (K3, part 2, per chunk): every weight gradient x^T y as
//     bf16 wgmma m64n128k16 of depth K = points, split-K over CTAs, each
//     split's partial in its own slot (wplan: leaf after leaf), no atomics;
//     after the last chunk's sweep, each split also adds its share of the
//     column-sum slots, in order, into its slot's column-sum region;
//   * the reduce (K3, part 3): the slot reduction engine (slot_reduce.cuh,
//     psnerf_radiance_slot_sum) adds the split-K slots in fixed order into
//     one flat buffer of which the 18 gradients are views. The backward is
//     the same bits from run to run.
//
// What bounds it: operations for the products (per point the forward runs
// ~19 and the backward ~57 W x W products, 2 W^2 FLOPs each), bytes for
// the backward's workspace (written once, read about twice) and for the
// sweeps' per-layer f32 values (s', tz, h_bar: written once, read once).
//
// Design. The forward and the sweep run on the bf16 trunk engine
// (trunk_wgmma.cuh): per CTA a producer warpgroup streams the weights'
// k-step slabs (packed once per packing, in the order the consumers read
// them: `mats` and the per-kernel schedules below) by cp.async.bulk
// through an mbarrier ring, and two consumer warpgroups of 64 points each
// run every product as wgmma m64nWk16 with A from registers: the
// epilogue turns each layer's accumulator into the next layer's bf16 A
// fragments, so the layer chain never leaves registers and every weight
// byte read from L2 serves 128 points. The g_e products run as wide as
// the others (w0^T and wskip^T padded to W columns: a narrower product
// into a slice of the accumulators made ptxas spill them). The softplus
// and sigmoid are K1's (ex2/lg2.approx, one reciprocal). The narrow point
// operands (embedding, view PE, tangent c_e) are K-major tiles in shared
// memory. What the sweeps need again later (s' of every layer, tz, h_bar,
// the appearance relu masks, the tz_bar A fragments) does not fit in
// registers (W / 2 accumulators and W / 4 A registers of 240) nor in
// shared memory: each consumer thread keeps it in its own words of device
// scratch, so it rereads exactly what it wrote (coalesced, no
// synchronisation). The doubled reverse sweep runs its two products
// (z_bar W^T and tz_bar W^T) one after the other, each over its own pass
// of the layer's slabs: both accumulators at once would need W registers.
//
// The workspace is K-major for the weight-gradient products: feature rows
// over the points, in core matrices of 8 features x 8 points (128 bytes),
// so one feature group's run of points is contiguous (ws_idx). The sweep
// stages each layer's tile in shared memory in that layout and writes it
// with 1 KB cp.async.bulk stores; the wgrad kernel's producer copies each
// 8-feature group of a 128-point stage with one 2 KB cp.async.bulk
// straight into wgmma's no-swizzle layout.
//
// ptxas reports registers, spills and shared memory per instantiation
// into ops/_build/fused_radiance.ptxas.txt.

#include "slot_reduce.cuh"
#include "trunk_wgmma.cuh"

using namespace trunk;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TROWS = NCONS * ROWS;  // points of a CTA tile
constexpr int MAXL = 8;              // trunk layers + 1, at most
constexpr int ROWF = 16;             // per-point f32 values in shared memory
// ROWF slots: 0-2 p, 3 g_logit, 4-6 n, 7-9 g_n, 10-12 g_rgb
constexpr int RF_P = 0, RF_GL = 3, RF_N = 4, RF_GN = 7, RF_GRGB = 10;
constexpr int MAX_SEGS = 64;

// ---------------------------------------------------------------- layouts

// The packed slabs (ops/fused_radiance.py `bf16_slab_mats` lists the same
// matrices in the same order, each as [N, K]), byte offsets: the narrow-K
// products' w0, wskip, wv; the forward products' W x W matrices; the
// reverse products' (w0^T and wskip^T padded to W columns).
struct Mats {
  long long w0, wskip, wv, trunk, w8f, wf, wa, trunkT, wskipT, w0T, waT, wfT,
      w8fT, total;
};

__host__ Mats mats(int w, int ke, int kv, int nt) {
  Mats m;
  long long at = 0;
  auto take = [&](long long rows, long long k) {
    at += rows * k * 2;
    return at - rows * k * 2;
  };
  m.w0 = take(w, ke);
  m.wskip = take(w, ke);
  m.wv = take(w, kv);
  m.trunk = take((long long)nt * w, w);
  m.w8f = take(w, w);
  m.wf = take(w, w);
  m.wa = take(3LL * w, w);
  m.trunkT = take((long long)nt * w, w);
  m.wskipT = take(w, w);
  m.w0T = take(w, w);
  m.waT = take(3LL * w, w);
  m.wfT = take(w, w);
  m.w8fT = take(w, w);
  m.total = at;
  return m;
}

// A matrix's run of `count` k-step slabs (W * 32 bytes each) from byte
// `off` of the packed slabs.
struct Seg { long long off; int count; };
struct Sched { Seg seg[MAX_SEGS]; int n; };

struct SchedBuilder {
  Sched s = {};
  // the slabs of the matrix at `off`, of depth k
  __host__ void mat(long long off, int k) { s.seg[s.n++] = {off, k / 16}; }
};

// the slabs the forward's consumers read, per tile, in order
__host__ Sched sched_fwd(int w, int ke, int kv, int nt, int skip) {
  const Mats m = mats(w, ke, kv, nt);
  const long long ww = (long long)w * w * 2;
  SchedBuilder b;
  b.mat(m.w0, ke);
  for (int li = 0; li < nt; ++li) {
    b.mat(m.trunk + li * ww, w);
    if (li == skip) b.mat(m.wskip, ke);
  }
  b.mat(m.w8f, w);
  b.mat(m.wf, w);
  for (int li = nt; li >= 1; --li) {
    if (li == skip + 1) b.mat(m.wskipT, w);
    b.mat(m.trunkT + (li - 1) * ww, w);
  }
  b.mat(m.w0T, w);
  b.mat(m.wv, kv);
  for (int j = 0; j < 3; ++j) b.mat(m.wa + j * ww, w);
  return b.s;
}

// the slabs the sweep's consumers read, per tile, in order
__host__ Sched sched_sweep(int w, int ke, int kv, int nt, int skip) {
  const Mats m = mats(w, ke, kv, nt);
  const long long ww = (long long)w * w * 2;
  SchedBuilder b;
  for (int pass = 0; pass < 2; ++pass) {      // recompute, then tangents
    b.mat(m.w0, ke);
    for (int li = 0; li < nt; ++li) {
      b.mat(m.trunk + li * ww, w);
      if (li == skip) b.mat(m.wskip, ke);
    }
    if (pass == 1) break;
    b.mat(m.w8f, w);
    b.mat(m.wf, w);
    b.mat(m.wv, kv);
    for (int j = 0; j < 3; ++j) b.mat(m.wa + j * ww, w);
    for (int j = 2; j >= 0; --j) b.mat(m.waT + j * ww, w);
    b.mat(m.wfT, w);
    b.mat(m.w8fT, w);
  }
  for (int li = nt; li >= 1; --li) {
    b.mat(m.trunkT + (li - 1) * ww, w);
    b.mat(m.trunkT + (li - 1) * ww, w);
  }
  return b.s;
}

// The workspace rows (features), each over the chunk's points; mirrored by
// ops/fused_radiance.py ws_layout(..., "bfloat16"). [feat; vpe] is one
// product's x rows; a, t, aa, gz, zb and tzb stack their layers.
struct WsRows { int feat, vpe, em, ce, a, t, aa, gz, gfeat, g8, zb, tzb, rows; };

__host__ __device__ WsRows ws_rows(int w, int ke, int kv, int nt) {
  WsRows L;
  L.feat = 0; L.vpe = w; L.em = w + kv; L.ce = L.em + ke; L.a = L.ce + ke;
  L.t = L.a + (nt + 1) * w; L.aa = L.t + nt * w; L.gz = L.aa + 4 * w;
  L.gfeat = L.gz + 4 * w; L.g8 = L.gfeat + w; L.zb = L.g8 + 8;
  L.tzb = L.zb + (nt + 1) * w; L.rows = L.tzb + (nt + 1) * w;
  return L;
}

// element (feature f, point p) of a workspace of ld points (ld a multiple
// of TROWS): core matrices of 8 features x 8 points, an 8-feature group's
// points contiguous
__device__ __forceinline__ size_t ws_idx(long long ld, int f, int p) {
  return ((size_t)(f >> 3) * (size_t)(ld >> 3) + (size_t)(p >> 3)) * 64 +
         (f & 7) * 8 + (p & 7);
}

// One column-sum slot (a consumer's tiles' f32 sums), leaf after leaf;
// mirrored by ops/fused_radiance.py bf16_slot_layout.
struct CsLayout { int trunk_b, b0, b8f, bab, ba0, wp, wn, w8l, ba4, b8l, floats; };

__host__ __device__ CsLayout cs_layout(int w, int nt) {
  CsLayout C;
  C.trunk_b = 0; C.b0 = nt * w; C.b8f = C.b0 + w; C.bab = C.b8f + w;
  C.ba0 = C.bab + 3 * w; C.wp = C.ba0 + w; C.wn = C.wp + 3 * w;
  C.w8l = C.wn + 3 * w; C.ba4 = C.w8l + w; C.b8l = C.ba4 + 3;
  C.floats = C.b8l + 5;                      // a multiple of 4
  return C;
}

struct RParams {
  const bf16 *em, *vpe;
  const float *de, *p3, *g_e_in, *g_out;
  const unsigned char* slabs;
  const float *b0, *trunk_b, *b8f, *w8l, *b8l, *wp, *wn, *ba0, *bab, *wa4t,
      *ba4;
  float *out, *g_e;                  // forward
  bf16* ws;                          // sweep: the workspace
  float* colsum;                     // sweep: this chunk's column-sum slots
  float* scratch;
  long long ld;
  int n, row_begin, ke, kv, n_trunk, skip_pos, ring, scr_words;
  Sched sched;
};

// ------------------------------------------------------------ consumers

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

// softplus(100 x) / 100 and its derivative sigmoid(100 x) from one
// exponential, e = exp(-|100 x|) in (0, 1]: log1p(e) = ln 2 log2(1 + e)
// and 1 / (1 + e) by the special-function unit (errors of a few 1e-7,
// far below the bf16 rounding of the activation that follows; K1's
// softplus, fused_occ.cu, is the same)
__device__ __forceinline__ void sp_sig(float x, float& sp, float& sg) {
  const float bx = 100.f * x;
  const float e = ex2_approx(fabsf(bx) * -1.4426950408889634f);
  sp = (fmaxf(bx, 0.f) + lg2_approx(1.f + e) * 0.6931471805599453f) * 0.01f;
  const float inv = __fdividef(1.f, 1.f + e);
  sg = bx >= 0.f ? inv : e * inv;
}

__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A consumer thread's words of device scratch: word q at base[q * 128]
__device__ __forceinline__ float* scr_base(const RParams& p) {
  const int wg = threadIdx.x >> 7;
  return p.scratch +
         ((size_t)blockIdx.x * NCONS + wg) * (size_t)p.scr_words * 128 +
         (threadIdx.x & 127);
}

template <int W>
__device__ __forceinline__ void store_scr(float* s, const float (&y)[W / 2]) {
#pragma unroll
  for (int q = 0; q < W / 2; ++q) s[q * 128] = y[q];
}

template <int W>
__device__ __forceinline__ void add_scr(float (&y)[W / 2], const float* s) {
#pragma unroll
  for (int q = 0; q < W / 2; ++q) y[q] += s[q * 128];
}

template <int W>
__device__ __forceinline__ void mul_scr(float (&y)[W / 2], const float* s) {
#pragma unroll
  for (int q = 0; q < W / 2; ++q) y[q] *= s[q * 128];
}

// y[col] = v[col] for the thread's columns
template <int W>
__device__ __forceinline__ void set_cols(float (&y)[W / 2], const float* v) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 c = __ldg(reinterpret_cast<const float2*>(v + 8 * j + 2 * t));
    y[4 * j] = c.x; y[4 * j + 1] = c.y; y[4 * j + 2] = c.x; y[4 * j + 3] = c.y;
  }
}

template <int W>
__device__ __forceinline__ void add_bias(float (&y)[W / 2], const float* b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 c = __ldg(reinterpret_cast<const float2*>(b + 8 * j + 2 * t));
    y[4 * j] += c.x; y[4 * j + 1] += c.y; y[4 * j + 2] += c.x; y[4 * j + 3] += c.y;
  }
}

template <int W>
__device__ __forceinline__ void relu_bias(float (&y)[W / 2], const float* b) {
  add_bias<W>(y, b);
#pragma unroll
  for (int q = 0; q < W / 2; ++q) y[q] = fmaxf(y[q], 0.f);
}

// y = softplus(y + bias), its derivative s' into scratch
template <int W>
__device__ __forceinline__ void softplus_layer(float (&y)[W / 2],
                                               const float* bias, float* sp) {
  add_bias<W>(y, bias);
#pragma unroll
  for (int q = 0; q < W / 2; ++q) {
    float s, g;
    sp_sig(y[q], s, g);
    y[q] = s;
    sp[q * 128] = g;
  }
}

// n[h][m] (rows lo / hi, column classes c % 3 == m) of g_e, the first 32
// accumulators (columns 0 .. 63, ke of them used); every lane of the quad
// gets the sums. The forward and the sweep both compute n here: the same
// bits from the same g_e.
template <int W>
__device__ __forceinline__ void normals(const float (&ge)[W / 2],
                                        const float* de, int row0, int nv,
                                        int ke, float (&n)[2][3]) {
  const int rl = row_lo(), t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < 3; ++m) n[h][m] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r >> 1, row = rl + 8 * h, col = 8 * j + 2 * t + (r & 1);
      if (col < ke && row < nv) {
        const float x = ge[4 * j + r] * __ldg(de + (size_t)(row0 + row) * ke + col);
        const int m = col % 3;
        n[h][0] += m == 0 ? x : 0.f;
        n[h][1] += m == 1 ? x : 0.f;
        n[h][2] += m == 2 ? x : 0.f;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      n[h][m] += __shfl_xor_sync(0xffffffffu, n[h][m], 1);
      n[h][m] += __shfl_xor_sync(0xffffffffu, n[h][m], 2);
    }
}

// appearance layer 0's epilogue: y = relu(y + zf + ba0 + sum_c p_c wp[c] +
// n_c wn[c]), p and n of the thread's rows from rowf; one pass over the
// columns, so few weights are live at a time
template <int W>
__device__ __forceinline__ void app0(float (&y)[W / 2], const float* zf,
                                     const RParams& p, const float* rowf) {
  const int rl = row_lo(), t = threadIdx.x & 3;
  add_scr<W>(y, zf);
  add_bias<W>(y, p.ba0);
  float pc[2][3], nc[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pc[h][c] = rowf[(rl + 8 * h) * ROWF + RF_P + c];
      nc[h][c] = rowf[(rl + 8 * h) * ROWF + RF_N + c];
    }
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    float2 a[3], b[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = __ldg(reinterpret_cast<const float2*>(p.wp + c * W + 8 * j + 2 * t));
      b[c] = __ldg(reinterpret_cast<const float2*>(p.wn + c * W + 8 * j + 2 * t));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0 = y[4 * j + 2 * h], y1 = y[4 * j + 2 * h + 1];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        y0 = y0 + pc[h][c] * a[c].x;
        y0 = y0 + nc[h][c] * b[c].x;
        y1 = y1 + pc[h][c] * a[c].y;
        y1 = y1 + nc[h][c] * b[c].y;
      }
      y[4 * j + 2 * h] = fmaxf(y0, 0.f);
      y[4 * j + 2 * h + 1] = fmaxf(y1, 0.f);
    }
  }
}

// Row sums of r(y) * w[k][col] for k < 3 in f32 over all W columns, r the
// bf16 rounding (BF) or none: s[k][0] the thread's lo row, s[k][1] its hi
// row; every lane of the quad gets them. One pass over the columns.
template <int W, bool BF>
__device__ __forceinline__ void row_dot3(const float (&y)[W / 2],
                                         const float* w, float (&s)[3][2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k][0] = s[k][1] = 0.f;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = BF ? bf_round(y[4 * j + r]) : y[4 * j + r];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float2 c = __ldg(reinterpret_cast<const float2*>(w + k * W + 8 * j + 2 * t));
      s[k][0] += v[0] * c.x + v[1] * c.y;
      s[k][1] += v[2] * c.x + v[3] * c.y;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[k][h] += __shfl_xor_sync(0xffffffffu, s[k][h], 1);
      s[k][h] += __shfl_xor_sync(0xffffffffu, s[k][h], 2);
    }
}

// The slab stream of one CTA: the schedule once per tile it owns.
__device__ __forceinline__ void produce(const RingSpec& rs,
                                        const unsigned char* src,
                                        const Sched& sc, int tiles) {
  uint32_t it = 0, phase = 0;
  int slot = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    for (int g = 0; g < sc.n; ++g) {
      const Seg sg = sc.seg[g];
      for (int k = 0; k < sg.count; ++k) {
        if (it >= (uint32_t)rs.ring) mbar_wait(rs.empty + slot, phase ^ 1);
        mbar_expect_tx(rs.full + slot, rs.slab);
        bulk_load(rs.slots + (size_t)slot * rs.slab,
                  src + sg.off + (long long)k * rs.slab, rs.slab,
                  rs.full + slot);
        ++it;
        if (++slot == rs.ring) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
}

// Shared memory of a consumer warpgroup: the embedding, view PE and (sweep)
// tangent A tiles, the per-point values, (sweep) the column sums' cross-
// warp buffers and the workspace's staging tile. Offsets in bytes from
// the consumer's base.
struct ConsSmem { int em, vpe, ce, rowf, red, stg, bytes; };

__host__ __device__ ConsSmem cons_smem(int w, int ke, int kv, bool sweep) {
  ConsSmem S;
  S.em = 0;
  S.vpe = S.em + ke / 16 * A_KSTEP;
  S.ce = S.vpe + kv / 16 * A_KSTEP;
  S.rowf = S.ce + (sweep ? ke / 16 * A_KSTEP : 0);
  S.red = S.rowf + ROWS * ROWF * 4;
  S.stg = S.red + (sweep ? 2 * 4 * w * 4 : 0);
  S.bytes = S.stg + (sweep ? ROWS * w * 2 : 0);
  return S;
}

// the ring, then NCONS consumer regions, then the ring's barriers
__host__ __device__ size_t ring_bytes(int ring, int w) {
  return (size_t)ring * w * 32;
}

// ------------------------------------------------------------- forward

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1)
    fwd_kernel(const __grid_constant__ RParams p) {
  constexpr int KS = W / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kes = p.ke / 16, kvs = p.kv / 16, nt = p.n_trunk;
  const ConsSmem S = cons_smem(W, p.ke, p.kv, false);
  RingSpec rs;
  rs.ring = p.ring;
  rs.slab = W * 32;
  rs.slots = smem;
  unsigned char* cons0 = smem + ring_bytes(p.ring, W);
  rs.full = reinterpret_cast<uint64_t*>(cons0 + NCONS * S.bytes);
  rs.empty = rs.full + MAX_RING;
  ring_init(rs);
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int tiles = (p.n + TROWS - 1) / TROWS;
  if (wg == NCONS) {                       // producer
    set_max_regs_dec<24>();
    if ((threadIdx.x & 127) == 0) produce(rs, p.slabs, p.sched, tiles);
    return;
  }
  set_max_regs_inc<240>();
  Consumer c;
  c.s = rs;
  unsigned char* cs = cons0 + wg * S.bytes;
  unsigned char* emt = cs + S.em;
  unsigned char* vpt = cs + S.vpe;
  float* rowf = reinterpret_cast<float*>(cs + S.rowf);
  const int tw = threadIdx.x & 127, t = threadIdx.x & 3, rl = row_lo();
  float* sc = scr_base(p);
  const int ZF = (nt + 1) * W / 2;         // scratch: s' per layer, zf
  float acc[W / 2];
  uint32_t a[KS][4];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * TROWS + wg * ROWS;
    const int nv = min(ROWS, p.n - row0);  // may be <= 0
    bar_sync(BAR_WG + wg, 128);            // the last tile's readers are done
    load_a_tile(emt, p.em, row0, p.n, p.ke, tw, 128);
    load_a_tile(vpt, p.vpe, row0, p.n, p.kv, tw, 128);
    for (int i = tw; i < ROWS * 3; i += 128) {
      const int r = i / 3, k = i % 3;
      rowf[r * ROWF + RF_P + k] =
          r < nv ? __ldg(p.p3 + (size_t)(row0 + r) * 3 + k) : 0.f;
    }
    fence_async_shared();
    bar_sync(BAR_WG + wg, 128);

    // geometry trunk; s' of every layer into scratch
    c.product_smem<W>(acc, emt, kes, false);
    c.drain(acc);
    softplus_layer<W>(acc, p.b0, sc);
    to_afrag<W>(acc, a);
#pragma unroll 1
    for (int li = 0; li < nt; ++li) {
      c.product<W>(acc, a, false);
      if (li == p.skip_pos) c.product_smem<W>(acc, emt, kes, true);
      c.drain(acc);
      softplus_layer<W>(acc, p.trunk_b + (size_t)li * W,
                        sc + (size_t)(li + 1) * (W / 2) * 128);
      to_afrag<W>(acc, a);
    }
    float lg_lo, lg_hi;                    // the logit, f32 a_last . w8l
    row_dot<W>(acc, p.w8l, lg_lo, lg_hi);
    // feature head, and at once feat @ wf (appearance layer 0's feat rows)
    c.product<W>(acc, a, false);
    c.drain(acc);
    add_bias<W>(acc, p.b8f);
    to_afrag<W>(acc, a);
    c.product<W>(acc, a, false);
    c.drain(acc);
    store_scr<W>(sc + (size_t)ZF * 128, acc);

    // reverse sweep: g = d logit / d a from w8l down to the embedding
    set_cols<W>(acc, p.w8l);
#pragma unroll 1
    for (int li = nt; li >= 0; --li) {
      mul_scr<W>(acc, sc + (size_t)li * (W / 2) * 128);
      to_afrag<W>(acc, a);
      if (li == 0) break;
      if (li == p.skip_pos + 1) {
        // gz_skip @ wskip^T: kept in g_e until the w0 half is added
        c.product<W>(acc, a, false);
        c.drain(acc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = rl + 8 * (r >> 1), col = 8 * j + 2 * t + (r & 1);
            if (row < nv && col < p.ke)
              p.g_e[(size_t)(row0 + row) * p.ke + col] = acc[4 * j + r];
          }
      }
      c.product<W>(acc, a, false);
      c.drain(acc);
    }
    // g_e = (g s0) @ w0^T + gz_skip @ wskip^T, then the normals
    c.product<W>(acc, a, false);
    c.drain(acc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rl + 8 * (r >> 1), col = 8 * j + 2 * t + (r & 1);
        if (row < nv && col < p.ke) {
          float* g = p.g_e + (size_t)(row0 + row) * p.ke + col;
          acc[4 * j + r] += *g;
          *g = acc[4 * j + r];
        }
      }
    {
      float n[2][3];
      normals<W>(acc, p.de, row0, nv, p.ke, n);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int m = 0; m < 3; ++m) rowf[(rl + 8 * h) * ROWF + RF_N + m] = n[h][m];
    }

    // appearance: relu layers on [p, view PE, n, feat] -> pre-tanh rgb
    c.product_smem<W>(acc, vpt, kvs, false);
    c.drain(acc);
    app0<W>(acc, sc + (size_t)ZF * 128, p, rowf);
    to_afrag<W>(acc, a);
#pragma unroll 1
    for (int jl = 0; jl < 3; ++jl) {
      c.product<W>(acc, a, false);
      c.drain(acc);
      relu_bias<W>(acc, p.bab + jl * W);
      if (jl < 2) to_afrag<W>(acc, a);
    }
    // rgb = bf16(aa3) @ wa4 + ba4 on the CUDA cores (3 columns)
    float o[3][2];
    row_dot3<W, true>(acc, p.wa4t, o);
    if (t < 2) {
      const int row = rl + 8 * t;
      if (row < nv) {
        float* out = p.out + (size_t)(row0 + row) * 4;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          out[k] = (t == 0 ? o[k][0] : o[k][1]) + __ldg(p.ba4 + k);
        out[3] = (t == 0 ? lg_lo : lg_hi) + __ldg(p.b8l);
      }
    }
  }
}

// ------------------------------------------------- backward: the sweep

__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gdst),
      "r"(smem_u32(ssrc)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the bulk stores committed so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A consumer's writes to the workspace: a tile's W features x 64 points
// are staged in shared memory in the workspace's own layout (an 8-feature
// group's 64 points are 1 KB, contiguous there and in the workspace), and
// its first thread copies each group out with one cp.async.bulk store.
struct WsOut {
  bf16* ws;
  long long ld;
  unsigned char* stg;            // ROWS x W bf16
  int r0, nv;                    // the tile's first point (in the chunk), valid rows

  // the staging buffer is free again: the last stores have read it
  __device__ __forceinline__ void acquire() const {
    if ((threadIdx.x & 127) == 0) bulk_wait_read();
    bar_sync(BAR_WG + (threadIdx.x >> 7), 128);
  }
  // element (feature col, tile row) = bf16(v), 0 past the valid rows
  __device__ __forceinline__ void stage(int col, int row, float v) const {
    *reinterpret_cast<bf16*>(stg + (col >> 3) * (ROWS * 16) +
                             (row >> 3) * 128 + (col & 7) * 16 +
                             (row & 7) * 2) =
        __float2bfloat16_rn(row < nv ? v : 0.f);
  }
  // the staged features [0, nf) to workspace rows [f0, f0 + nf)
  __device__ __forceinline__ void flush(int f0, int nf) const {
    fence_async_shared();
    bar_sync(BAR_WG + (threadIdx.x >> 7), 128);
    if ((threadIdx.x & 127) == 0) {
      for (int g = 0; g < nf / 8; ++g)
        bulk_store(ws + ws_idx(ld, f0 + 8 * g, r0), stg + g * (ROWS * 16),
                   ROWS * 16);
      bulk_commit();
    }
  }
};

// workspace rows f0 + col, the tile's points: bf16(y)
template <int W>
__device__ __forceinline__ void put_ws(const WsOut& o, int f0,
                                       const float (&y)[W / 2]) {
  const int rl = row_lo(), t = threadIdx.x & 3;
  o.acquire();
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      o.stage(8 * j + 2 * t + (r & 1), rl + 8 * (r >> 1), y[4 * j + r]);
  o.flush(f0, W);
}

// Column sums over the tile's valid rows of w_row * y (rf < 0: weight 1)
// added onto slot[0 .. W) (zeroed before the first chunk): the thread's
// two rows, a shuffle over the warp's 16, the 4 warps in order through red
// (two buffers, alternated: one barrier a call).
template <int W>
__device__ __forceinline__ void colsum(const float (&y)[W / 2],
                                       const float* rowf, int rf, int nv,
                                       float* red, int& buf, float* slot) {
  const int tw = threadIdx.x & 127, warp = tw >> 5, t = tw & 3;
  const int rl = row_lo(), g = (tw & 31) >> 2;
  const bool v0 = rl < nv, v1 = rl + 8 < nv;
  const float w0 = rf < 0 ? 1.f : rowf[rl * ROWF + rf];
  const float w1 = rf < 0 ? 1.f : rowf[(rl + 8) * ROWF + rf];
  float* rb = red + buf * 4 * W;
  buf ^= 1;
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = (v0 ? w0 * y[4 * j + e] : 0.f) + (v1 ? w1 * y[4 * j + 2 + e] : 0.f);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) rb[warp * W + 8 * j + 2 * t + e] = s;
    }
  bar_sync(BAR_WG + (threadIdx.x >> 7), 128);
  for (int col = tw; col < W; col += 128) {
    const float v = ((rb[col] + rb[W + col]) + rb[2 * W + col]) + rb[3 * W + col];
    slot[col] += v;
  }
}

// relu masks (y > 0) of the thread's elements as W / 64 words
template <int W>
__device__ __forceinline__ void put_mask(const float (&y)[W / 2], float* s) {
#pragma unroll
  for (int wd = 0; wd < W / 64; ++wd) {
    uint32_t m = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) m |= (y[32 * wd + b] > 0.f ? 1u : 0u) << b;
    s[wd * 128] = __uint_as_float(m);
  }
}

template <int W>
__device__ __forceinline__ void apply_mask(float (&y)[W / 2], const float* s) {
#pragma unroll
  for (int wd = 0; wd < W / 64; ++wd) {
    const uint32_t m = __float_as_uint(s[wd * 128]);
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (!((m >> b) & 1u)) y[32 * wd + b] = 0.f;
  }
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1)
    sweep_kernel(const __grid_constant__ RParams p) {
  constexpr int KS = W / 16;
  constexpr int H = W / 2;                 // scratch words of one tile value
  extern __shared__ __align__(128) unsigned char smem[];
  const int kes = p.ke / 16, kvs = p.kv / 16, nt = p.n_trunk;
  const ConsSmem S = cons_smem(W, p.ke, p.kv, true);
  RingSpec rs;
  rs.ring = p.ring;
  rs.slab = W * 32;
  rs.slots = smem;
  unsigned char* cons0 = smem + ring_bytes(p.ring, W);
  rs.full = reinterpret_cast<uint64_t*>(cons0 + NCONS * S.bytes);
  rs.empty = rs.full + MAX_RING;
  ring_init(rs);
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int tiles = (p.n + TROWS - 1) / TROWS;
  if (wg == NCONS) {                       // producer
    set_max_regs_dec<24>();
    if ((threadIdx.x & 127) == 0) produce(rs, p.slabs, p.sched, tiles);
    return;
  }
  set_max_regs_inc<240>();
  Consumer c;
  c.s = rs;
  unsigned char* cs = cons0 + wg * S.bytes;
  unsigned char* emt = cs + S.em;
  unsigned char* vpt = cs + S.vpe;
  unsigned char* cet = cs + S.ce;
  float* rowf = reinterpret_cast<float*>(cs + S.rowf);
  float* red = reinterpret_cast<float*>(cs + S.red);
  int buf = 0;
  const int tw = threadIdx.x & 127, t = threadIdx.x & 3, rl = row_lo();
  float* sc = scr_base(p);
  // scratch words: s' and tz per layer, h_bar (first zf), the tz_bar A
  // fragments, the relu masks of appearance layers 0-2
  const int TZ = (nt + 1) * H, HB = 2 * (nt + 1) * H, TZBF = HB + H,
            MASK = TZBF + W / 4;
  const WsRows L = ws_rows(W, p.ke, p.kv, nt);
  const CsLayout C = cs_layout(W, nt);
  float* slot = p.colsum + ((size_t)blockIdx.x * NCONS + wg) * C.floats;
  const long long ld = p.ld;
  bf16* ws = p.ws;
  const int n_end = p.row_begin + p.n;
  unsigned char* stg = cs + S.stg;
  float acc[W / 2];
  uint32_t a[KS][4];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * TROWS + wg * ROWS;       // within the chunk
    const int row0 = p.row_begin + r0;             // within the batch
    const int nv = min(ROWS, p.n - r0);            // may be <= 0
    const WsOut wo = {ws, ld, stg, r0, nv};
    bar_sync(BAR_WG + wg, 128);
    load_a_tile(emt, p.em, row0, n_end, p.ke, tw, 128);
    load_a_tile(vpt, p.vpe, row0, n_end, p.kv, tw, 128);
    for (int i = tw; i < ROWS * 4; i += 128) {
      const int r = i / 4, k = i % 4;
      const bool in = r < nv;
      if (k < 3)
        rowf[r * ROWF + RF_P + k] = in ? __ldg(p.p3 + (size_t)(row0 + r) * 3 + k) : 0.f;
      rowf[r * ROWF + (k < 3 ? RF_GRGB + k : RF_GL)] =
          in ? __ldg(p.g_out + (size_t)(row0 + r) * 4 + k) : 0.f;
    }
    // the narrow x rows: em, vpe
    for (int i = tw; i < ROWS * p.ke; i += 128) {
      const int r = i % ROWS, k = i / ROWS;
      ws[ws_idx(ld, L.em + k, r0 + r)] =
          r < nv ? p.em[(size_t)(row0 + r) * p.ke + k] : __float2bfloat16_rn(0.f);
    }
    for (int i = tw; i < ROWS * p.kv; i += 128) {
      const int r = i % ROWS, k = i / ROWS;
      ws[ws_idx(ld, L.vpe + k, r0 + r)] =
          r < nv ? p.vpe[(size_t)(row0 + r) * p.kv + k] : __float2bfloat16_rn(0.f);
    }
    fence_async_shared();
    bar_sync(BAR_WG + wg, 128);
    // the rgb head's y rows [g_rgb, g_logit, 0 x 4] (its product reads
    // g_rgb) and the column sums of g_rgb, g_logit (ba4, b8l)
    for (int i = tw; i < ROWS * 8; i += 128) {
      const int r = i % ROWS, k = i / ROWS;
      ws[ws_idx(ld, L.g8 + k, r0 + r)] = __float2bfloat16_rn(
          k < 3 ? rowf[r * ROWF + RF_GRGB + k]
                : (k == 3 ? rowf[r * ROWF + RF_GL] : 0.f));
    }
    if (tw < 4) {
      const int rf = tw < 3 ? RF_GRGB + tw : RF_GL;
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += rowf[r * ROWF + rf];
      float* dst = slot + (tw < 3 ? C.ba4 + tw : C.b8l);
      *dst += s;
    }

    // ---- forward recompute (g_e is an input)
    c.product_smem<W>(acc, emt, kes, false);
    c.drain(acc);
    softplus_layer<W>(acc, p.b0, sc);
    put_ws<W>(wo, L.a, acc);
    to_afrag<W>(acc, a);
#pragma unroll 1
    for (int li = 0; li < nt; ++li) {
      c.product<W>(acc, a, false);
      if (li == p.skip_pos) c.product_smem<W>(acc, emt, kes, true);
      c.drain(acc);
      softplus_layer<W>(acc, p.trunk_b + (size_t)li * W,
                        sc + (size_t)(li + 1) * H * 128);
      put_ws<W>(wo, L.a + (li + 1) * W, acc);
      to_afrag<W>(acc, a);
    }
    // w8l's first half: the column sums of g_logit a_last (f32)
    colsum<W>(acc, rowf, RF_GL, nv, red, buf, slot + C.w8l);
    c.product<W>(acc, a, false);
    c.drain(acc);
    add_bias<W>(acc, p.b8f);
    put_ws<W>(wo, L.feat, acc);
    to_afrag<W>(acc, a);
    c.product<W>(acc, a, false);
    c.drain(acc);
    store_scr<W>(sc + (size_t)HB * 128, acc);      // zf = feat @ wf
    {
      // n from the saved g_e, as the forward computed it
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = rl + 8 * (r >> 1), col = 8 * j + 2 * t + (r & 1);
          acc[4 * j + r] = row < nv && col < p.ke
                             ? __ldg(p.g_e_in + (size_t)(row0 + row) * p.ke + col)
                             : 0.f;
        }
      float n[2][3];
      normals<W>(acc, p.de, row0, nv, p.ke, n);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int m = 0; m < 3; ++m) rowf[(rl + 8 * h) * ROWF + RF_N + m] = n[h][m];
    }
    c.product_smem<W>(acc, vpt, kvs, false);
    c.drain(acc);
    app0<W>(acc, sc + (size_t)HB * 128, p, rowf);
    put_ws<W>(wo, L.aa, acc);
    put_mask<W>(acc, sc + (size_t)MASK * 128);
    to_afrag<W>(acc, a);
#pragma unroll 1
    for (int jl = 0; jl < 3; ++jl) {
      c.product<W>(acc, a, false);
      c.drain(acc);
      relu_bias<W>(acc, p.bab + jl * W);
      put_ws<W>(wo, L.aa + (jl + 1) * W, acc);
      if (jl < 2) {
        put_mask<W>(acc, sc + (size_t)(MASK + (jl + 1) * (W / 64)) * 128);
        to_afrag<W>(acc, a);
      }
    }

    // ---- appearance backward: gz = bf16(g_rgb) @ wa4^T where aa3 > 0
    {
      float g[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          g[h][k] = bf_round(rowf[(rl + 8 * h) * ROWF + RF_GRGB + k]);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        float2 c[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          c[k] = __ldg(reinterpret_cast<const float2*>(p.wa4t + k * W + 8 * j + 2 * t));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k) s += g[r >> 1][k] * ((r & 1) ? c[k].y : c[k].x);
          acc[4 * j + r] = acc[4 * j + r] > 0.f ? s : 0.f;
        }
      }
    }
    put_ws<W>(wo, L.gz + 3 * W, acc);
    colsum<W>(acc, rowf, -1, nv, red, buf, slot + C.bab + 2 * W);
#pragma unroll 1
    for (int jl = 2; jl >= 0; --jl) {
      to_afrag<W>(acc, a);
      c.product<W>(acc, a, false);
      c.drain(acc);
      apply_mask<W>(acc, sc + (size_t)(MASK + jl * (W / 64)) * 128);
      put_ws<W>(wo, L.gz + jl * W, acc);
      if (jl > 0) colsum<W>(acc, rowf, -1, nv, red, buf, slot + C.bab + (jl - 1) * W);
    }
    // gz is appearance layer 0's z_bar: ba0, wp, wn, g_n, then g_feat
    colsum<W>(acc, rowf, -1, nv, red, buf, slot + C.ba0);
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
      colsum<W>(acc, rowf, RF_P + k, nv, red, buf, slot + C.wp + k * W);
      colsum<W>(acc, rowf, RF_N + k, nv, red, buf, slot + C.wn + k * W);
    }
    {
      float gn[3][2];
      row_dot3<W, false>(acc, p.wn, gn);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rowf[rl * ROWF + RF_GN + k] = gn[k][0];
        rowf[(rl + 8) * ROWF + RF_GN + k] = gn[k][1];
      }
    }
    to_afrag<W>(acc, a);
    c.product<W>(acc, a, false);             // g_feat = gz @ wf^T
    c.drain(acc);
    put_ws<W>(wo, L.gfeat, acc);
    colsum<W>(acc, rowf, -1, nv, red, buf, slot + C.b8f);
    to_afrag<W>(acc, a);
    c.product<W>(acc, a, false);             // g_feat @ w8f^T
    c.drain(acc);
    {
      // h_bar = g_feat @ w8f^T + g_logit w8l
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float2 w8 = __ldg(reinterpret_cast<const float2*>(p.w8l + 8 * j + 2 * t));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float gl = rowf[(rl + 8 * h) * ROWF + RF_GL];
          acc[4 * j + 2 * h] += gl * w8.x;
          acc[4 * j + 2 * h + 1] += gl * w8.y;
        }
      }
      store_scr<W>(sc + (size_t)HB * 128, acc);
    }
    bar_sync(BAR_WG + wg, 128);              // every row's g_n is in rowf

    // ---- tangent forward of the normal path: c_e = de * g_n[c % 3]
    for (int i = tw; i < ROWS * p.ke; i += 128) {
      const int r = i % ROWS, k = i / ROWS;
      const float v = r < nv ? __ldg(p.de + (size_t)(row0 + r) * p.ke + k) *
                                   rowf[r * ROWF + RF_GN + k % 3]
                             : 0.f;
      const bf16 b = __float2bfloat16_rn(v);
      ws[ws_idx(ld, L.ce + k, r0 + r)] = b;
      *reinterpret_cast<bf16*>(cet + (k >> 4) * A_KSTEP + (r >> 3) * 256 +
                               ((k >> 3) & 1) * 128 + (r & 7) * 16 +
                               (k & 7) * 2) = b;
    }
    fence_async_shared();
    bar_sync(BAR_WG + wg, 128);
    c.product_smem<W>(acc, cet, kes, false);
    c.drain(acc);
    store_scr<W>(sc + (size_t)TZ * 128, acc);
    mul_scr<W>(acc, sc);
    put_ws<W>(wo, L.t, acc);
    to_afrag<W>(acc, a);
#pragma unroll 1
    for (int li = 0; li < nt; ++li) {
      c.product<W>(acc, a, false);
      if (li == p.skip_pos) c.product_smem<W>(acc, cet, kes, true);
      c.drain(acc);
      store_scr<W>(sc + (size_t)(TZ + (li + 1) * H) * 128, acc);
      mul_scr<W>(acc, sc + (size_t)(li + 1) * H * 128);
      if (li < nt - 1) {
        put_ws<W>(wo, L.t + (li + 1) * W, acc);
        to_afrag<W>(acc, a);
      } else {
        // w8l's second half: the column sums of t_last
        colsum<W>(acc, rowf, -1, nv, red, buf, slot + C.w8l);
      }
    }

    // ---- doubled reverse sweep: (h_bar, t_bar) through s and s''
    set_cols<W>(acc, p.w8l);                 // t_bar
#pragma unroll 1
    for (int li = nt; li >= 0; --li) {
      const float* sp = sc + (size_t)li * H * 128;
      const float* tz = sc + (size_t)(TZ + li * H) * 128;
      const float* hb = sc + (size_t)HB * 128;
      float* tzbf = sc + (size_t)TZBF * 128;
      const int o_tzb = L.tzb + li * W;
      // z_bar = h_bar s + t_bar s'' tz -> acc; tz_bar = t_bar s -> the
      // workspace and its A fragments (scratch)
      wo.acquire();
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 4 * j + 2 * h + e;
            const float s = sp[q * 128], tb = acc[q];
            acc[q] = hb[q * 128] * s + tb * (100.f * s * (1.f - s)) * tz[q * 128];
            v[e] = tb * s;
            wo.stage(8 * j + 2 * t + e, rl + 8 * h, v[e]);
          }
          tzbf[(2 * j + h) * 128] = __uint_as_float(pack_bf16(v[0], v[1]));
        }
      wo.flush(o_tzb, W);
      put_ws<W>(wo, L.zb + li * W, acc);
      colsum<W>(acc, rowf, -1, nv, red, buf,
                slot + (li == 0 ? C.b0 : C.trunk_b + (li - 1) * W));
      if (li == 0) break;
      // h_bar = bf16(z_bar) @ W^T, then t_bar = bf16(tz_bar) @ W^T, each
      // over its own pass of the layer's slabs
      to_afrag<W>(acc, a);
      c.product<W>(acc, a, false);
      c.drain(acc);
      store_scr<W>(sc + (size_t)HB * 128, acc);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[kk][i] = __float_as_uint(tzbf[(4 * kk + i) * 128]);
      c.product<W>(acc, a, false);
      c.drain(acc);
    }
  }
  if (tw == 0) bulk_wait();              // the staging reads, the stores
}

// ------------------------------------- backward: the weight gradients

constexpr int GB = 128, GK = 128;          // tile rows and columns, stage points
constexpr int GSTAGES = 3;                 // stages in the ring
constexpr int TILE_BYTES = GB * GK * 2;    // one operand's stage tile
constexpr size_t WGRAD_SMEM = (size_t)GSTAGES * 2 * TILE_BYTES + 2 * GSTAGES * 8;

// One product x^T y over the chunk's points: x rows [x, x + r), y rows
// [y, y + c) of the workspace; a second segment (x2, y2) adds into the
// same sums (the trunk's a^T z_bar + t^T tz_bar). Its tiles are GB x GB;
// in a slot its product goes to [r x oc] at `out` (the first oc of its c
// columns).
struct WJob { int x, x2, y, y2, r, c, oc, rt, ct, tile0; long long out; };
struct WPlan { WJob job[16]; int n_jobs, n_tiles; long long p_floats, c_floats;
               long long slot_floats; long long leaf[18]; };

// The jobs, and a split-K slot (and the gradients' flat buffer, the
// slots' sum) leaf after leaf: the products' region (p_floats) trunk_w,
// w0, wskip, w8f, wa, [wf; wv] (one product's rows), wa4 (3 of the rgb
// head's 8 columns), then the column sums' region (cs_layout, c_floats). leaf[] holds each
// gradient's offset in the packed order (w0, b0, wskip, trunk_w, trunk_b,
// w8f, b8f, w8l, b8l, wp, wv, wn, wf, ba0, wa, bab, wa4, ba4); ops/
// fused_radiance.py `bf16_slot_layout` mirrors it.
__host__ WPlan wplan(int w, int ke, int kv, int nt, int skip) {
  const WsRows L = ws_rows(w, ke, kv, nt);
  const CsLayout C = cs_layout(w, nt);
  WPlan P = {};
  const long long ww = (long long)w * w;
  long long at = 0;
  auto take = [&](long long floats) { at += floats; return at - floats; };
  const long long tw = take(nt * ww), w0 = take((long long)ke * w);
  const long long wsk = take((long long)ke * w), w8f = take(ww);
  const long long wa = take(3 * ww), app = take((long long)(w + kv) * w);
  const long long wa4 = take(3 * w);
  at = (at + 3) / 4 * 4;
  P.p_floats = at;
  P.c_floats = C.floats;
  P.slot_floats = P.p_floats + P.c_floats;
  const long long c0 = at;
  const long long leaf[18] = {
      w0, c0 + C.b0, wsk, tw, c0 + C.trunk_b, w8f, c0 + C.b8f, c0 + C.w8l,
      c0 + C.b8l, c0 + C.wp, app + ww, c0 + C.wn, app, c0 + C.ba0, wa,
      c0 + C.bab, wa4, c0 + C.ba4};
  for (int i = 0; i < 18; ++i) P.leaf[i] = leaf[i];
  auto add = [&](int x, int x2, int y, int y2, int r, int c, int oc,
                 long long out) {
    WJob& J = P.job[P.n_jobs++];
    J.x = x; J.x2 = x2; J.y = y; J.y2 = y2; J.r = r; J.c = c; J.oc = oc;
    J.rt = (r + GB - 1) / GB;
    J.ct = (c + GB - 1) / GB;
    J.tile0 = P.n_tiles;
    P.n_tiles += J.rt * J.ct;
    J.out = out;
  };
  for (int i = 1; i <= nt; ++i)
    add(L.a + (i - 1) * w, L.t + (i - 1) * w, L.zb + i * w, L.tzb + i * w,
        w, w, w, tw + (i - 1) * ww);
  add(L.em, L.ce, L.zb, L.tzb, ke, w, w, w0);
  add(L.em, L.ce, L.zb + (skip + 1) * w, L.tzb + (skip + 1) * w, ke, w, w,
      wsk);
  add(L.a + nt * w, -1, L.gfeat, -1, w, w, w, w8f);
  for (int j = 0; j < 3; ++j)
    add(L.aa + j * w, -1, L.gz + (j + 1) * w, -1, w, w, w, wa + j * ww);
  add(L.feat, -1, L.gz, -1, w + kv, w, w, app);
  add(L.aa + 3 * w, -1, L.g8, -1, w, 8, 3, wa4);
  return P;
}

// wgmma descriptor of a stage tile: K-major core matrices, 128 bytes apart
// along K (8 points), GK * 16 bytes apart along the rows (8 features)
__device__ __forceinline__ uint64_t stage_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((GK * 16) >> 4) << 32);
}

// Each CTA: one GB x GB output tile of one job over its split's points,
// GK points a stage. One producer thread copies each stage's 8-feature
// groups (2 KB each) by cp.async.bulk into a ring of GSTAGES stages; each
// consumer warpgroup owns 64 rows of the tile: a stage's eight wgmma
// m64n128k16 chain in the tensor core from zero, and while the next
// stage's run, FADD adds the stage into the accumulator and its slot is
// freed (two product buffers; setmaxnreg gives the consumers 240
// registers, the producer 24).
__global__ void __launch_bounds__(NTHREADS, 1)
    wgrad_kernel(const __grid_constant__ WPlan plan, const bf16* __restrict__ ws,
                 long long ld, int kpts, float* partial, int slot0,
                 const float* __restrict__ colsums, int cs_slots, int fold) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GSTAGES * 2 * TILE_BYTES);
  uint64_t* empty = full + GSTAGES;
  int jb = 0;
  while (jb + 1 < plan.n_jobs && (int)blockIdx.x >= plan.job[jb + 1].tile0)
    ++jb;
  const WJob& J = plan.job[jb];
  const int local = blockIdx.x - J.tile0;
  const int rt = local / J.ct, ct = local % J.ct;
  const int s = blockIdx.y, S = gridDim.y;
  const int nk = kpts / GK;
  const int k_beg = (int)((long long)nk * s / S);
  const int per = (int)((long long)nk * (s + 1) / S) - k_beg;
  const int nit = (J.x2 >= 0 ? 2 : 1) * per;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int i = 0; i < GSTAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NCONS) {                       // producer
    set_max_regs_dec<24>();
    if (tw == 0) {
      // 8-feature groups of the tile that lie inside the job's rows
      const int xg = min(GB, J.r - rt * GB) / 8, yg = min(GB, J.c - ct * GB) / 8;
      const uint32_t bytes = (uint32_t)(xg + yg) * GK * 16;
      for (int it = 0; it < nit; ++it) {
        const int st = it % GSTAGES;
        if (it >= GSTAGES) mbar_wait(empty + st, ((it / GSTAGES) & 1) ^ 1);
        const int seg = it / per, p0 = (k_beg + it % per) * GK;
        const int xo = (seg ? J.x2 : J.x) + rt * GB, yo = (seg ? J.y2 : J.y) + ct * GB;
        unsigned char* xs = smem + st * 2 * TILE_BYTES;
        unsigned char* ys = xs + TILE_BYTES;
        mbar_expect_tx(full + st, bytes);
        for (int g = 0; g < xg; ++g)
          bulk_load(xs + g * GK * 16, ws + ws_idx(ld, xo + 8 * g, p0), GK * 16,
                    full + st);
        for (int g = 0; g < yg; ++g)
          bulk_load(ys + g * GK * 16, ws + ws_idx(ld, yo + 8 * g, p0), GK * 16,
                    full + st);
      }
    }
    return;
  }

  // a warpgroup whose 64 rows lie past the job's rows (a ragged last row
  // tile) skips its products
  set_max_regs_inc<240>();
  const bool active = rt * GB + wg * 64 < J.r;
  float acc[64], d0[64], d1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // stage it's products, started from zero, into d (one commit group)
  auto issue = [&](int it, float (&d)[64]) {
    const int st = it % GSTAGES;
    mbar_wait(full + st, (it / GSTAGES) & 1);
    if (active) {
      const unsigned char* xs = smem + st * 2 * TILE_BYTES + wg * 8 * GK * 16;
      const unsigned char* ys = smem + st * 2 * TILE_BYTES + TILE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < GK / 16; ++ks)
        Mma<128>::ss(d, stage_desc(xs + ks * 256), stage_desc(ys + ks * 256),
                     ks > 0 ? 1 : 0);
      wgmma_commit();
    }
  };
  // once stage it's group has completed: FADD it into acc, free its slot
  auto finish = [&](int it, float (&d)[64]) {
    if (active) {
      reg_fence(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
    }
    if (tw == 0) mbar_arrive(empty + it % GSTAGES);
  };
  // the next stage's products run while this one's are added
  if (nit > 0) issue(0, d0);
  for (int it = 0; it < nit; it += 2) {
    if (it + 1 < nit) {
      issue(it + 1, d1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    finish(it, d0);
    if (it + 1 < nit) {
      if (it + 2 < nit) {
        issue(it + 2, d0);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      finish(it + 1, d1);
    }
  }
  float* const slot = partial + (size_t)(slot0 + s) * plan.slot_floats;
  float* out = slot + J.out;
  const int rl = row_lo(), t = tw & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rt * GB + wg * 64 + rl + 8 * (r >> 1);
      const int col = ct * GB + 8 * j + 2 * t + (r & 1);
      if (row < J.r && col < J.oc) out[(size_t)row * J.oc + col] = acc[4 * j + r];
    }
  // the split's column-sum region: its share of the column-sum slots
  // added in order (fold, after the last chunk's sweep), else zeros
  if (blockIdx.x == 0) {
    const long long n4 = plan.c_floats / 4;
    const int b0 = (int)((long long)cs_slots * s / S);
    const int b1 = (int)((long long)cs_slots * (s + 1) / S);
    const float4* src = reinterpret_cast<const float4*>(colsums);
    float4* dst = reinterpret_cast<float4*>(slot + plan.p_floats);
    for (long long i = threadIdx.x; i < n4; i += NCONS * 128) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (fold)
        for (int k = b0; k < b1; ++k) slot_reduce::add4(v, __ldg(src + (size_t)k * n4 + i));
      dst[i] = v;
    }
  }
}

// ------------------------------------------------------------- launches

bool dims_ok(int w, int ke, int kv, int nt) {
  return (w == 128 || w == 256) && ke > 0 && ke % 16 == 0 && ke <= 64 &&
         kv > 0 && kv % 16 == 0 && kv <= 64 && nt >= 1 && nt < MAXL;
}

// scratch words of one consumer thread
int scr_words(int w, int nt, bool sweep) {
  return sweep ? (2 * (nt + 1) + 1) * (w / 2) + w / 4 + 3 * (w / 64)
               : (nt + 2) * (w / 2);
}

template <int W, bool SWEEP>
cudaError_t launch_engine(RParams p, int slots, cudaStream_t stream) {
  const ConsSmem S = cons_smem(W, p.ke, p.kv, SWEEP);
  const size_t fixed = (size_t)NCONS * S.bytes;
  p.ring = ring_slots(fixed, (size_t)W * 32);
  if (p.ring < LAG + 2) return cudaErrorInvalidValue;
  const size_t smem = ring_bytes(p.ring, W) + fixed + 2 * MAX_RING * sizeof(uint64_t);
  auto kernel = SWEEP ? sweep_kernel<W> : fwd_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.n + TROWS - 1) / TROWS;
  kernel<<<tiles < slots ? tiles : slots, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

RParams point_params(void* const* ptrs, int& k) {
  RParams p = {};
  auto fp = [&]() { return static_cast<const float*>(ptrs[k++]); };
  p.em = static_cast<const bf16*>(ptrs[k++]);
  p.vpe = static_cast<const bf16*>(ptrs[k++]);
  p.de = fp(); p.p3 = fp();
  return p;
}

void weight_params(RParams& p, void* const* ptrs, int& k) {
  auto fp = [&]() { return static_cast<const float*>(ptrs[k++]); };
  p.slabs = static_cast<const unsigned char*>(ptrs[k++]);
  p.b0 = fp(); p.trunk_b = fp(); p.b8f = fp(); p.w8l = fp(); p.b8l = fp();
  p.wp = fp(); p.wn = fp(); p.ba0 = fp(); p.bab = fp(); p.wa4t = fp();
  p.ba4 = fp();
}

}  // namespace

// Sizes of one shape (ints: width, ke, kv, n_trunk): out[0] bytes of the
// packed slabs, out[1] workspace rows, out[2] forward and out[3] sweep
// scratch floats per CTA, out[4] floats of a split-K slot (the products'
// region), out[5] floats of a column-sum slot, out[6] weight-gradient
// tiles, out[7 .. 24] each gradient's offset in the flat buffer (the
// products' region, then the column sums'), in the packed order.
extern "C" int psnerf_radiance_sizes(const int* ints, long long* out) {
  const int w = ints[0], ke = ints[1], kv = ints[2], nt = ints[3];
  if (!dims_ok(w, ke, kv, nt)) return (int)cudaErrorInvalidValue;
  const WPlan P = wplan(w, ke, kv, nt, 0);
  out[0] = mats(w, ke, kv, nt).total;
  out[1] = ws_rows(w, ke, kv, nt).rows;
  out[2] = (long long)NCONS * 128 * scr_words(w, nt, false);
  out[3] = (long long)NCONS * 128 * scr_words(w, nt, true);
  out[4] = P.p_floats;
  out[5] = P.c_floats;
  out[6] = P.n_tiles;
  for (int i = 0; i < 18; ++i) out[7 + i] = P.leaf[i];
  return 0;
}

// Each returns a cudaError_t (0 = cudaSuccess).
// ptrs: em, vpe (bf16), de, p3, the packed slabs, b0, trunk_b, b8f, w8l,
// b8l, wp, wn, ba0, bab, wa4t ([3, W], the rgb head's bf16 values in f32),
// ba4, then out, g_e, scratch. ints: n, width, ke, kv, n_trunk, skip_pos,
// slots (the grid is min(tiles of 128 points, slots)).
extern "C" int psnerf_radiance_fwd(void* const* ptrs, const int* ints,
                                   void* stream) {
  const int w = ints[1], ke = ints[2], kv = ints[3], nt = ints[4];
  if (!dims_ok(w, ke, kv, nt) || ints[5] < 0 || ints[5] >= nt || ints[6] < 1)
    return (int)cudaErrorInvalidValue;
  int k = 0;
  RParams p = point_params(ptrs, k);
  weight_params(p, ptrs, k);
  p.out = static_cast<float*>(ptrs[k++]);
  p.g_e = static_cast<float*>(ptrs[k++]);
  p.scratch = static_cast<float*>(ptrs[k++]);
  p.n = ints[0]; p.ke = ke; p.kv = kv; p.n_trunk = nt; p.skip_pos = ints[5];
  p.scr_words = scr_words(w, nt, false);
  p.sched = sched_fwd(w, ke, kv, nt, p.skip_pos);
  if (p.n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(w == 128 ? launch_engine<128, false>(p, ints[6], s)
                        : launch_engine<256, false>(p, ints[6], s));
}

// ptrs: em, vpe, de, p3, the packed slabs, b0 .. ba4 (as the forward's),
// g_e, g_out, the workspace (bf16), the column-sum slots (NCONS per CTA
// of the grid, zeroed by the caller before the first chunk: every chunk
// adds its sums onto them), scratch. ints: n (the chunk's points),
// row_begin, ld (the workspace's points, a multiple of 128), width, ke,
// kv, n_trunk, skip_pos, slots.
extern "C" int psnerf_radiance_sweep(void* const* ptrs, const int* ints,
                                     void* stream) {
  const int w = ints[3], ke = ints[4], kv = ints[5], nt = ints[6];
  if (!dims_ok(w, ke, kv, nt) || ints[7] < 0 || ints[7] >= nt ||
      ints[8] < 1 || ints[2] % TROWS || ints[2] < ints[0])
    return (int)cudaErrorInvalidValue;
  int k = 0;
  RParams p = point_params(ptrs, k);
  weight_params(p, ptrs, k);
  p.g_e_in = static_cast<const float*>(ptrs[k++]);
  p.g_out = static_cast<const float*>(ptrs[k++]);
  p.ws = static_cast<bf16*>(ptrs[k++]);
  p.colsum = static_cast<float*>(ptrs[k++]);
  p.scratch = static_cast<float*>(ptrs[k++]);
  p.n = ints[0]; p.row_begin = ints[1]; p.ld = ints[2];
  p.ke = ke; p.kv = kv; p.n_trunk = nt; p.skip_pos = ints[7];
  p.scr_words = scr_words(w, nt, true);
  p.sched = sched_sweep(w, ke, kv, nt, p.skip_pos);
  if (p.n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(w == 128 ? launch_engine<128, true>(p, ints[8], s)
                        : launch_engine<256, true>(p, ints[8], s));
}

// ptrs: the workspace, the split-K slots, the column-sum slots. ints: kpts
// (the chunk's points rounded up to 128), ld, width, ke, kv, n_trunk,
// skip_pos, splits, slot0, the column-sum slots, fold (1 after the last
// chunk's sweep: the splits add the column-sum slots into their slots).
extern "C" int psnerf_radiance_wgrad(void* const* ptrs, const int* ints,
                                     void* stream) {
  const int w = ints[2], ke = ints[3], kv = ints[4], nt = ints[5];
  if (!dims_ok(w, ke, kv, nt) || ints[0] % TROWS || ints[0] > ints[1] ||
      ints[1] % TROWS || ints[7] < 1 || ints[6] < 0 || ints[6] >= nt ||
      ints[9] < 0)
    return (int)cudaErrorInvalidValue;
  const WPlan P = wplan(w, ke, kv, nt, ints[6]);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WGRAD_SMEM);
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<<<dim3(P.n_tiles, ints[7]), NTHREADS, WGRAD_SMEM,
                 static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const bf16*>(ptrs[0]), ints[1], ints[0],
      static_cast<float*>(ptrs[1]), ints[8],
      static_cast<const float*>(ptrs[2]), ints[9], ints[10]);
  return (int)cudaGetLastError();
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
