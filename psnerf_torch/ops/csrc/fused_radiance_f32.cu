// Fused radiance+alpha in the f32-operand form (compute="float32", the
// default field's), forward and second-order backward, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of psnerf_tpu/ops/fused_radiance.py
// (fused_radiance_and_alpha) at wdt = float32: the forward (_fwd_kernel,
// pallas_call at :390) and the backward (_bwd_kernel, :410). Nothing is
// rounded below f32, as in the TPU kernel at wdt = f32; every product runs
// as 3xTF32 on wgmma (x = hi + lo, both tf32; lo.hi' + hi.lo' + hi.hi',
// ~2^-22 of |x x'|). The tensor core's own f32 accumulation does not round
// to nearest (chained over a depth-256 product it drifted from an f64
// reference an order of magnitude further than plain f32), so a short run
// of products (a pair of k-steps in the tile products, a 32-point stage in
// the weight gradients) starts from zero and FADD adds it into the
// accumulator.
//
// Five kernels, launched by ops/fused_radiance.py:
//   * split_kernel (prologue, once per forward and per backward): every
//     product weight, in each orientation the products read (w and w^T),
//     split into tf32 hi and lo with the same cvt.rna as the products, and
//     stored as k-step slabs in wgmma's K-major core-matrix layout, so a
//     warpgroup copies its columns of a k-step as two contiguous runs. 24
//     W x W matrices at W = 256: 12.6 MB, L2-resident.
//   * fwd_kernel (K2): geometry trunk -> feature and logit, reverse sweep
//     g_e = d logit / d emb, normals, appearance MLP -> pre-tanh rgb.
//   * sweep_kernel (K3, part 1): recompute with the saved g_e, appearance
//     backward, tangent forward of the normal path, and the doubled reverse
//     sweep carrying (h_bar, t_bar) through softplus'' = 100 s (1 - s). It
//     computes no weight gradient: it writes the operand pair of every
//     weight-gradient product, f32, to a device workspace in K-major
//     [feature][point] layout (WsLayout below: ~42 W + 2 ke + kv + 14
//     floats per point, 43.6 KB at W = 256).
//   * wgrad_kernel (K3, part 2): every weight gradient x^T y (and the
//     bias-like column sums of y) as 3xTF32 wgmma products of depth K =
//     points, split-K over CTAs: each CTA writes its partial tile to its
//     own slot, with no atomics. Each 32-point stage's twelve wgmma chain
//     in the tensor core and FADD adds the stage into the accumulator.
//   * the reduce (K3, part 3): the slot reduction engine (slot_reduce.cuh)
//     sums the slots in fixed order into one flat buffer, of which the 18
//     gradients are views: each slot is laid out leaf after leaf
//     (wplan), so the sum needs no scatter. The f32 backward is
//     deterministic from run to run.
//
// What bounds it: operations. Per point the forward runs ~19 and the
// backward ~57 products of 2 W^2 FLOPs (W = 256), three tf32 products each:
// at 495 TFLOP/s that is 3.1 and 9.2 ms at 196,608 points. The backward's
// workspace (43.6 KB per point, written once by the sweep and read about
// twice by the weight-gradient tiles) moves ~26 GB at that size, 7.7 ms at
// 3.35 TB/s; it overlaps the products only within each kernel.
//
// Design against what held the single-kernel form back (PERF.md, §6):
//   * the per-tile weight-gradient products and their f32 atomicAdd (32%
//     of its backward) leave the sweep for wgrad_kernel: 128 x 128 output
//     tiles over a K of up to 65,536 points (wgmma m64n128k8, both operands
//     K-major in shared memory), the operands streamed from the workspace
//     by cp.async and split once, the next 32-point stage split while the
//     current one's products run, the tiles' sums written to per-split
//     slots;
//   * weights split once per launch (prologue). In the forward and the
//     sweep each warpgroup owns half the columns of a 64-point tile (wgmma
//     m64nNk8, A from registers: each warp its 16 rows) and streams its
//     columns' k-step slabs through its own 4-slab cp.async ring in shared
//     memory, a pair of k-steps ahead, with one warpgroup barrier and one
//     wait per pair;
//   * activation tiles split once when written (put_split), kept as
//     (hi, lo) pairs in shared memory, not split again at every k-step;
//   * the shared memory the transposed gradient tiles took goes to a
//     64-point tile (twice the points per weight byte of the 32-point
//     form) and the rings. The narrow operand tiles (embeddings, view PE,
//     tangents) share one f32 tile, split at load: their products are 1/20
//     of the work.
//
// ptxas reports registers, spills and shared memory per instantiation
// into ops/_build/fused_radiance_f32.ptxas.txt.

#include "mma_tile.cuh"
#include "slot_reduce.cuh"

using namespace psnerf;

namespace {

constexpr int TBM = 64;              // points per tile
constexpr int MI = 1;                // row blocks of 16 a warp owns
constexpr int LDK = 64 + 4;          // narrow f32 tiles (ke, kv <= 64)
constexpr int ROWF = 16;             // per-point f32 values in shared memory
// ROWF slots: 0-2 p, 3 logit (fwd) / g_logit (bwd), 4-6 n, 7-9 g_n,
// 10-12 g_rgb
constexpr int RF_P = 0, RF_L = 3, RF_N = 4, RF_GN = 7, RF_GRGB = 10;
constexpr int MAXL = 8;              // trunk layers + 1, at most
// per-CTA scratch, in tiles of TBM x W f32 values (fragment layout):
// forward s' per layer and feat @ wf; sweep s', tz per layer and h_bar
constexpr int F_ZF = MAXL, N_FWD = MAXL + 1;
constexpr int F_SP = 0, F_TZ = MAXL, F_HB = 2 * MAXL, N_SWP = 2 * MAXL + 1;
constexpr int GB = 128, GK = 32;   // wgrad tile (rows, columns), stage points
constexpr int RING = 4;        // k-step slabs in a warpgroup's ring

// ---------------------------------------------------------------- layouts

// The split weights (k-step slabs, split_kernel), offsets in 16-byte
// units. A [K][N] operand takes K N / 2 units. Mirrored by
// ops/fused_radiance.py (split_weights_plain), which lists the same
// matrices in the same order.
struct Frags {
  const uint4 *w0, *wskip, *trunk, *w8f, *wv, *wf, *wa, *wa4;  // B = w
  const uint4 *w0T, *wskipT, *trunkT, *w8fT, *wfT, *waT;       // B = w^T
};

struct FragMat { int src, tr, k, n, n_real; long long off; };
// src: 0 w0, 1 wskip, 2 trunk, 3 w8f, 4 wv, 5 wf, 6 wa, 7 wa4; stacked
// sources (trunk, wa) list one entry per matrix, `which` below.
struct FragList { FragMat m[32]; int which[32]; int count; long long total; };

__host__ FragList frag_list(int w, int ke, int kv, int nt) {
  FragList L = {};
  auto add = [&](int src, int which, int tr, int k, int n, int n_real) {
    FragMat& m = L.m[L.count];
    m.src = src; m.tr = tr; m.k = k; m.n = n; m.n_real = n_real;
    m.off = L.total;
    L.which[L.count++] = which;
    L.total += (long long)k * n / 2;
  };
  add(0, 0, 0, ke, w, w);
  add(1, 0, 0, ke, w, w);
  for (int i = 0; i < nt; ++i) add(2, i, 0, w, w, w);
  add(3, 0, 0, w, w, w);
  add(4, 0, 0, kv, w, w);
  add(5, 0, 0, w, w, w);
  for (int j = 0; j < 3; ++j) add(6, j, 0, w, w, w);
  add(7, 0, 0, w, 8, 3);
  add(0, 0, 1, w, 64, ke);
  add(1, 0, 1, w, 64, ke);
  for (int i = 0; i < nt; ++i) add(2, i, 1, w, w, w);
  add(3, 0, 1, w, w, w);
  add(5, 0, 1, w, w, w);
  for (int j = 0; j < 3; ++j) add(6, j, 1, w, w, w);
  return L;
}

__host__ Frags frags_at(const uint4* base, int w, int ke, int kv, int nt) {
  const FragList L = frag_list(w, ke, kv, nt);
  Frags f;
  int k = 0;
  f.w0 = base + L.m[k++].off;
  f.wskip = base + L.m[k++].off;
  f.trunk = base + L.m[k].off; k += nt;
  f.w8f = base + L.m[k++].off;
  f.wv = base + L.m[k++].off;
  f.wf = base + L.m[k++].off;
  f.wa = base + L.m[k].off; k += 3;
  f.wa4 = base + L.m[k++].off;
  f.w0T = base + L.m[k++].off;
  f.wskipT = base + L.m[k++].off;
  f.trunkT = base + L.m[k].off; k += nt;
  f.w8fT = base + L.m[k++].off;
  f.wfT = base + L.m[k++].off;
  f.waT = base + L.m[k].off;
  return f;
}

// The workspace: row offsets (one row = one feature over the chunk's
// points, row stride ld points). The app0 block [feat; vpe; p3; n3] is
// contiguous: one product's x rows. Mirrored by ops/fused_radiance.py.
struct WsLayout {
  int feat, vpe, p3, n3, em, ce, a, t, aa, gz, gfeat, w8lt, g8, zb, tzb,
      rows;
};

__host__ __device__ WsLayout ws_layout(int w, int ke, int kv, int nt) {
  WsLayout L;
  L.feat = 0; L.vpe = w; L.p3 = w + kv; L.n3 = L.p3 + 3; L.em = L.n3 + 3;
  L.ce = L.em + ke; L.a = L.ce + ke; L.t = L.a + (nt + 1) * w;
  L.aa = L.t + nt * w; L.gz = L.aa + 4 * w; L.gfeat = L.gz + 4 * w;
  L.w8lt = L.gfeat + w; L.g8 = L.w8lt + w; L.zb = L.g8 + 8;
  L.tzb = L.zb + (nt + 1) * w; L.rows = L.tzb + (nt + 1) * w;
  return L;
}

struct Params {
  const float *em, *de, *vpe, *p3, *g_e_in, *g_out;
  const float *b0, *trunk_b, *b8f, *w8l, *b8l, *wp, *wn, *ba0, *bab, *ba4,
      *wa4;
  Frags f;
  float *out, *g_e;                  // forward outputs
  float* ws;                         // sweep: the workspace
  float* scratch;
  int n, row_begin, ld_ws, ke, kv, n_trunk, skip_pos;
};

// ------------------------------------------------------------ tile product

__device__ __forceinline__ void a_frag(const uint2* pa, int lda,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const uint2 x0 = pa[0], x1 = pa[8 * lda], x2 = pa[4], x3 = pa[8 * lda + 4];
  ah[0] = x0.x; ah[1] = x1.x; ah[2] = x2.x; ah[3] = x3.x;
  al[0] = x0.y; al[1] = x1.y; al[2] = x2.y; al[3] = x3.y;
}

__device__ __forceinline__ void a_frag(const float* pa, int lda,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_tf32(pa[0], ah[0], al[0]);
  split_tf32(pa[8 * lda], ah[1], al[1]);
  split_tf32(pa[4], ah[2], al[2]);
  split_tf32(pa[8 * lda + 4], ah[3], al[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The weight rings at the start of shared memory: per warpgroup RING
// k-steps of its columns' slab (hi and lo parts, up to 128 columns x 8 k).
constexpr int RSLOT = 128 * 8 * 4 * 2;          // bytes of one ring slot
constexpr size_t RING_BYTES = (size_t)2 * RING * RSLOT;

// the row of fragment element (i, r) in the tile: warp w of a warpgroup
// owns rows 16 (w % 4) .. + 15 (the wgmma accumulator layout)
__device__ __forceinline__ int frow(int i, int r) {
  return ((threadIdx.x >> 5) & 3) * 16 + frag_row(i, r);
}

// a barrier of the 128 threads of this thread's warpgroup
__device__ __forceinline__ void wg_bar() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// wgmma shared-memory descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes, lbo bytes apart along K, sbo bytes apart
// along the rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= A[64 x 8] B[128 x 8]^T, tf32, by the warpgroup (scale_d 0: d =)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A[64 x 8] B[N x 8]^T, tf32, A from registers (each warp its 16
// rows, the mma.sync m16n8k8 A fragment), B K-major in shared memory
template <int N> struct Wgmma;
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
template <> struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// acc (+)= act[0:TBM, 0:8 ks_n] @ B[:, col0 : col0 + NW] by this thread's
// warpgroup, B a split weight of ncols columns in k-step slabs (prologue
// layout). act: (hi, lo) pairs or f32 (split here) in shared memory, row
// stride lda. The warpgroup streams its columns' slabs through its ring
// with cp.async, a pair of k-steps ahead; each pair's six wgmma chain in
// the tensor core and FADD adds them into the accumulator.
template <int NW, typename A>
__device__ __forceinline__ void wg_gemm(const A* act, int lda, int ks_n,
                                        const uint4* __restrict__ slabs,
                                        int ncols, int col0,
                                        float (&acc)[MI][NW / 8][4],
                                        bool zero) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PART_U = NW * 2;       // 16-byte units of a hi or lo part
  const int tw = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 3;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  unsigned char* ring = smem + (size_t)wg * RING * RSLOT;
  if (zero) zero_acc(acc);
  // slab ks: hi [0, 2 ncols) and lo [2 ncols, 4 ncols) units; this
  // warpgroup's columns are 2 NW units of each from col0 / 8 * 16
  const uint4* src = slabs + (size_t)(col0 / 8) * 16;
  auto issue = [&](int ks) {          // slab ks into ring slot ks % RING
    if (ks < ks_n) {
      uint4* dst = reinterpret_cast<uint4*>(ring + (ks % RING) * RSLOT);
      const uint4* s0 = src + (size_t)ks * 4 * ncols;
      for (int u = tw; u < 2 * PART_U; u += 128) {
        const int part = u >= PART_U;
        cp_async16(dst + u, s0 + part * 2 * ncols + (u - part * PART_U));
      }
    }
  };
  // k-steps go in pairs (ks_n is even): one commit group, one barrier and
  // one wait per pair; the pair after next streams in meanwhile
  issue(0);
  issue(1);
  cp_async_commit();
  issue(2);
  issue(3);
  cp_async_commit();
#pragma unroll 1
  for (int ks = 0; ks < ks_n; ks += 2) {
    cp_async_wait<1>();
    fence_async_shared();
    wg_bar();                        // the warpgroup's copies of the pair
    float d[NW / 2];
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ah[4], al[4];
      a_frag(act + row * lda + (ks + h) * 8 + t, lda, ah, al);
      const unsigned char* slot = ring + ((ks + h) % RING) * RSLOT;
      const uint64_t bh = smem_desc(slot, 128, 256);
      const uint64_t bl = smem_desc(slot + PART_U * 16, 128, 256);
      Wgmma<NW>::run(d, al, bh, h);
      Wgmma<NW>::run(d, ah, bl, 1);
      Wgmma<NW>::run(d, ah, bh, 1);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[0][j][r] += d[4 * j + r];
    issue(ks + 4);                   // into the pair's slots, now read
    issue(ks + 5);
    cp_async_commit();
  }
}

// Row sums of v * w[col] over this warpgroup's columns, into
// red[wg * TBM + row]; the caller adds the two warpgroups' after a barrier.
template <int NT>
__device__ __forceinline__ void rowsum_wg(const float (&v)[MI][NT][4],
                                          const float* __restrict__ w,
                                          int n_base, float* red) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = frag_col(n_base, j, 0);
      s += v[0][j][2 * h] * __ldg(w + col) + v[0][j][2 * h + 1] * __ldg(w + col + 1);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if ((threadIdx.x & 3) == 0) red[(threadIdx.x >> 7) * TBM + frow(0, 2 * h)] = s;
  }
}

// act[row][col] = split(v) for this thread's fragment elements
template <int NT>
__device__ __forceinline__ void put_split(uint2* act, int lda,
                                          const float (&v)[MI][NT][4],
                                          int n_base) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t h0, l0, h1, l1;
        split_tf32(v[i][j][2 * h], h0, l0);
        split_tf32(v[i][j][2 * h + 1], h1, l1);
        const int row = frow(i, 2 * h), col = frag_col(n_base, j, 0);
        *reinterpret_cast<uint4*>(act + row * lda + col) =
            make_uint4(h0, l0, h1, l1);
      }
}

// thread-private scratch: element q of this thread's fragment
__device__ __forceinline__ size_t sq(int q) {
  return (size_t)q * NTHREADS + threadIdx.x;
}

template <int NT>
__device__ __forceinline__ int fq(int i, int j, int r) {
  return (i * NT + j) * 4 + r;
}

// workspace rows [off + col][r0 + row] = v (0 past the nv valid rows)
template <int NT>
__device__ __forceinline__ void put_ws(float* ws, int ld, int off,
                                       const float (&v)[MI][NT][4],
                                       int n_base, int r0, int nv) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = frow(i, r), col = frag_col(n_base, j, r);
        ws[(size_t)(off + col) * ld + r0 + row] = row < nv ? v[i][j][r] : 0.f;
      }
}

__device__ __forceinline__ float ws_at(const float* ws, int ld, int off,
                                       int col, int r) {
  return ws[(size_t)(off + col) * ld + r];
}

// [TBM, cols] rows of a [N, cols] f32 input into a shared tile (zeros past
// nv valid rows)
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int cols, int row0, int nv) {
  const int kw = cols / 2;
  for (int idx = threadIdx.x; idx < TBM * kw; idx += NTHREADS) {
    const int r = idx / kw, c = (idx % kw) * 2;
    float2 v = make_float2(0.f, 0.f);
    if (r < nv)
      v = __ldg(reinterpret_cast<const float2*>(src + (size_t)(row0 + r) * cols + c));
    *reinterpret_cast<float2*>(dst + r * LDK + c) = v;
  }
}

// a shared [TBM, cols] tile into workspace rows off .. off + cols
__device__ __forceinline__ void tile_to_ws(float* ws, int ld, int off,
                                           const float* src, int ldsrc,
                                           int cols, int r0) {
  for (int idx = threadIdx.x; idx < TBM * cols; idx += NTHREADS) {
    const int c = idx / TBM, r = idx % TBM;
    ws[(size_t)(off + c) * ld + r0 + r] = src[r * ldsrc + c];
  }
}

__device__ __forceinline__ void sp_sig(float x, float& sp, float& sg) {
  const float bx = 100.f * x;
  const float e = expf(-fabsf(bx));
  sp = (fmaxf(bx, 0.f) + log1pf(e)) / 100.f;
  const float inv = 1.f / (1.f + e);
  sg = bx >= 0.f ? inv : e * inv;
}

// the geometry trunk's forward over the tile in ems; leaves a_last in acc
// and split(a_last) in act; s' per layer into spbuf; with ws, every
// activation into the workspace
template <int W>
__device__ __forceinline__ void trunk_forward(const Params& p, uint2* act,
                                              const float* ems,
                                              float (&acc)[MI][W / 16][4],
                                              float* spbuf, float* ws,
                                              int r0, int nv) {
  constexpr int NT = W / 16, LDA = W + 4, KS = W / 8;
  constexpr size_t TILE = (size_t)TBM * W;
  const int n_base = (threadIdx.x >> 7) * (W / 2);
  const WsLayout L = ws_layout(W, p.ke, p.kv, p.n_trunk);
  for (int li = 0; li <= p.n_trunk; ++li) {
    if (li == 0) {
      wg_gemm<W / 2>(ems, LDK, p.ke / 8, p.f.w0, W, n_base, acc, true);
    } else {
      wg_gemm<W / 2>(act, LDA, KS, p.f.trunk + (size_t)(li - 1) * W * W / 2, W, n_base, acc, true);
      if (li - 1 == p.skip_pos)
        wg_gemm<W / 2>(ems, LDK, p.ke / 8, p.f.wskip, W, n_base, acc, false);
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
        }
    if (ws) put_ws<NT>(ws, p.ld_ws, L.a + li * W, acc, n_base, r0, nv);
    put_split<NT>(act, LDA, acc, n_base);
    __syncthreads();
  }
}

// appearance layer 0 epilogue: relu(acc + ba0 + sum_j p_j wp[j] + n_j wn[j])
template <int W>
__device__ __forceinline__ void app0_epilogue(const Params& p,
                                              float (&acc)[MI][W / 16][4],
                                              const float* rowf, int n_base) {
  constexpr int NT = W / 16;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = frow(i, r), col = frag_col(n_base, j, r);
        float z = acc[i][j][r] + __ldg(p.ba0 + col);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          z = z + rowf[row * ROWF + RF_P + c] * __ldg(p.wp + c * W + col);
          z = z + rowf[row * ROWF + RF_N + c] * __ldg(p.wn + c * W + col);
        }
        acc[i][j][r] = fmaxf(z, 0.f);
      }
}

// n[row][j] = sum over columns c % 3 == j of g_e[row][c] * de[row][c]
__device__ __forceinline__ void normals(const Params& p, const float* ge,
                                        float* rowf, int row0, int nv) {
  const int tid = threadIdx.x;
  if (tid < TBM * 3) {
    const int row = tid / 3, j = tid % 3;
    float s = 0.f;
    if (row < nv) {
      const float* de = p.de + (size_t)(row0 + row) * p.ke;
      const float* g = ge + (size_t)(row0 + row) * p.ke;
      for (int c = j; c < p.ke; c += 3) s += g[c] * __ldg(de + c);
    }
    rowf[row * ROWF + RF_N + j] = s;
  }
}

// ---------------------------------------------------------------- prologue

struct SplitSrc { const float* w[8]; int ld[8]; long long stride[8]; };

// One 16-byte unit of the split weights per thread-step: slab ks of a B
// [K][N] holds its k-step (8 k) as a hi and a lo part, each K-major in
// core matrices of 8 columns x 4 k: float (n / 8) * 64 + c * 32 + (n % 8)
// * 4 + kk of the part holds B[8 ks + 4 c + kk][n]. A unit is 4 k of one
// column in one part.
__global__ void split_kernel(const __grid_constant__ FragList plan,
                             const __grid_constant__ SplitSrc src,
                             uint4* out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < plan.total; e += (long long)gridDim.x * blockDim.x) {
    int m = 0;
    while (m + 1 < plan.count && e >= plan.m[m + 1].off) ++m;
    const FragMat& M = plan.m[m];
    const long long local = e - M.off;
    const int ks = (int)(local / (4 * M.n));
    const int v = (int)(local % (4 * M.n));
    const int part = v >= 2 * M.n, u = v - part * 2 * M.n;
    const int n = (u >> 4) * 8 + (u & 7), k0 = ks * 8 + ((u >> 3) & 1) * 4;
    const float* w = src.w[M.src] + plan.which[m] * src.stride[M.src];
    const int ld = src.ld[M.src];
    uint32_t q[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // B = w [din, dout]: B[k][n] = w[k][n]; B = w^T: B[k][n] = w[n][k]
      float b = 0.f;
      if (n < M.n_real)
        b = M.tr ? w[(size_t)n * ld + k0 + kk] : w[(size_t)(k0 + kk) * ld + n];
      uint32_t hi, lo;
      split_tf32(b, hi, lo);
      q[kk] = part ? lo : hi;
    }
    out[e] = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

// ------------------------------------------------------------- forward

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1)
    fwd_kernel(const __grid_constant__ Params p) {
  constexpr int NT = W / 16, LDA = W + 4, KS = W / 8;
  constexpr size_t TILE = (size_t)TBM * W;
  extern __shared__ __align__(16) unsigned char smem[];
  // the warps' weight rings, then:
  uint2* act = reinterpret_cast<uint2*>(smem + RING_BYTES);  // [TBM][LDA]
  // one [TBM][LDK] tile holds the embedding (trunk), then the view PE
  // (appearance)
  float* ems = reinterpret_cast<float*>(act + TBM * LDA);
  float* vps = ems;
  float* rowf = ems + TBM * LDK;                           // [TBM][ROWF]
  float* red = rowf + TBM * ROWF;                          // [2][TBM]

  const int tid = threadIdx.x;
  const int wg = tid >> 7, n_base = wg * (W / 2);
  const int n_tiles = (p.n + TBM - 1) / TBM;
  float* spbuf = p.scratch + (size_t)blockIdx.x * N_FWD * TILE;
  float* zf = spbuf + F_ZF * TILE;
  const Frags& F = p.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TBM, nv = min(TBM, p.n - row0);
    load_rows(ems, p.em, p.ke, row0, nv);
    for (int idx = tid; idx < TBM * 3; idx += NTHREADS) {
      const int r = idx / 3, c = idx % 3;
      rowf[r * ROWF + RF_P + c] =
          r < nv ? __ldg(p.p3 + (size_t)(row0 + r) * 3 + c) : 0.f;
    }
    __syncthreads();

    float acc[MI][NT][4];
    trunk_forward<W>(p, act, ems, acc, spbuf, nullptr, 0, nv);
    rowsum_wg<NT>(acc, p.w8l, n_base, red);
    __syncthreads();
    if (tid < TBM) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 2; ++w) s += red[w * TBM + tid];
      rowf[tid * ROWF + RF_L] = s + __ldg(p.b8l);
    }
    // feature head: feat = a_last @ w8f + b8f, and at once feat @ wf (the
    // appearance input), kept in scratch through the reverse sweep
    wg_gemm<W / 2>(act, LDA, KS, F.w8f, W, n_base, acc, true);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] += __ldg(p.b8f + frag_col(n_base, j, r));
    put_split<NT>(act, LDA, acc, n_base);
    __syncthreads();
    wg_gemm<W / 2>(act, LDA, KS, F.wf, W, n_base, acc, true);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) zf[sq(fq<NT>(i, j, r))] = acc[i][j][r];
    __syncthreads();

    // reverse sweep: g = d logit / d a, from g = w8l down to the embedding
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] = __ldg(p.w8l + frag_col(n_base, j, r));
    const bool owns_e = wg == 0;   // warpgroup 0: g_e (64 columns, ke used)
    float ge_skip[MI][8][4];
    for (int li = p.n_trunk; li >= 0; --li) {
      const float* sp_l = spbuf + li * TILE;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] *= sp_l[sq(fq<NT>(i, j, r))];
      put_split<NT>(act, LDA, acc, n_base);
      __syncthreads();
      if (li == 0) break;
      if (li == p.skip_pos + 1 && owns_e)
        wg_gemm<64>(act, LDA, KS, F.wskipT, 64, 0, ge_skip, true);
      wg_gemm<W / 2>(act, LDA, KS, F.trunkT + (size_t)(li - 1) * W * W / 2, W, n_base, acc, true);
      __syncthreads();
    }
    // g_e = (g s0) @ w0^T + gz_skip @ wskip^T
    if (owns_e) {
      float ge[MI][8][4];
      wg_gemm<64>(act, LDA, KS, F.w0T, 64, 0, ge, true);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = frow(0, r), col = frag_col(0, j, r);
          if (row < nv && col < p.ke)
            p.g_e[(size_t)(row0 + row) * p.ke + col] =
                ge[0][j][r] + ge_skip[0][j][r];
        }
    }
    __syncthreads();                 // g_e of the tile is in global memory
    normals(p, p.g_e, rowf, row0, nv);
    load_rows(vps, p.vpe, p.kv, row0, nv);
    __syncthreads();

    // appearance: relu layers on [p, view PE, n, feat] -> pre-tanh rgb
    wg_gemm<W / 2>(vps, LDK, p.kv / 8, F.wv, W, n_base, acc, true);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += zf[sq(fq<NT>(i, j, r))];
    app0_epilogue<W>(p, acc, rowf, n_base);
    put_split<NT>(act, LDA, acc, n_base);
    __syncthreads();
    for (int jl = 0; jl < 3; ++jl) {
      wg_gemm<W / 2>(act, LDA, KS, F.wa + (size_t)jl * W * W / 2, W, n_base, acc, true);
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
      put_split<NT>(act, LDA, acc, n_base);
      __syncthreads();
    }
    if (wg == 0) {
      float rgb[MI][1][4];
      wg_gemm<8>(act, LDA, KS, F.wa4, 8, 0, rgb, true);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = frow(i, r), col = frag_col(0, 0, r);
          if (col < 3 && row < nv)
            p.out[(size_t)(row0 + row) * 4 + col] = rgb[i][0][r] + __ldg(p.ba4 + col);
        }
    }
    if (tid < nv) p.out[(size_t)(row0 + tid) * 4 + 3] = rowf[tid * ROWF + RF_L];
    __syncthreads();
  }
}

// --------------------------------------------------- backward: the sweep

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1)
    sweep_kernel(const __grid_constant__ Params p) {
  constexpr int NT = W / 16, LDA = W + 4, KS = W / 8;
  constexpr size_t TILE = (size_t)TBM * W;
  extern __shared__ __align__(16) unsigned char smem[];
  // the warps' weight rings, then:
  uint2* act = reinterpret_cast<uint2*>(smem + RING_BYTES);  // [TBM][LDA]
  // one [TBM][LDK] tile holds, in turn, the embedding (trunk), the view
  // PE (appearance recompute), the g_n partials [3][2][TBM] (appearance
  // backward) and c_e (tangents)
  float* ems = reinterpret_cast<float*>(act + TBM * LDA);
  float* vps = ems;
  float* red = ems;
  float* ces = ems;
  float* rowf = ems + TBM * LDK;                           // [TBM][ROWF]

  const int tid = threadIdx.x;
  const int wg = tid >> 7, n_base = wg * (W / 2);
  const int n_tiles = (p.n + TBM - 1) / TBM;
  const WsLayout L = ws_layout(W, p.ke, p.kv, p.n_trunk);
  float* ws = p.ws;
  const int ld = p.ld_ws;
  float* fbuf = p.scratch + (size_t)blockIdx.x * N_SWP * TILE;
  float* spbuf = fbuf + F_SP * TILE;
  float* tzbuf = fbuf + F_TZ * TILE;
  float* hb = fbuf + F_HB * TILE;
  const Frags& F = p.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * TBM;                 // within the chunk
    const int nv = min(TBM, p.n - r0);
    const int row0 = p.row_begin + r0;         // within the batch
    load_rows(ems, p.em, p.ke, row0, nv);
    for (int idx = tid; idx < TBM * 4; idx += NTHREADS) {
      const int r = idx / 4, c = idx % 4;
      const bool in = r < nv;
      if (c < 3)
        rowf[r * ROWF + RF_P + c] =
            in ? __ldg(p.p3 + (size_t)(row0 + r) * 3 + c) : 0.f;
      rowf[r * ROWF + (c < 3 ? RF_GRGB + c : RF_L)] =
          in ? __ldg(p.g_out + (size_t)(row0 + r) * 4 + c) : 0.f;
    }
    __syncthreads();
    // the narrow x operands and [g_rgb, g_logit] into the workspace
    tile_to_ws(ws, ld, L.em, ems, LDK, p.ke, r0);
    tile_to_ws(ws, ld, L.p3, rowf + RF_P, ROWF, 3, r0);
    for (int idx = tid; idx < TBM * 8; idx += NTHREADS) {
      const int c = idx / TBM, r = idx % TBM;
      ws[(size_t)(L.g8 + c) * ld + r0 + r] =
          c < 3 ? rowf[r * ROWF + RF_GRGB + c]
                : (c == 3 ? rowf[r * ROWF + RF_L] : 0.f);
    }

    // ---- forward recompute (the reverse sweep's g_e is an input)
    float acc[MI][NT][4];
    trunk_forward<W>(p, act, ems, acc, spbuf, ws, r0, nv);
    load_rows(vps, p.vpe, p.kv, row0, nv);   // the trunk is done with em
    wg_gemm<W / 2>(act, LDA, KS, F.w8f, W, n_base, acc, true);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] += __ldg(p.b8f + frag_col(n_base, j, r));
    put_ws<NT>(ws, ld, L.feat, acc, n_base, r0, nv);
    put_split<NT>(act, LDA, acc, n_base);
    // n from the saved g_e, in the forward's summation order
    normals(p, p.g_e_in, rowf, row0, nv);
    __syncthreads();
    tile_to_ws(ws, ld, L.n3, rowf + RF_N, ROWF, 3, r0);
    tile_to_ws(ws, ld, L.vpe, vps, LDK, p.kv, r0);
    wg_gemm<W / 2>(vps, LDK, p.kv / 8, F.wv, W, n_base, acc, true);
    wg_gemm<W / 2>(act, LDA, KS, F.wf, W, n_base, acc, false);
    __syncthreads();
    app0_epilogue<W>(p, acc, rowf, n_base);
    for (int jl = 0; jl <= 3; ++jl) {
      // acc holds aa[jl]
      put_ws<NT>(ws, ld, L.aa + jl * W, acc, n_base, r0, nv);
      put_split<NT>(act, LDA, acc, n_base);
      __syncthreads();
      if (jl == 3) break;
      wg_gemm<W / 2>(act, LDA, KS, F.wa + (size_t)jl * W * W / 2, W, n_base, acc, true);
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

    // ---- appearance backward: gz = g_rgb @ wa4^T on the CUDA cores
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = frow(i, r), col = frag_col(n_base, j, r);
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            s += rowf[row * ROWF + RF_GRGB + c] * __ldg(p.wa4 + col * 3 + c);
          acc[i][j][r] = s;
        }
    for (int jl = 2; jl >= -1; --jl) {
      // mask by the relu of appearance layer jl + 1
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (!(ws_at(ws, ld, L.aa + (jl + 1) * W, frag_col(n_base, j, r),
                        r0 + frow(i, r)) > 0.f))
              acc[i][j][r] = 0.f;
      put_ws<NT>(ws, ld, L.gz + (jl + 1) * W, acc, n_base, r0, nv);
      if (jl < 0) break;
      put_split<NT>(act, LDA, acc, n_base);
      __syncthreads();
      wg_gemm<W / 2>(act, LDA, KS, F.waT + (size_t)jl * W * W / 2, W, n_base, acc, true);
      __syncthreads();
    }
    // gz is appearance layer 0's z_bar: g_n, then g_feat = gz @ wf^T
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rowsum_wg<NT>(acc, p.wn + c * W, n_base, red + c * 2 * TBM);
    put_split<NT>(act, LDA, acc, n_base);
    __syncthreads();
    if (tid < TBM * 3) {
      const int row = tid / 3, c = tid % 3;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 2; ++w) s += red[(c * 2 + w) * TBM + row];
      rowf[row * ROWF + RF_GN + c] = s;
    }
    wg_gemm<W / 2>(act, LDA, KS, F.wfT, W, n_base, acc, true);
    __syncthreads();

    // ---- first-order seeds through the split geometry head
    put_ws<NT>(ws, ld, L.gfeat, acc, n_base, r0, nv);
    put_split<NT>(act, LDA, acc, n_base);
    __syncthreads();
    // h_bar = g_feat @ w8f^T + g_logit w8l
    wg_gemm<W / 2>(act, LDA, KS, F.w8fT, W, n_base, acc, true);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          hb[sq(fq<NT>(i, j, r))] =
              acc[i][j][r] + rowf[frow(i, r) * ROWF + RF_L] *
                                 __ldg(p.w8l + frag_col(n_base, j, r));
    __syncthreads();

    // ---- tangent forward of the normal path: c_e = de * g_n[c % 3]
    for (int idx = tid; idx < TBM * p.ke; idx += NTHREADS) {
      const int row = idx / p.ke, c = idx % p.ke;
      ces[row * LDK + c] =
          row < nv ? __ldg(p.de + (size_t)(row0 + row) * p.ke + c) *
                         rowf[row * ROWF + RF_GN + c % 3]
                   : 0.f;
    }
    __syncthreads();
    tile_to_ws(ws, ld, L.ce, ces, LDK, p.ke, r0);
    for (int li = 0; li <= p.n_trunk; ++li) {
      if (li == 0) {
        wg_gemm<W / 2>(ces, LDK, p.ke / 8, F.w0, W, n_base, acc, true);
      } else {
        wg_gemm<W / 2>(act, LDA, KS, F.trunk + (size_t)(li - 1) * W * W / 2, W, n_base, acc, true);
        if (li - 1 == p.skip_pos)
          wg_gemm<W / 2>(ces, LDK, p.ke / 8, F.wskip, W, n_base, acc, false);
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
          }
      if (li < p.n_trunk) {
        put_ws<NT>(ws, ld, L.t + li * W, acc, n_base, r0, nv);
        put_split<NT>(act, LDA, acc, n_base);
      } else {
        // d_w8l's operand: g_logit a_last + t_last
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int row = frow(i, r), col = frag_col(n_base, j, r);
              acc[i][j][r] += rowf[row * ROWF + RF_L] *
                              ws_at(ws, ld, L.a + p.n_trunk * W, col, r0 + row);
            }
        put_ws<NT>(ws, ld, L.w8lt, acc, n_base, r0, nv);
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
      // z_bar = h_bar s + t_bar s'' tz -> acc; tz_bar = t_bar s -> ws
      const int o_tzb = L.tzb + li * W;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int q = fq<NT>(i, j, r);
            const int row = frow(i, r), col = frag_col(n_base, j, r);
            const float s = sp_l[sq(q)];
            const float tb = acc[i][j][r];
            acc[i][j][r] = hb[sq(q)] * s +
                           tb * (100.f * s * (1.f - s)) * tz_l[sq(q)];
            ws[(size_t)(o_tzb + col) * ld + r0 + row] = row < nv ? tb * s : 0.f;
          }
      put_ws<NT>(ws, ld, L.zb + li * W, acc, n_base, r0, nv);
      if (li == 0) break;
      // h_bar = z_bar @ W^T, then t_bar = tz_bar @ W^T
      const uint4* wl = F.trunkT + (size_t)(li - 1) * W * W / 2;
      put_split<NT>(act, LDA, acc, n_base);
      __syncthreads();
      wg_gemm<W / 2>(act, LDA, KS, wl, W, n_base, acc, true);
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
            acc[i][j][r] = ws_at(ws, ld, o_tzb, frag_col(n_base, j, r),
                                 r0 + frow(i, r));
      put_split<NT>(act, LDA, acc, n_base);
      __syncthreads();
      wg_gemm<W / 2>(act, LDA, KS, wl, W, n_base, acc, true);
      __syncthreads();
    }
    __syncthreads();
  }
}

// ------------------------------------- backward: the weight gradients

// One product x^T y over the chunk's points: x rows [x, x + r), y rows
// [y, y + c) of the workspace; a second segment (x2, y2) adds into the
// same sums (the trunk's a^T z_bar + t^T tz_bar); with bias, the column
// sums of y (first segment only). Its tiles are GB x GB. In a slot its
// product goes to [r x oc] at `out` (the first oc of its c columns), its
// column sums to [c] at `bout` (-1: none).
struct WJob { int x, x2, y, y2, r, c, oc, bias, rt, ct, tile0;
              long long out, bout; };
struct WPlan { WJob job[16]; int n_jobs, n_tiles; long long slot_floats;
               long long leaf[18]; };

// The jobs, and the slot laid out leaf after leaf, every leaf contiguous
// (leaf[] holds each one's offset in the packed order: w0, b0, wskip,
// trunk_w, trunk_b, w8f, b8f, w8l, b8l, wp, wv, wn, wf, ba0, wa, bab, wa4,
// ba4; ops/fused_radiance.py `f32_slot_layout` mirrors it): trunk_w,
// trunk_b, w0, b0, wskip, w8f, b8f, wa, bab, [wf; wv; wp; wn] (one
// product's rows), ba0, w8l, wa4 (3 of the rgb head's 8 columns), and its
// column sums [ba4, b8l, 0 x 4]. So the reduce's sum of the slots holds
// every gradient as it is.
__host__ WPlan wplan(int w, int ke, int kv, int nt, int skip) {
  const WsLayout L = ws_layout(w, ke, kv, nt);
  WPlan P = {};
  const long long ww = (long long)w * w;
  long long at = 0;
  auto take = [&](long long floats) { at += floats; return at - floats; };
  const long long tw = take(nt * ww), tb = take((long long)nt * w);
  const long long w0 = take((long long)ke * w), b0 = take(w);
  const long long wsk = take((long long)ke * w);
  const long long w8f = take(ww), b8f = take(w);
  const long long wa = take(3 * ww), bab = take(3 * w);
  const long long app = take((long long)(w + kv + 6) * w), ba0 = take(w);
  const long long w8l = take(w), wa4 = take(3 * w), b4 = take(8);
  P.slot_floats = at;
  const long long leaf[18] = {
      w0, b0, wsk, tw, tb, w8f, b8f, w8l, b4 + 3,
      app + ww + (long long)kv * w,                // wp
      app + ww,                                    // wv
      app + ww + (long long)(kv + 3) * w,          // wn
      app, ba0, wa, bab, wa4, b4};
  for (int i = 0; i < 18; ++i) P.leaf[i] = leaf[i];
  auto add = [&](int x, int x2, int y, int y2, int r, int c, int oc,
                 long long out, long long bout) {
    WJob& J = P.job[P.n_jobs++];
    J.x = x; J.x2 = x2; J.y = y; J.y2 = y2; J.r = r; J.c = c; J.oc = oc;
    J.bias = bout >= 0;
    J.rt = r > 0 ? (r + GB - 1) / GB : 1;
    J.ct = (c + GB - 1) / GB;
    J.tile0 = P.n_tiles;
    P.n_tiles += J.rt * J.ct;
    J.out = out;
    J.bout = bout;
  };
  for (int i = 1; i <= nt; ++i)
    add(L.a + (i - 1) * w, L.t + (i - 1) * w, L.zb + i * w, L.tzb + i * w,
        w, w, w, tw + (i - 1) * ww, tb + (long long)(i - 1) * w);
  add(L.em, L.ce, L.zb, L.tzb, ke, w, w, w0, b0);
  add(L.em, L.ce, L.zb + (skip + 1) * w, L.tzb + (skip + 1) * w, ke, w, w,
      wsk, -1);
  add(L.a + nt * w, -1, L.gfeat, -1, w, w, w, w8f, b8f);
  for (int j = 0; j < 3; ++j)
    add(L.aa + j * w, -1, L.gz + (j + 1) * w, -1, w, w, w, wa + j * ww,
        bab + (long long)j * w);
  add(L.feat, -1, L.gz, -1, w + kv + 6, w, w, app, ba0);
  add(-1, -1, L.w8lt, -1, 0, w, w, 0, w8l);                   // w8l
  add(L.aa + 3 * w, -1, L.g8, -1, w, 8, 3, wa4, b4);         // wa4, ba4, b8l
  return P;
}

constexpr int GSTAGES = 2;           // raw f32 stages in flight
constexpr int RLD = GK + 4;          // raw stage row stride (floats)
constexpr int TQ = GB * GK / 4;      // float4s of one split tile
// split tiles: [GB rows][GK points] K-major in core matrices; float4 idx of
// (row r, points 4 kg .. 4 kg + 3) is (r / 8) * 64 + kg * 8 + r % 8
constexpr uint32_t CM_LBO = 128, CM_SBO = 1024;

// Each CTA: one GB x GB output tile of one job over its split's points, 32
// points a stage. Stage it + 1 is split into the second pair of tiles
// while the warpgroups' wgmma run on stage it.
__global__ void __launch_bounds__(NTHREADS, 1)
    wgrad_kernel(const __grid_constant__ WPlan plan,
                 const float* __restrict__ ws, int ld, int kpts,
                 float* partial, int slot0) {
  extern __shared__ __align__(128) unsigned char smem[];
  // two sets of x hi, x lo, y hi, y lo tiles, then the raw stages
  float4* tiles = reinterpret_cast<float4*>(smem);
  float* raw = reinterpret_cast<float*>(tiles + 2 * 4 * TQ);
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
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lr = tid >> 3, lc = (tid & 7) * 4;   // copy: rows lr + 32 q
  const bool do_bias = J.bias && rt == 0;
  // a warpgroup whose 64 rows lie past the job's rows (the bias-only job,
  // a ragged last row tile) skips its products
  const bool active = rt * GB + wg * 64 < J.r;

  // stage `it` (segment, 32 points) into raw slot it % GSTAGES
  auto issue = [&](int it) {
    if (it < nit) {
      const int seg = it / per, p0 = (k_beg + it % per) * GK;
      const int xo = seg ? J.x2 : J.x, yo = seg ? J.y2 : J.y;
      float* rx = raw + (size_t)(it % GSTAGES) * 2 * GB * RLD;
      float* ry = rx + GB * RLD;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = rt * GB + lr + 32 * q, c = ct * GB + lr + 32 * q;
        const bool xin = xo >= 0 && r < J.r, yin = c < J.c;
        cp_async16_zfill(rx + (lr + 32 * q) * RLD + lc,
                         xin ? ws + (size_t)(xo + r) * ld + p0 + lc : ws, xin);
        cp_async16_zfill(ry + (lr + 32 * q) * RLD + lc,
                         yin ? ws + (size_t)(yo + c) * ld + p0 + lc : ws, yin);
      }
    }
    cp_async_commit();
  };
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};
  // raw stage `it` split into tiles t (and y's column sums, first segment)
  auto split = [&](int it, float4* t) {
    const float* rx = raw + (size_t)(it % GSTAGES) * 2 * GB * RLD;
    const float* ry = rx + GB * RLD;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + NTHREADS * q;
      const int r = (idx >> 6) * 8 + (idx & 7), kg = (idx >> 3) & 7;
      const float4 xv = *reinterpret_cast<const float4*>(rx + r * RLD + kg * 4);
      const float4 yv = *reinterpret_cast<const float4*>(ry + r * RLD + kg * 4);
      uint32_t h[4], l[4];
      split_tf32(xv.x, h[0], l[0]); split_tf32(xv.y, h[1], l[1]);
      split_tf32(xv.z, h[2], l[2]); split_tf32(xv.w, h[3], l[3]);
      t[idx] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                           __uint_as_float(h[2]), __uint_as_float(h[3]));
      t[TQ + idx] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                __uint_as_float(l[2]), __uint_as_float(l[3]));
      split_tf32(yv.x, h[0], l[0]); split_tf32(yv.y, h[1], l[1]);
      split_tf32(yv.z, h[2], l[2]); split_tf32(yv.w, h[3], l[3]);
      t[2 * TQ + idx] =
          make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                      __uint_as_float(h[2]), __uint_as_float(h[3]));
      t[3 * TQ + idx] =
          make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                      __uint_as_float(l[2]), __uint_as_float(l[3]));
      if (do_bias && it < per) bsum[q] += ((yv.x + yv.y) + yv.z) + yv.w;
    }
    fence_async_shared();
  };

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  issue(0);
  issue(1);
  if (nit > 0) {
    cp_async_wait<1>();
    __syncthreads();
    split(0, tiles);
  }
  __syncthreads();
  for (int it = 0; it < nit; ++it) {
    float4* cur = tiles + (it & 1) * 4 * TQ;
    float4* nxt = tiles + ((it + 1) & 1) * 4 * TQ;
    if (active) {
      // the stage's 4 k-steps x 3 products chain in d; FADD adds them up
      const float4* xh = cur + wg * 64 * GK / 4;
      const float4* xl = xh + TQ;
      const float4* yh = cur + 2 * TQ;
      const float4* yl = yh + TQ;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < GK / 8; ++ks) {
        const int o = ks * 16;       // two core matrices along K
        wgmma_tf32(d, smem_desc(xl + o, CM_LBO, CM_SBO),
                   smem_desc(yh + o, CM_LBO, CM_SBO), ks > 0);
        wgmma_tf32(d, smem_desc(xh + o, CM_LBO, CM_SBO),
                   smem_desc(yl + o, CM_LBO, CM_SBO), 1);
        wgmma_tf32(d, smem_desc(xh + o, CM_LBO, CM_SBO),
                   smem_desc(yh + o, CM_LBO, CM_SBO), 1);
      }
      wgmma_commit();
    }
    // raw slot it % 2 was split before the last barrier: refill it, and
    // split stage it + 1 into the other tiles while the products run
    issue(it + 2);
    if (it + 1 < nit) {
      cp_async_wait<1>();
      __syncthreads();
      split(it + 1, nxt);
    }
    if (active) {
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
    }
    __syncthreads();                 // nxt is written; cur is read
  }
  cp_async_wait<0>();
  float* const slot = partial + (size_t)(slot0 + s) * plan.slot_floats;
  float* out = slot + J.out;
  // accumulator of m64n128: warp w of the warpgroup holds rows 16 w .. +15
  // in the mma.sync fragment layout, n-tile j at d[4 j .. 4 j + 3]
  const int w4 = (tid >> 5) & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rt * GB + wg * 64 + w4 * 16 + frag_row(0, r);
      const int col = ct * GB + frag_col(0, j, r);
      if (row < J.r && col < J.oc) out[(size_t)row * J.oc + col] = acc[4 * j + r];
    }
  if (do_bias) {
    // rows (tid >> 6) * 8 + 32 q + (tid & 7); partial sums per column group
    // kg = (tid >> 3) & 7, added in kg order
    __syncthreads();
    float* red = raw;                // [8][GB]
#pragma unroll
    for (int q = 0; q < 4; ++q)
      red[((tid >> 3) & 7) * GB + (tid >> 6) * 8 + 32 * q + (tid & 7)] = bsum[q];
    __syncthreads();
    if (tid < GB) {
      float v = 0.f;
#pragma unroll
      for (int kg = 0; kg < 8; ++kg) v += red[kg * GB + tid];
      const int c = ct * GB + tid;
      if (c < J.c) slot[J.bout + c] = v;
    }
  }
}

// ------------------------------------------------------------- launches

template <int W>
size_t fwd_smem() {
  return RING_BYTES + (size_t)TBM * (W + 4) * 8 + TBM * LDK * 4 +
         TBM * ROWF * 4 + 2 * TBM * 4;
}

template <int W>
size_t sweep_smem() {
  return RING_BYTES + (size_t)TBM * (W + 4) * 8 + TBM * LDK * 4 +
         TBM * ROWF * 4;
}

constexpr size_t WGRAD_SMEM =
    2 * 4 * (size_t)TQ * 16 + (size_t)GSTAGES * 2 * GB * RLD * 4;

template <int W, bool FWD>
cudaError_t launch_tiles(const Params& p, int slots, cudaStream_t stream) {
  const size_t smem = FWD ? fwd_smem<W>() : sweep_smem<W>();
  auto kernel = FWD ? fwd_kernel<W> : sweep_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.n + TBM - 1) / TBM;
  kernel<<<n_tiles < slots ? n_tiles : slots, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

bool dims_ok(int w, int ke, int kv, int nt) {
  return (w == 128 || w == 256) && ke > 0 && ke % 16 == 0 && ke <= 64 &&
         kv > 0 && kv % 16 == 0 && kv <= 64 && nt >= 1 && nt < MAXL;
}

}  // namespace

// Sizes of one shape (ints: width, ke, kv, n_trunk): out[0] 16-byte words
// of the split weights, out[1] workspace rows (floats per point), out[2]
// forward and out[3] sweep scratch floats per CTA slot, out[4] floats per
// weight-gradient slot, out[5] weight-gradient tiles, out[6 .. 23] each
// gradient's offset in a slot (and in the reduce's sum), in the packed
// order.
extern "C" int psnerf_rf32_sizes(const int* ints, long long* out) {
  const int w = ints[0], ke = ints[1], kv = ints[2], nt = ints[3];
  if (!dims_ok(w, ke, kv, nt)) return (int)cudaErrorInvalidValue;
  const WPlan P = wplan(w, ke, kv, nt, 0);
  out[0] = frag_list(w, ke, kv, nt).total;
  out[1] = ws_layout(w, ke, kv, nt).rows;
  out[2] = (long long)N_FWD * TBM * w;
  out[3] = (long long)N_SWP * TBM * w;
  out[4] = P.slot_floats;
  out[5] = P.n_tiles;
  for (int i = 0; i < 18; ++i) out[6 + i] = P.leaf[i];
  return 0;
}

// Each returns a cudaError_t (0 = cudaSuccess).
// ptrs: w0, wskip, trunk_w, w8f, wv, wf, wa, wa4 (packed f32, [din, dout]),
// then the split weights. ints: width, ke, kv, n_trunk.
extern "C" int psnerf_rf32_split(void* const* ptrs, const int* ints,
                                 void* stream) {
  const int w = ints[0], ke = ints[1], kv = ints[2], nt = ints[3];
  if (!dims_ok(w, ke, kv, nt)) return (int)cudaErrorInvalidValue;
  const FragList L = frag_list(w, ke, kv, nt);
  SplitSrc src = {};
  const int ld[8] = {w, w, w, w, w, w, w, 3};
  const long long stride[8] = {0, 0, (long long)w * w, 0, 0, 0,
                               (long long)w * w, 0};
  for (int i = 0; i < 8; ++i) {
    src.w[i] = static_cast<const float*>(ptrs[i]);
    src.ld[i] = ld[i];
    src.stride[i] = stride[i];
  }
  long long blocks = (L.total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  split_kernel<<<(int)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      L, src, static_cast<uint4*>(ptrs[8]));
  return (int)cudaGetLastError();
}

namespace {

Params tile_params(void* const* ptrs, int& k, int w, int ke, int kv,
                   int nt) {
  Params p = {};
  auto fp = [&]() { return static_cast<const float*>(ptrs[k++]); };
  p.em = fp(); p.de = fp(); p.vpe = fp(); p.p3 = fp();
  p.f = frags_at(static_cast<const uint4*>(ptrs[k++]), w, ke, kv, nt);
  p.b0 = fp(); p.trunk_b = fp(); p.b8f = fp(); p.w8l = fp(); p.b8l = fp();
  p.wp = fp(); p.wn = fp(); p.ba0 = fp(); p.bab = fp(); p.ba4 = fp();
  p.wa4 = fp();
  return p;
}

}  // namespace

// ptrs: em, de, vpe, p3, split weights, b0, trunk_b, b8f, w8l, b8l, wp,
// wn, ba0, bab, ba4, wa4, then out, g_e, scratch. ints: n, width, ke, kv,
// n_trunk, skip_pos, slots.
extern "C" int psnerf_rf32_fwd(void* const* ptrs, const int* ints,
                               void* stream) {
  const int w = ints[1], ke = ints[2], kv = ints[3], nt = ints[4];
  if (!dims_ok(w, ke, kv, nt) || ints[5] < 0 || ints[5] >= nt || ints[6] < 1)
    return (int)cudaErrorInvalidValue;
  int k = 0;
  Params p = tile_params(ptrs, k, w, ke, kv, nt);
  p.out = static_cast<float*>(ptrs[k++]);
  p.g_e = static_cast<float*>(ptrs[k++]);
  p.scratch = static_cast<float*>(ptrs[k++]);
  p.n = ints[0]; p.ke = ke; p.kv = kv; p.n_trunk = nt; p.skip_pos = ints[5];
  if (p.n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(w == 128 ? launch_tiles<128, true>(p, ints[6], s)
                        : launch_tiles<256, true>(p, ints[6], s));
}

// ptrs: em, de, vpe, p3, split weights, b0, trunk_b, b8f, w8l, b8l, wp,
// wn, ba0, bab, ba4, wa4, then g_e, g_out, the workspace, scratch. ints:
// n (the chunk's points), row_begin, ld_ws, width, ke, kv, n_trunk,
// skip_pos, slots.
extern "C" int psnerf_rf32_sweep(void* const* ptrs, const int* ints,
                                 void* stream) {
  const int w = ints[3], ke = ints[4], kv = ints[5], nt = ints[6];
  if (!dims_ok(w, ke, kv, nt) || ints[7] < 0 || ints[7] >= nt ||
      ints[8] < 1 || ints[2] % 64 || ints[2] < ints[0])
    return (int)cudaErrorInvalidValue;
  int k = 0;
  Params p = tile_params(ptrs, k, w, ke, kv, nt);
  p.g_e_in = static_cast<const float*>(ptrs[k++]);
  p.g_out = static_cast<const float*>(ptrs[k++]);
  p.ws = static_cast<float*>(ptrs[k++]);
  p.scratch = static_cast<float*>(ptrs[k++]);
  p.n = ints[0]; p.row_begin = ints[1]; p.ld_ws = ints[2];
  p.ke = ke; p.kv = kv; p.n_trunk = nt; p.skip_pos = ints[7];
  if (p.n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(w == 128 ? launch_tiles<128, false>(p, ints[8], s)
                        : launch_tiles<256, false>(p, ints[8], s));
}

// ptrs: the workspace, the slots. ints: kpts (the chunk's points rounded
// up to 64), ld_ws, width, ke, kv, n_trunk, skip_pos, splits, slot0.
extern "C" int psnerf_rf32_wgrad(void* const* ptrs, const int* ints,
                                 void* stream) {
  const int w = ints[2], ke = ints[3], kv = ints[4], nt = ints[5];
  if (!dims_ok(w, ke, kv, nt) || ints[0] % 64 || ints[0] > ints[1] ||
      ints[7] < 1 || ints[6] < 0 || ints[6] >= nt)
    return (int)cudaErrorInvalidValue;
  const WPlan P = wplan(w, ke, kv, nt, ints[6]);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WGRAD_SMEM);
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<<<dim3(P.n_tiles, ints[7]), NTHREADS, WGRAD_SMEM,
           static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const float*>(ptrs[0]), ints[1], ints[0],
      static_cast<float*>(ptrs[1]), ints[8]);
  return (int)cudaGetLastError();
}

// The weight-gradient slots summed in fixed order by the engine
// (slot_reduce.cuh) into the gradients' flat buffer. ptrs: the slots
// [slots, slot_floats], the sum [slot_floats]. ints: slot_floats, slots.
extern "C" int psnerf_rf32_reduce(void* const* ptrs, const int* ints,
                                  void* stream) {
  return (int)slot_reduce::launch(ptrs[0], ptrs[1], ints[0], ints[1],
                                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* psnerf_rf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
