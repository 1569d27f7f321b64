// The bf16 trunk engine shared by fused_occ.cu (K1) and fused_vis.cu (K4,
// K5): a no-grad skip-MLP trunk of W x W bf16 layers with one output
// column, on Hopper's wgmma, for sm_90a.
//
// A CTA is three warpgroups. The last is the producer: one thread streams
// the trunk's weights, one k-step slab at a time (W output columns x 16
// inputs, bf16, 32 W bytes), through a ring of slabs in shared memory by
// 1-D cp.async.bulk copies, each completing on the slot's `full` mbarrier.
// The other two are consumers: each owns 64 rows, and both read every slab
// of the ring, so each weight byte read from L2 serves 128 rows. A consumer
// frees a slot on its `empty` mbarrier once its wgmma on it has completed.
//
// The weights are packed once per packing on the host (ops/build.py
// `pack_slabs`, called by ops/fused_occ.py and ops/fused_vis.py) in wgmma's
// K-major core-matrix layout without swizzle: slab ks holds w[n][16 ks + k]
// at byte
//   (n / 8) * 256 + (k / 8) * 128 + (n % 8) * 16 + (k % 8) * 2,
// the matrices one after another in the order the consumers read them. A
// narrow point product (K = ke, the zero-padded embedding width) is ke / 16
// slabs of the same size.
//
// Each layer is W / 16 wgmma m64nWk16 (f32 accumulators) with A from
// registers; the epilogue turns the accumulator into the next layer's bf16
// A fragments in registers (the m64nN accumulator's columns 16 kk ..
// 16 kk + 15 are exactly k-step kk's A fragment), so no activation goes
// through shared memory and no CTA-wide barrier sits between layers. The
// point embedding's products (layer 0's point half, the skip layer's) read
// A from a K-major tile in shared memory. setmaxnreg gives the consumers
// 240 registers (W/2 accumulators and W/4 A registers at W = 256) and the
// producer 24.
//
// Accumulator and A-fragment layout of a consumer thread (warp w of its
// warpgroup, g = lane / 4, t = lane % 4):
//   acc[4 j + r]  row 16 w + g + 8 (r >> 1), column 8 j + 2 t + (r & 1)
//   a[kk][0..3]   (row g, k 2t..) (row g+8, k 2t..) (row g, k 2t+8..)
//                 (row g+8, k 2t+8..) of the warp's 16 rows, k in step kk

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace trunk {

constexpr int ROWS = 64;                   // rows of one consumer warpgroup
constexpr int NCONS = 2;                   // consumer warpgroups per CTA
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr int LAG = 2;                     // wgmma groups kept in flight
constexpr int MAX_RING = 32;               // slots at most
constexpr int SMEM_LIMIT = 232448;         // a block's shared memory
constexpr int A_KSTEP = ROWS * 32;         // bytes of a 64-row A k-step
// named barriers (0 is __syncthreads)
constexpr int BAR_CONS = 1;                // all consumer threads
constexpr int BAR_TURN = 2;                // + wg: ping-pong turn
constexpr int BAR_WG = 4;                  // + wg: one consumer warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits for the phase of the given parity to complete. A wait of more than
// ~2^34 cycles (seconds) can only be a broken pipeline: it traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completion is counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from reading the accumulators before the wait
template <int M>
__device__ __forceinline__ void reg_fence(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along K (the two halves of
// a k-step), 256 bytes apart along the rows
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (+)= A[64 x 16] B[N x 16]^T, bf16 operands, f32 accumulators, by the
// warpgroup; scale_d 0: d = the product
template <int N> struct Mma;

template <> struct Mma<64> {
  // A from registers
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // A from shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct Mma<128> {
  // A from registers
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // A from shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct Mma<256> {
  // A from registers
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // A from shared memory
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// y (the accumulator layout) rounded to bf16 as the next layer's A
template <int W>
__device__ __forceinline__ void to_afrag(const float (&y)[W / 2],
                                         uint32_t (&a)[W / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    a[kk][0] = pack_bf16(y[8 * kk + 0], y[8 * kk + 1]);
    a[kk][1] = pack_bf16(y[8 * kk + 2], y[8 * kk + 3]);
    a[kk][2] = pack_bf16(y[8 * kk + 4], y[8 * kk + 5]);
    a[kk][3] = pack_bf16(y[8 * kk + 6], y[8 * kk + 7]);
  }
}

// Row sums of y * w[col] in f32 for the thread's two rows (g: lo, g + 8:
// hi), over all W columns: every lane of the quad gets them.
template <int W>
__device__ __forceinline__ void row_dot(const float (&y)[W / 2],
                                        const float* w, float& lo,
                                        float& hi) {
  const int t = threadIdx.x & 3;
  lo = 0.f;
  hi = 0.f;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 c = *reinterpret_cast<const float2*>(w + 8 * j + 2 * t);
    lo += y[4 * j] * c.x + y[4 * j + 1] * c.y;
    hi += y[4 * j + 2] * c.x + y[4 * j + 3] * c.y;
  }
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
}

// The tile row (0..63) of a consumer thread's lo row; hi is + 8.
__device__ __forceinline__ int row_lo() {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}

// Rows [row0, row0 + ROWS) of a row-major [n, ke] bf16 array into a K-major
// core-matrix A tile at dst (k-steps A_KSTEP bytes apart); rows past n are
// zero. Threads tid, tid + nthr, ... of the caller's group share the work.
__device__ __forceinline__ void load_a_tile(unsigned char* dst,
                                            const __nv_bfloat16* src,
                                            int row0, int n, int ke, int tid,
                                            int nthr) {
  const int kc_n = ke / 8;
  for (int idx = tid; idx < ROWS * kc_n; idx += nthr) {
    const int r = idx / kc_n, kc = idx % kc_n;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ke) +
                kc);
    *reinterpret_cast<uint4*>(dst + (kc >> 1) * A_KSTEP + (r >> 3) * 256 +
                              (kc & 1) * 128 + (r & 7) * 16) = v;
  }
}

// ------------------------------------------------------------------ ring

// The shared-memory layout head: the ring's slots, then its barriers at
// the end of the block's shared memory (set by the kernels).
struct RingSpec {
  unsigned char* slots;      // ring * slab bytes
  uint64_t* full;            // [ring]
  uint64_t* empty;           // [ring]
  int ring;
  uint32_t slab;
};

__device__ __forceinline__ void ring_init(const RingSpec& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < s.ring; ++i) {
      mbar_init(s.full + i, 1);
      mbar_init(s.empty + i, NCONS);
    }
    mbar_fence_init();
  }
}

// The producer thread: slabs [begin, begin + count) of the packed weights,
// in order, into the ring. `it` counts the slabs it has issued.
struct Producer {
  RingSpec s;
  const unsigned char* src;
  uint32_t it = 0;
  int slot = 0;
  uint32_t phase = 0;        // uses of the slot so far, mod 2

  __device__ __forceinline__ void stream(int begin, int count) {
    for (int k = 0; k < count; ++k) {
      if (it >= (uint32_t)s.ring) mbar_wait(s.empty + slot, phase ^ 1);
      mbar_expect_tx(s.full + slot, s.slab);
      bulk_load(s.slots + (size_t)slot * s.slab,
                src + (size_t)(begin + k) * s.slab, s.slab, s.full + slot);
      ++it;
      if (++slot == s.ring) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
};

// A consumer warpgroup's view of the ring: it acquires slabs in the order
// the producer streams them and releases each once its wgmma completed,
// keeping at most LAG groups in flight.
struct Consumer {
  RingSpec s;
  int slot = 0, rel = 0, pending = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ const unsigned char* acquire() {
    mbar_wait(s.full + slot, phase);
    const unsigned char* p = s.slots + (size_t)slot * s.slab;
    if (++slot == s.ring) {
      slot = 0;
      phase ^= 1;
    }
    ++pending;
    return p;
  }

  __device__ __forceinline__ void release_one() {
    if ((threadIdx.x & 127) == 0) mbar_arrive(s.empty + rel);
    if (++rel == s.ring) rel = 0;
    --pending;
  }

  // after a commit: keep LAG groups in flight, free the rest
  __device__ __forceinline__ void throttle() {
    if (pending > LAG) {
      wgmma_wait<LAG>();
      release_one();
    }
  }

  // wait for every product issued, free their slabs
  template <int M>
  __device__ __forceinline__ void drain(float (&acc)[M]) {
    wgmma_wait<0>();
    reg_fence(acc);
    while (pending > 0) release_one();
  }

  // acc (+)= A @ the next W / 16 slabs, A from registers
  template <int W>
  __device__ __forceinline__ void product(float (&acc)[W / 2],
                                          const uint32_t (&a)[W / 16][4],
                                          bool accumulate) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks) {
      Mma<W>::rs(acc, a[ks], desc(acquire()), (ks > 0 || accumulate) ? 1 : 0);
      wgmma_commit();
      throttle();
    }
  }

  // acc (+)= A @ the next ks_n slabs, A a K-major tile in shared memory
  template <int W>
  __device__ __forceinline__ void product_smem(float (&acc)[W / 2],
                                               const unsigned char* a_tile,
                                               int ks_n, bool accumulate) {
    wgmma_fence();
#pragma unroll 1
    for (int ks = 0; ks < ks_n; ++ks) {
      Mma<W>::ss(acc, desc(a_tile + ks * A_KSTEP), desc(acquire()),
                 (ks > 0 || accumulate) ? 1 : 0);
      wgmma_commit();
      throttle();
    }
  }
};

// Ping-pong of the two consumer warpgroups (named barriers): a warpgroup
// issues a product only in its turn, and hands the turn over once the
// product is issued, so one warpgroup's epilogue runs under the other's
// wgmma. Warpgroup 1 opens with a hand-over, and holds back its last one
// (`phases` counts the products it issues) so that every arrival is
// matched.
struct PingPong {
  int wg, phases;

  __device__ __forceinline__ void open() {
    if (wg == 1) bar_arrive(BAR_TURN + 0, 2 * 128);
  }
  __device__ __forceinline__ void begin() { bar_sync(BAR_TURN + wg, 2 * 128); }
  __device__ __forceinline__ void end() {
    --phases;
    if (wg == 0 || phases > 0) bar_arrive(BAR_TURN + (wg ^ 1), 2 * 128);
  }
};

// ----------------------------------------------------------- host side

__host__ inline int sm_count() {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
  }
  return cached;
}

// slots of a ring that fit beside `fixed` bytes of shared memory
__host__ inline int ring_slots(size_t fixed, size_t slab) {
  const size_t bars = 2 * MAX_RING * sizeof(uint64_t);
  if (fixed + bars >= (size_t)SMEM_LIMIT) return 0;
  const size_t n = ((size_t)SMEM_LIMIT - fixed - bars) / slab;
  return (int)(n < (size_t)MAX_RING ? n : (size_t)MAX_RING);
}

}  // namespace trunk
