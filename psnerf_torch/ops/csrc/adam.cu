// Multi-tensor Adam for NVIDIA Hopper (sm_90a): one call updates up to 48
// leaves of an adam_update call (psnerf_torch/train/optim.py) in two
// launches.
//
// It replaces no TPU kernel: the JAX package's Adam
// (psnerf_tpu/train/optim.py) is a part of the jitted train step, which XLA
// fuses. The port's per-leaf loop (adam_update_plain) issues ~24 ATen calls
// a leaf, about 1,000 launches a stage-1 step, each of which costs the host
// more than the card.
//
// What bounds it: bytes. A value reads p, g, m and v and writes p, m and v:
// 28 bytes, 22.5 MB for stage 1's 802,490 values (6.7 us at 3.35 TB/s).
// Two divisions, a square root and six products a value are nothing beside
// that, so the design keeps every value's bytes to one pass and the launches
// free of any host-to-device copy.
//
// Design. The leaves travel in the kernels' parameters: a table of at most
// MAX_LEAVES leaves (pointers, sizes, the first CTA of each leaf), passed as
// a __grid_constant__ struct of ~3.1 KB, under the 4 KB limit of a launch's
// parameters on every CUDA 12 toolkit; the caller splits longer lists into
// more calls (ops/adam.py). Two launches a call, in stream order. The first
// (adam_step_kernel, a CTA a leaf) adds this step's increment to each
// leaf's step counter on the device: 1, or for a row-gated leaf whether any
// gate row is on (the CTA reads the gate's rows: a light table's few
// thousand). The second (adam_kernel) updates the values: each CTA takes
// BLOCK_ELEMS consecutive values of one leaf (its leaf is the last whose
// first CTA is not past it), each thread PER_THREAD values THREADS apart,
// all loads issued before the math, and every CTA of a leaf reads the same
// new step, which the first launch finished writing.
// The arithmetic is adam_update_plain's: the same f32 operations in the same
// order, each rounded to nearest and none contracted into an FMA (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn; powf as ATen's pow), with the
// constants as ATen rounds them (lr, b1, 1 - b1, b2, 1 - b2, eps: Python
// doubles cast to f32), so p, m, v and step come out bit for bit as the plain
// loop's on the card.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int MAX_LEAVES = 48;
constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int BLOCK_ELEMS = THREADS * PER_THREAD;

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  int* step;
  const float* gate;  // row gate, one value per `cols` values; null: none
  int n;              // values
  int cols;
  int block0;         // the leaf's first CTA in adam_kernel's grid
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n_leaves;
  float lr, b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2
};

static_assert(sizeof(Table) <= 4096, "a launch takes 4 KB of parameters");

// step += 1, or += whether any row of the leaf's gate is on: a CTA a leaf
__global__ void __launch_bounds__(THREADS) adam_step_kernel(
    const __grid_constant__ Table t) {
  const Leaf& leaf = t.leaf[blockIdx.x];
  int inc = 1;
  if (leaf.gate) {
    const int rows = leaf.n / leaf.cols;
    int any = 0;
    for (int r = threadIdx.x; r < rows; r += THREADS)
      any |= leaf.gate[r] > 0.f;
    inc = __syncthreads_or(any);
  }
  if (threadIdx.x == 0) *leaf.step += inc;
}

__global__ void __launch_bounds__(THREADS) adam_kernel(
    const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  int li = 0;
  while (li + 1 < t.n_leaves && t.leaf[li + 1].block0 <= b) ++li;
  const Leaf& leaf = t.leaf[li];

  // t >= 1: a row-gated leaf whose rows are all off keeps a step of 0
  const float tf = static_cast<float>(max(*leaf.step, 1));
  const float bc1 = __fsub_rn(1.f, powf(t.b1, tf));
  const float bc2 = __fsub_rn(1.f, powf(t.b2, tf));
  const int base = (b - leaf.block0) * BLOCK_ELEMS + threadIdx.x;

  float p[PER_THREAD], g[PER_THREAD], m[PER_THREAD], v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = base + k * THREADS;
    if (i < leaf.n) {
      p[k] = leaf.p[i];
      g[k] = leaf.g[i];
      m[k] = leaf.m[i];
      v[k] = leaf.v[i];
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = base + k * THREADS;
    if (i >= leaf.n) break;
    // m_new = b1 * m + (1 - b1) * g;  v_new = b2 * v + (1 - b2) * g * g
    const float m1 = __fadd_rn(__fmul_rn(t.b1, m[k]), __fmul_rn(t.c1, g[k]));
    const float v1 = __fadd_rn(__fmul_rn(t.b2, v[k]),
                               __fmul_rn(__fmul_rn(t.c2, g[k]), g[k]));
    // upd = lr * (m_new / bc1) / (sqrt(v_new / bc2) + eps)
    const float upd = __fdiv_rn(
        __fmul_rn(t.lr, __fdiv_rn(m1, bc1)),
        __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, bc2)), t.eps));
    if (leaf.gate) {
      const float gt = leaf.gate[i / leaf.cols];
      leaf.p[i] = __fsub_rn(p[k], __fmul_rn(gt, upd));
      if (gt > 0.f) {
        leaf.m[i] = m1;
        leaf.v[i] = v1;
      }
    } else {
      leaf.p[i] = __fsub_rn(p[k], upd);
      leaf.m[i] = m1;
      leaf.v[i] = v1;
    }
  }
}

float bits_to_float(int bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

}  // namespace

// Returns a cudaError_t (0 = cudaSuccess).
// ptrs: per leaf p, g, m, v, step (int32), gate (any pointer where ungated).
// ints: n_leaves (at most MAX_LEAVES); the f32 bits of lr, b1, 1 - b1, b2,
//       1 - b2, eps; then per leaf n (values, at least 1) and cols (0:
//       ungated; else values per gate element, dividing n).
extern "C" int psnerf_adam(void* const* ptrs, const int* ints, void* stream) {
  Table t;
  t.n_leaves = ints[0];
  if (t.n_leaves <= 0) return cudaSuccess;
  if (t.n_leaves > MAX_LEAVES) return cudaErrorInvalidValue;
  t.lr = bits_to_float(ints[1]);
  t.b1 = bits_to_float(ints[2]);
  t.c1 = bits_to_float(ints[3]);
  t.b2 = bits_to_float(ints[4]);
  t.c2 = bits_to_float(ints[5]);
  t.eps = bits_to_float(ints[6]);
  int blocks = 0;
  for (int i = 0; i < t.n_leaves; ++i) {
    Leaf& leaf = t.leaf[i];
    void* const* lp = ptrs + 6 * i;
    const int n = ints[7 + 2 * i], cols = ints[8 + 2 * i];
    if (n <= 0 || cols < 0 || (cols > 0 && n % cols != 0))
      return cudaErrorInvalidValue;
    leaf.p = static_cast<float*>(lp[0]);
    leaf.g = static_cast<const float*>(lp[1]);
    leaf.m = static_cast<float*>(lp[2]);
    leaf.v = static_cast<float*>(lp[3]);
    leaf.step = static_cast<int*>(lp[4]);
    leaf.gate = cols > 0 ? static_cast<const float*>(lp[5]) : nullptr;
    leaf.n = n;
    leaf.cols = cols;
    leaf.block0 = blocks;
    blocks += (n + BLOCK_ELEMS - 1) / BLOCK_ELEMS;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  adam_step_kernel<<<t.n_leaves, THREADS, 0, s>>>(t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adam_kernel<<<blocks, THREADS, 0, s>>>(t);
  return cudaGetLastError();
}

extern "C" const char* psnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
