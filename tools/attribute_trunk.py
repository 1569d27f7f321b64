#!/usr/bin/env python3
"""Attribution of the bf16 trunk kernels' time (K1 fused_occ, K4/K5
fused_vis) by timing patched copies of their sources, in turns, on a card:

    python3 tools/attribute_trunk.py --parent DIR

DIR holds the csrc of the mma.sync design these kernels had before the
wgmma trunk engine (csrc/trunk_wgmma.cuh): fused_occ.cu, fused_vis.cu and
mma_tile.cuh, e.g. unpacked from `git archive` of the commit before the
engine into a directory that .gitignore lists. Every copy is built into
_chipcheck/attr_trunk/<variant>/ by one nvcc each, all at once. Variants:

  mma.sync design (DIR, called with its own C interface):
    * occ_base, vis_base: unchanged;
    * occ_relu:        K1's softplus replaced by relu: the epilogue's share;
    * occ_smem_w, vis_smem_w: each trunk layer's weights staged once per
                       CTA in shared memory (K4/K5: in K-chunks of 64)
                       instead of every warp's __ldg of its fragments;
    * vis_stacked:     two lights stacked per pass (128 rows per product,
                       each weight fragment used twice), raw mode only.
  the engine (the checkout's csrc, called through the port's wrappers):
    * eng_base:        unchanged;
    * eng_precise:     K1's softplus from expf and log1pf;
    * eng_no_pingpong: K1's warpgroups without turns;
    * eng_relu:        K1's softplus replaced by relu;
    * eng_vis_no_bias_relu: K4/K5's bias and relu left out of the six
                       plain layers' epilogues (the bf16 packing stays);
    * eng_vis_no_mma:  K4/K5's trunk products left out (the ring's copies,
                       barriers and waits stay; the epilogues that only
                       feed the products are then dead code too).

K1 runs at the march's N = 524,288 and at a secant pass's N = 2,048 (the
bf16 bear field, random weights from seed 0); K4 (raw) and K5 (lnc) at N =
65,536 pixels x L = 96 lights. Outputs of the variants are not checked.
It also measures the card's L2 read bandwidth (a read-only kernel over
buffers of 8, 16 and 32 MB, each read many times) and counts the SASS
instructions of both K1 designs per softplus (cuobjdump -sass). Prints one
JSON line per measurement and a last line with the card's name and power
limit.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OCC_SP = """  return bx > 20.f ? x : (fmaxf(bx, 0.f) + log1pf(expf(-fabsf(bx)))) / 100.f;"""
OCC_TRUNK = """    warp_gemm<NT, true>(act, LDA, W, p.trunk_wT + (size_t)li * W * W, W,
                        n_base, acc, true);"""
OCC_RED = """  float* red = reinterpret_cast<float*>(ems + BM * LDE);          // [NWARPS][BM]"""
OCC_SMEM = """                      (size_t)NWARPS * BM * sizeof(float);"""
VIS_TRUNK = """      warp_gemm<W>(act, W, p.trunk_wT + (size_t)li * W * W, acc, n_base, g, t);"""
VIS_PIXS = """  float* pixs = red + NWARPS * BM;                             // [BM][PIXW]"""
VIS_SMEM = """         (mode == RAW ? 0 : (size_t)BM * PIXW * sizeof(float));"""
VIS_KERNEL_HEAD = "template <int W, int MODE>\n__global__ void __launch_bounds__(NTHREADS, 1) fused_vis_kernel"
VIS_KERNEL_END = "template <int W>\nconstexpr size_t smem_bytes(int mode) {"

# per trunk layer: the CTA copies w^T [W, 64 k] chunks into shared memory
# (row stride 72) and the warps read their B fragments there
VIS_STAGED = r"""
template <int W>
__device__ __forceinline__ void warp_gemm_staged(
    const __nv_bfloat16* act, const __nv_bfloat16* __restrict__ wT,
    __nv_bfloat16* wsm, float (&acc)[4][W / 64][4], int n_base, int g, int t) {
  constexpr int NT = W / 64;
  constexpr int LDA = W + 8;
  constexpr int LDS = 72;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  for (int kc = 0; kc < W; kc += 64) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < W * 8; idx += NTHREADS) {
      const int r = idx >> 3, c = idx & 7;
      *reinterpret_cast<uint4*>(wsm + r * LDS + c * 8) =
          __ldg(reinterpret_cast<const uint4*>(wT + (size_t)r * W + kc + c * 8));
    }
    __syncthreads();
#pragma unroll 4
    for (int k0 = 0; k0 < 64; k0 += 16) {
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* pb = wsm + (n_base + j * 8 + g) * LDS + k0 + 2 * t;
        b[j][0] = ld_u32(pb);
        b[j][1] = ld_u32(pb + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* pa = act + (i * 16 + g) * LDA + kc + k0 + 2 * t;
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
}

"""

# two lights stacked: a [128, W] activation tile (rows 0-63 light l, 64-127
# light l + 1) through one product per layer; raw output only
VIS_STACKED = r"""template <int W>
__device__ __forceinline__ void warp_gemm2(const __nv_bfloat16* act,
                                           const __nv_bfloat16* __restrict__ wT,
                                           float (&acc)[8][W / 64][4],
                                           int n_base, int g, int t) {
  constexpr int NT = W / 64;
  constexpr int LDA = W + 8;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < W; k0 += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* pb = wT + (size_t)(n_base + j * 8 + g) * W + k0 + 2 * t;
      b[j][0] = ldg_u32(pb);
      b[j][1] = ldg_u32(pb + 8);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
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
  constexpr int LDA = W + 8;
  constexpr int LDF = W + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* a0s = reinterpret_cast<float*>(smem);
  float* b5s = a0s + BM * LDF;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(b5s + BM * LDF);
  float* red = reinterpret_cast<float*>(act + 2 * BM * LDA);   // [NWARPS][2 BM]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_base = warp * (W / NWARPS);
  const int row0 = blockIdx.x * BM;
  const int N = p.n, L = p.n_lights;
  const float b8 = __ldg(p.b8);
  const int kw = p.ke / 2;
  for (int idx = tid; idx < BM * kw; idx += NTHREADS) {
    const int r = idx / kw, c = (idx % kw) * 2;
    uint32_t v = 0;
    if (row0 + r < N) v = ld_u32(p.em + (size_t)(row0 + r) * p.ke + c);
    *reinterpret_cast<uint32_t*>(act + r * LDA + c) = v;
  }
  __syncthreads();
  {
    float acc[4][NT][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      warp_gemm<W>(act, p.ke, pass == 0 ? p.w0xT : p.w5xT, acc, n_base, g, t);
      float* dst = pass == 0 ? a0s : b5s;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dst[(i * 16 + g + (r >> 1) * 8) * LDF + n_base + j * 8 + 2 * t + (r & 1)] =
                acc[i][j][r];
    }
  }
  __syncthreads();
  float acc[8][NT][4];
  for (int l = 0; l < L; l += 2) {
    const int l1 = l + 1 < L ? l + 1 : L - 1;
    for (int idx = tid; idx < 2 * BM * W; idx += NTHREADS) {
      const int r = idx / W, c = idx % W;
      const float* r0l = p.r0 + (size_t)(r < BM ? l : l1) * W;
      act[r * LDA + c] = __float2bfloat16_rn(
          fmaxf(a0s[(r % BM) * LDF + c] + r0l[c], 0.f));
    }
    __syncthreads();
    for (int li = 0; li < p.n_trunk; ++li) {
      warp_gemm2<W>(act, p.trunk_wT + (size_t)li * W * W, acc, n_base, g, t);
      __syncthreads();
      const bool skip = li == p.n_pre;
      const bool last = li == p.n_trunk - 1;
      const float* bias = p.trunk_b + (size_t)li * W;
      float part[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i][0] = part[i][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* r5l = p.r5 + (size_t)(i < 4 ? l : l1) * W;
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
              const float pre = skip ? (a + b5s[(row % BM) * LDF + col + e]) + r5l[col + e]
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
      }
      if (last) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = part[i][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t == 0) red[warp * 2 * BM + i * 16 + g + h * 8] = v;
          }
      }
      __syncthreads();
    }
    if (tid < 2 * BM) {
      const int n = row0 + (tid % BM);
      const int ll = tid < BM ? l : l + 1;
      if (n < N && ll < L) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) s += red[w * 2 * BM + tid];
        p.out[(size_t)ll * N + n] = s + b8;
      }
    }
    __syncthreads();
  }
}

"""

PARENT = {
    "occ_base": ("fused_occ.cu", []),
    "occ_relu": ("fused_occ.cu", [(OCC_SP, "  return fmaxf(x, 0.f);")]),
    "occ_smem_w": ("fused_occ.cu", [
        (OCC_TRUNK,
         "    for (int idx = threadIdx.x; idx < W * W / 8; idx += NTHREADS) {\n"
         "      const int r = idx / (W / 8), c = idx % (W / 8);\n"
         "      *reinterpret_cast<uint4*>(wsm + r * (W + 8) + c * 8) = __ldg(\n"
         "          reinterpret_cast<const uint4*>(p.trunk_wT + (size_t)li * W * W\n"
         "                                         + (size_t)r * W) + c);\n"
         "    }\n"
         "    __syncthreads();\n"
         "    warp_gemm<NT, false>(act, LDA, W, wsm, W + 8, n_base, acc, true);"),
        (OCC_RED, OCC_RED + "\n  __nv_bfloat16* wsm = reinterpret_cast<"
         "__nv_bfloat16*>(red + NWARPS * BM);          // [W][W + 8]"),
        (OCC_SMEM, "                      (size_t)NWARPS * BM * sizeof(float) +\n"
         "                      (size_t)W * (W + 8) * sizeof(__nv_bfloat16);"),
        ("__launch_bounds__(NTHREADS, 2)", "__launch_bounds__(NTHREADS, 1)")]),
    "vis_base": ("fused_vis.cu", []),
    "vis_smem_w": ("fused_vis.cu", [
        (VIS_TRUNK, "      warp_gemm_staged<W>(act, p.trunk_wT + (size_t)li * W * W,"
                    " wsm, acc, n_base, g, t);"),
        (VIS_PIXS, VIS_PIXS + "\n  __nv_bfloat16* wsm = reinterpret_cast<"
         "__nv_bfloat16*>(pixs + BM * PIXW);   // [W][72]"),
        (VIS_SMEM, "         (size_t)BM * PIXW * sizeof(float) +\n"
         "         (size_t)W * 72 * sizeof(__nv_bfloat16);"),
        (VIS_KERNEL_HEAD, VIS_STAGED + VIS_KERNEL_HEAD)]),
    "vis_stacked": ("fused_vis.cu", [
        ("span", VIS_KERNEL_HEAD, VIS_KERNEL_END, VIS_STACKED + VIS_KERNEL_END),
        ("(size_t)BM * (W + 8) * sizeof(__nv_bfloat16) +\n"
         "         (size_t)NWARPS * BM * sizeof(float) +",
         "2 * (size_t)BM * (W + 8) * sizeof(__nv_bfloat16) +\n"
         "         2 * (size_t)NWARPS * BM * sizeof(float) +")]),
}

ENG_SP = """  const float e = ex2_approx(fabsf(bx) * -1.4426950408889634f);
  const float l = lg2_approx(1.f + e) * 0.6931471805599453f;
  return bx > 20.f ? x : (fmaxf(bx, 0.f) + l) * 0.01f;"""
VIS_BIAS_RELU = """            acc[4 * j + 0] = fmaxf(acc[4 * j + 0] + b.x, 0.f);
            acc[4 * j + 1] = fmaxf(acc[4 * j + 1] + b.y, 0.f);
            acc[4 * j + 2] = fmaxf(acc[4 * j + 2] + b.x, 0.f);
            acc[4 * j + 3] = fmaxf(acc[4 * j + 3] + b.y, 0.f);"""
ENG_MMA = """      Mma<W>::rs(acc, a[ks], desc(acquire()), (ks > 0 || accumulate) ? 1 : 0);"""
ENGINE = {
    "eng_base": [],
    "eng_precise": [("fused_occ.cu", ENG_SP, OCC_SP)],
    "eng_no_pingpong": [("fused_occ.cu", "pp.begin();", ""),
                        ("fused_occ.cu", "pp.end();", ""),
                        ("fused_occ.cu", "pp.open();", "")],
    "eng_relu": [("fused_occ.cu", ENG_SP, "  return fmaxf(x, 0.f);")],
    "eng_vis_no_bias_relu": [("fused_vis.cu", VIS_BIAS_RELU, "            (void)b;")],
    "eng_vis_no_mma": [("trunk_wgmma.cuh", ENG_MMA, "      (void)acquire();")],
}
VIS_VARIANTS = ("eng_base", "eng_vis_no_bias_relu", "eng_vis_no_mma")

L2_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void l2_read(const uint4* __restrict__ src, size_t n, int passes,
                        unsigned* out) {
  unsigned acc = 0;
  for (int k = 0; k < passes; ++k)
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
      const uint4 v = __ldcg(src + i);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  if (acc == 0x9e3779b9u) out[0] = acc;      // keeps the loads
}
extern "C" int l2_read_launch(const void* src, size_t bytes, int passes,
                              void* out, int grid, void* stream) {
  l2_read<<<grid, 512, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, bytes / 16, passes, (unsigned*)out);
  return (int)cudaGetLastError();
}
"""


def apply(text, patches, what):
    for pt in patches:
        if pt[0] == "span":
            _, head, end, new = pt
            a, b = text.find(head), text.find(end)
            if a < 0 or b < a:
                raise RuntimeError(f"{what}: span not found")
            text = text[:a] + new + text[b + len(end):]
            continue
        old, new = pt
        if old not in text:
            raise RuntimeError(f"{what}: patch target not found:\n{old}")
        text = text.replace(old, new)
    return text


def build(parent, out_root):
    """One nvcc per variant, all at once. Returns {variant: (dir, libs,
    ptxas lines)}."""
    from psnerf_torch.ops.build import CSRC, NVCC_FLAGS, _nvcc

    jobs = []
    for name, (fname, patches) in PARENT.items():
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(parent, d)
        path = os.path.join(d, fname)
        text = apply(open(path).read(), patches, name)
        open(path, "w").write(text)
        jobs.append((name, d, fname))
    for name, patches in ENGINE.items():
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        for fname in ("trunk_wgmma.cuh", "fused_occ.cu", "fused_vis.cu"):
            path = os.path.join(d, fname)
            mine = [(o, n) for f, o, n in patches if f == fname]
            text = apply(open(path).read(), mine, name)
            open(path, "w").write(text)
            if fname == "fused_occ.cu" or (fname == "fused_vis.cu"
                                           and name in VIS_VARIANTS):
                jobs.append((name, d, fname))
    d = os.path.join(out_root, "l2")
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, "l2.cu"), "w").write(L2_SRC)
    jobs.append(("l2", d, "l2.cu"))
    procs = []
    for name, d, fname in jobs:
        lib = os.path.join(d, "lib" + fname[:-3] + ".so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib, os.path.join(d, fname)]
        procs.append((name, fname, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = {}
    for name, fname, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{fname}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        out.setdefault(name, {})[fname[:-3]] = (lib, regs)
    return out


def ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(fns, reps):
    """{name: mean ms} over two turns, in order and then reversed."""
    got = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        got[k].append(ms(fns[k], reps[k] if isinstance(reps, dict) else reps))
    return {k: float(np.mean(v)) for k, v in got.items()}, got


def parent_occ_call(lib, ops, em, out):
    names = ("w0T", "b0", "wskipT", "trunk_wT", "trunk_b", "w8", "b8")
    ptrs = (ctypes.c_void_p * 9)(em.data_ptr(),
                                 *[ops[k].data_ptr() for k in names],
                                 out.data_ptr())
    ints = (ctypes.c_int * 5)(em.shape[0], ops["width"], ops["ke"],
                              ops["trunk_wT"].shape[0], ops["n_pre"])
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.psnerf_fused_occ(ptrs, ints, ctypes.c_void_p(stream))
        if rc:
            raise RuntimeError(f"parent fused_occ failed: {rc}")
    return call


def parent_vis_call(lib, mode, ops, sh, out):
    from psnerf_torch.fields.brdf import SG_LOBES

    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    i = ctypes.c_int
    lobes = (ctypes.c_float * 9)(*[float(x) for x in SG_LOBES])
    stream = torch.cuda.current_stream().cuda_stream
    args = (i(mode), i(ops["width"]), p(ops["em"]), i(ops["n"]), i(ops["ke"]),
            p(ops["w0xT"]), p(ops["w5xT"]), p(ops["r0"]), p(ops["r5"]),
            i(ops["n_lights"]), p(ops["trunk_wT"]), p(ops["trunk_b"]),
            i(ops["trunk_wT"].shape[0]), i(ops["n_pre"]), p(ops["w8"]),
            p(ops["b8"]), p(sh and sh["pix"]), p(sh and sh["ld"]),
            p(sh and sh["lint"]), lobes, i(sh["nbasis"] if sh else 0),
            i(int(sh["specular_rgb"]) if sh else 0), p(out),
            ctypes.c_void_p(stream))

    def call():
        rc = lib.psnerf_fused_vis(*args)
        if rc:
            raise RuntimeError(f"parent fused_vis failed: {rc}")
    return call


def l2_bandwidth(lib_path):
    lib = ctypes.CDLL(lib_path)
    lib.l2_read_launch.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(4, dtype=torch.int32, device="cuda")
    res = {}
    for mb in (8, 16, 32):
        buf = torch.randint(0, 1 << 30, (mb << 18,), dtype=torch.int32,
                            device="cuda")
        passes = 20
        stream = torch.cuda.current_stream().cuda_stream
        f = lambda: lib.l2_read_launch(buf.data_ptr(), buf.numel() * 4, passes,
                                       sink.data_ptr(), 4 * sms, stream)
        t = ms(f, 5)
        res[f"{mb}MB"] = {"ms": t, "tb_per_s": buf.numel() * 4 * passes / t
                          / 1e9}
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="csrc of the mma.sync design (see the docstring)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.ops import fused_occ as fo
    from psnerf_torch.ops import fused_vis as fv

    torch.set_grad_enabled(False)
    built = build(args.parent, os.path.join(ROOT, "_chipcheck", "attr_trunk"))
    for name, libs in built.items():
        print(json.dumps({"ptxas": name, **{k: v[1] for k, v in libs.items()}}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    # ---- SASS counts of K1 per softplus, both designs
    for name in ("occ_base", "eng_base"):
        counts = chip_smoke.sass_counts(built[name]["fused_occ"][0],
                                        "occ_kernel", 256)
        print(json.dumps({"sass": name, **counts}), flush=True)

    # ---- L2 read bandwidth
    print(json.dumps({"l2_read": l2_bandwidth(built["l2"]["l2"][0])}),
          flush=True)

    # ---- K1
    cfg = OccFieldConfig(compute_dtype="bfloat16")
    field = init_occupancy_field(
        cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    ops = fo.pack_occ_operands(field, cfg)
    rng = np.random.default_rng(1)
    libs = {}
    for name in PARENT:
        lib = ctypes.CDLL(built[name][PARENT[name][0][:-3]][0])
        libs[name] = lib

    def eng(name, what):
        """The variant's library as the port's wrapper binds it."""
        mod = {"fused_occ": fo, "fused_vis": fv}[what]
        load = mod.load_library
        mod.load_library = lambda _: ctypes.CDLL(built[name][what][0])
        mod._lib_handle[:] = []
        lib = mod._lib()
        mod.load_library = load
        return lib, mod

    for n in (524288, 2048):
        p = torch.as_tensor((rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
                            device="cuda")
        em = fo.occ_embed(p, ops)
        out = torch.empty(n, dtype=torch.float32, device="cuda")
        fns = {k: parent_occ_call(libs[k], ops, em, out)
               for k in ("occ_base", "occ_relu", "occ_smem_w")}
        for name in ENGINE:
            lib, _ = eng(name, "fused_occ")

            def run(lib=lib):
                fo._lib_handle[:] = [lib]
                fo._launch(ops, em, out)
            fns[name] = run
        reps = args.reps if n > 100000 else 50
        mean, turns = in_turns(fns, reps)
        print(json.dumps({"K1": {"n": n, "ms": mean, "turns": turns}}),
              flush=True)
        del p, em, out
    fo._lib_handle[:] = []

    # ---- K4 (raw) and K5 (lnc)
    layers, pe, le, sh = chip_smoke.kernel_inputs(65536, 96, 0)
    vops = fv.pack_vis_operands(layers, pe, le)
    shp = fv.pack_shade_operands(sh["normal"], sh["view"], sh["albedo"],
                                 sh["weights"], sh["mask"], sh["light_dirs"],
                                 sh["light_ints"], 9, True)
    raw = torch.empty((96, 65536), dtype=torch.float32, device="cuda")
    rgb = torch.empty((96, 65536, 3), dtype=torch.float32, device="cuda")
    fns = {"vis_base_raw": parent_vis_call(libs["vis_base"], 0, vops, None, raw),
           "vis_smem_w_raw": parent_vis_call(libs["vis_smem_w"], 0, vops, None,
                                             raw),
           "vis_stacked_raw": parent_vis_call(libs["vis_stacked"], 0, vops,
                                              None, raw),
           "vis_base_lnc": parent_vis_call(libs["vis_base"], 1, vops, shp, rgb)}
    def eng_vis(name, mode, o):
        lib, _ = eng(name, "fused_vis")

        def run():
            fv._lib_handle[:] = [lib]
            fv._launch(mode, vops, None if mode == "raw" else shp, o)
        return run
    for name in VIS_VARIANTS:
        fns[f"{name}_raw"] = eng_vis(name, "raw", raw)
    fns["eng_base_lnc"] = eng_vis("eng_base", "lnc", rgb)
    mean, turns = in_turns(fns, 2)
    print(json.dumps({"K4_K5": {"n": 65536, "lights": 96, "ms": mean,
                                "turns": turns}}), flush=True)
    fv._lib_handle[:] = []
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
