#!/usr/bin/env python3
"""Attribution of the f32-operand fused_radiance kernels' time
(csrc/fused_radiance_f32.cu, and only that source) to the parts of their
tile products, by timing patched copies of the source. Run it on a card:

    python3 tools/attribute_radiance_f32.py [--n 196608]

It copies csrc (or --src) into _chipcheck/attr/<variant>/, patches each
copy as below, builds every copy with nvcc at once, and times the forward
(prologue and forward kernel) and the backward's prologue and sweeps of
each at the default field (OccFieldConfig(), random weights from seed 0)
with CUDA events, in turns (variants in order, then reversed). Variants:
  * base:          unchanged;
  * no_fadd:       each pair of k-steps' six wgmma chained into the
                   accumulator itself (no FADD): what the round-to-nearest
                   adds cost;
  * one_mma:       one wgmma per k-step instead of three: how far the tile
                   products are bound by the tensor cores;
  * fast_softplus: the trunk's softplus from the approximate __expf and
                   __logf: what the exact transcendental functions cost.
The variants' outputs are not checked: they exist only to be timed. Prints
one JSON line per variant and one summary line with the card's name and
power limit.
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

PRODUCTS = """      Wgmma<NW>::run(d, al, bh, h);
      Wgmma<NW>::run(d, ah, bl, 1);
      Wgmma<NW>::run(d, ah, bh, 1);"""
FADD = """    float d[NW / 2];
    wgmma_fence();"""
ADDS = """#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[0][j][r] += d[4 * j + r];"""

PATCHES = {
    "base": [],
    "no_fadd": [("fused_radiance_f32.cu", FADD,
                 "    float (&d)[NW / 2] = reinterpret_cast<float (&)[NW / 2]>"
                 "(acc);\n    wgmma_fence();"),
                ("fused_radiance_f32.cu", PRODUCTS,
                 PRODUCTS.replace("run(d, al, bh, h)", "run(d, al, bh, 1)")),
                ("fused_radiance_f32.cu", ADDS, "")],
    "one_mma": [("fused_radiance_f32.cu", PRODUCTS,
                 "      Wgmma<NW>::run(d, ah, bh, h);")],
    "fast_softplus": [("fused_radiance_f32.cu",
                       "  const float e = expf(-fabsf(bx));\n"
                       "  sp = (fmaxf(bx, 0.f) + log1pf(e)) / 100.f;",
                       "  const float e = __expf(-fabsf(bx));\n"
                       "  sp = (fmaxf(bx, 0.f) + __logf(1.f + e)) / 100.f;")],
}


def build(src, out_root):
    from psnerf_torch.ops.build import NVCC_FLAGS, _nvcc

    procs = {}
    for name, plist in PATCHES.items():
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for fname, old, new in plist:
            path = os.path.join(d, fname)
            text = open(path).read()
            if old not in text:
                raise RuntimeError(f"{name}: patch target not in {fname}")
            open(path, "w").write(text.replace(old, new))
        lib = os.path.join(d, "libfused_radiance_f32.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib,
               os.path.join(d, "fused_radiance_f32.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        libs[name] = (lib, regs)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        ROOT, "psnerf_torch", "ops", "csrc"))
    ap.add_argument("--n", type=int, default=196608)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.ops import fused_radiance as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(args.src, os.path.join(ROOT, "_chipcheck", "attr"))
    cfg = OccFieldConfig()
    field = init_occupancy_field(
        cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(1)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    n, skip = args.n, cfg.skips[0] - 1
    p = f(rng.normal(size=(n, 3)) * 0.5)
    v = rng.normal(size=(n, 3))
    rd = f(v / np.linalg.norm(v, axis=-1, keepdims=True))
    g_out = f(rng.uniform(0.5, 1.5, (n, 4)))
    with torch.no_grad():
        em, de, vpe, p3 = fr.radiance_inputs(p, rd, cfg)
        packed = fr.pack_radiance(field, cfg, torch.float32)
        _, g_e = fr.radiance_forward_plain(packed, em, de, vpe, p3, skip,
                                           "float32")

    def use(name):
        # the wrapper binds the variant's library on its next launch
        fr._lib_f32_handle[:] = []
        fr.load_library = lambda _: ctypes.CDLL(libs[name][0])
        fr._lib_f32()

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

    fwd = lambda: fr.radiance_forward(packed, em, de, vpe, p3, skip,
                                      "float32")
    b = fr.F32Backward(packed, em, de, vpe, p3, g_e, g_out, skip)

    def bwd():                       # the backward's prologue and sweeps
        b.split()
        for c in range(b.n_chunks):
            b.sweep(c)
    got = {k: {"fwd": [], "bwd": []} for k in PATCHES}
    order = list(PATCHES) + list(PATCHES)[::-1]
    with torch.no_grad():
        for name in order:
            use(name)
            got[name]["fwd"].append(ms(fwd, args.reps))
            got[name]["bwd"].append(ms(bwd, args.reps))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {}
    for name in PATCHES:
        res[name] = {"fwd_ms": float(np.mean(got[name]["fwd"])),
                     "bwd_ms": float(np.mean(got[name]["bwd"])),
                     "fwd_turns": got[name]["fwd"],
                     "bwd_turns": got[name]["bwd"],
                     "ptxas": libs[name][1]}
        print(json.dumps({name: res[name]}), flush=True)
    base = res["base"]
    print(json.dumps({"card": smi, "n": n, "saved_ms": {
        k: {"fwd": base["fwd_ms"] - r["fwd_ms"],
            "bwd": base["bwd_ms"] - r["bwd_ms"]}
        for k, r in res.items() if k != "base"}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
