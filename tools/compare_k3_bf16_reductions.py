#!/usr/bin/env python3
"""The bf16 fused_radiance backward (K3-bf16, csrc/fused_radiance.cu) with
its weight gradients added as one float2 reduction per pair of adjacent
columns (the checkout's source) against the same source with two scalar
atomicAdds in their place, on one card in one process:

    python3 tools/compare_k3_bf16_reductions.py [--n 196608] [--rounds 3]

It copies csrc into _chipcheck/k3_red/<variant>/, patches the scalar copy,
builds both with nvcc at once, and times radiance_backward (slot zeroing,
kernel and slot sum) at the bf16 bear field (OccFieldConfig(compute_dtype=
"bfloat16"), random weights from seed 0) by CUDA events, in turns (scalar,
float2, float2, scalar, per round). Each element keeps its owning thread
and its order of adds in both, so their gradients must agree bit for bit:
it checks that. Prints one JSON line per variant, and last the card's name
and power limit.
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

SCALAR = ("  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));",
          "  atomicAdd(dst, a);\n  atomicAdd(dst + 1, b);")


def build(src, out_root):
    from psnerf_torch.ops.build import NVCC_FLAGS, _nvcc

    procs = {}
    for name in ("float2", "scalar"):
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        path = os.path.join(d, "fused_radiance.cu")
        if name == "scalar":
            text = open(path).read()
            if SCALAR[0] not in text:
                raise RuntimeError("patch target not in fused_radiance.cu")
            open(path, "w").write(text.replace(*SCALAR))
        lib = os.path.join(d, "libfused_radiance.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = (lib, [ln.strip() for ln in out.splitlines()
                            if "registers" in ln or "spill" in ln])
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=196608)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.ops import fused_radiance as fr

    libs = build(os.path.join(ROOT, "psnerf_torch", "ops", "csrc"),
                 os.path.join(ROOT, "_chipcheck", "k3_red"))
    cfg = OccFieldConfig(compute_dtype="bfloat16")
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
        packed = fr.pack_radiance(field, cfg, torch.bfloat16)
        _, g_e = fr.radiance_forward_plain(packed, em, de, vpe, p3, skip)

    def use(name):
        # the wrapper binds the variant's library on its next launch
        fr._lib_handle[:] = []
        fr.load_library = lambda _: ctypes.CDLL(libs[name][0])
        fr._lib()

    bwd = lambda: fr.radiance_backward(packed, em, de, vpe, p3, g_e, g_out,
                                       skip)

    def ms(reps):
        bwd()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            bwd()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    grads, turns = {}, {"float2": [], "scalar": []}
    with torch.no_grad():
        for name in ("scalar", "float2"):
            use(name)
            grads[name] = bwd()
        same = all(torch.equal(grads["scalar"][k], grads["float2"][k])
                   for k in fr.PACK_ORDER)
        for _ in range(args.rounds):
            for name in ("scalar", "float2", "float2", "scalar"):
                use(name)
                turns[name].append(ms(args.reps))
    for name, t in turns.items():
        print(json.dumps({name: {"ms": float(np.mean(t)), "turns_ms": t,
                                 "ptxas": libs[name][1]}}), flush=True)
    print(json.dumps({"n": n, "bitwise_equal": same,
                      "saved_ms": float(np.mean(turns["scalar"])
                                        - np.mean(turns["float2"]))}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
