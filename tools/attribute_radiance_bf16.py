#!/usr/bin/env python3
"""Attribution of the bf16 fused_radiance sweep's time (csrc/
fused_radiance.cu) to its parts, by timing patched copies of the source.
Run it on a card:

    python3 tools/attribute_radiance_bf16.py [--n 196608]

It copies csrc into _chipcheck/attr_bf16/<variant>/, patches each copy as
below, builds every copy with nvcc at once, and times the bf16 backward's
sweeps (all chunks) and its weight-gradient passes at the bf16 field
(OccFieldConfig(compute_dtype="bfloat16"), random weights from seed 0)
with CUDA events, in turns (variants in order, then reversed). Variants:
  * base:       unchanged;
  * no_ws:      the per-layer workspace writes (put_ws: staging and bulk
                stores) removed: what writing the weight-gradient
                operands costs;
  * no_colsum:  the per-tile column sums skipped: what their shuffles,
                barriers and slot updates cost;
  * l2_scratch: every CTA's scratch folded onto 8 CTAs' (~18 MB, inside
                L2): what the scratch's device-memory traffic costs;
  * phases:     unchanged but for SM-clock reads at the sweep's phase
                boundaries: each phase's share of a tile (inputs, trunk
                recompute, appearance forward, appearance backward,
                tangent forward, doubled reverse sweep), the mean over
                the CTAs of one chunk.
The variants' outputs are not checked (l2_scratch races on purpose): they
exist only to be timed. Prints one JSON line per variant and one summary
line with the card's name and power limit.
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
SRC = "fused_radiance.cu"

# the sweep's phase boundaries: phase k ends where PHASES[k] begins (the
# last, the doubled reverse sweep, at the next tile's start)
PHASES = [
    "    // ---- forward recompute (g_e is an input)\n",
    "    // w8l's first half: the column sums of g_logit a_last (f32)\n",
    "    // ---- appearance backward: gz = bf16(g_rgb) @ wa4^T where aa3 > 0\n",
    "    bar_sync(BAR_WG + wg, 128);              // every row's g_n is in rowf\n",
    "    // ---- doubled reverse sweep: (h_bar, t_bar) through s and s''\n",
    "    const int r0 = tile * TROWS + wg * ROWS;       // within the chunk\n",
]
MARK = ("    {{ const unsigned tn = (unsigned)clock(); ph[{0}] += tn - tc; "
        "tc = tn; }}\n")

PATCHES = {
    "base": [],
    "no_ws": [("      o.stage(8 * j + 2 * t + (r & 1), rl + 8 * (r >> 1), "
               "y[4 * j + r]);\n  o.flush(f0, W);",
               "      (void)y;")],
    "no_colsum": [("  const int tw = threadIdx.x & 127, warp = tw >> 5, t = tw & 3;\n"
                   "  const int rl = row_lo(), g = (tw & 31) >> 2;",
                   "  return;\n"
                   "  const int tw = threadIdx.x & 127, warp = tw >> 5, t = tw & 3;\n"
                   "  const int rl = row_lo(), g = (tw & 31) >> 2;")],
    "l2_scratch": [("((size_t)blockIdx.x * NCONS + wg) * (size_t)p.scr_words",
                    "((size_t)(blockIdx.x % 8) * NCONS + wg) * (size_t)p.scr_words")],
    # the sweep's phases timed by the SM clock (consumer 0's first thread
    # of every CTA, summed over its tiles) into the first floats of its
    # column-sum slot
    "phases": [(m, MARK.format(k) + m) for k, m in enumerate(PHASES)] + [
        ("  float* slot = p.colsum + ((size_t)blockIdx.x * NCONS + wg) * C.floats;\n",
         "  float* slot = p.colsum + ((size_t)blockIdx.x * NCONS + wg) * C.floats;\n"
         "  unsigned ph[6] = {0, 0, 0, 0, 0, 0}, tc = (unsigned)clock();\n"),
        ("  if (tw == 0) bulk_wait();              // the staging reads, the stores\n",
         MARK.format(5) + "  if (tw == 0) bulk_wait();\n"
         "  if (tw == 0 && wg == 0)\n"
         "    for (int k = 0; k < 6; ++k) slot[k] = __uint_as_float(ph[k]);\n")],
}
PHASE_NAMES = ["inputs", "recompute_trunk", "appearance_forward",
               "appearance_backward", "tangent_forward", "reverse_sweep"]


def build(src, out_root):
    from psnerf_torch.ops.build import NVCC_FLAGS, _nvcc

    procs = {}
    for name, plist in PATCHES.items():
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        path = os.path.join(d, SRC)
        text = open(path).read()
        for old, new in plist:
            if old not in text:
                raise RuntimeError(f"{name}: patch target not in {SRC}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        lib = os.path.join(d, "libfused_radiance.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [ln.strip()[-90:] for ln in out.splitlines()
                if "spill" in ln]
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

    libs = build(args.src, os.path.join(ROOT, "_chipcheck", "attr_bf16"))
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

    got = {k: {"sweep": [], "wgrad": []} for k in PATCHES}
    phases = None
    order = list(PATCHES) + list(PATCHES)[::-1]
    with torch.no_grad():
        for name in order:
            use(name)
            b = fr.Bf16Backward(packed, em, de, vpe, p3, g_e, g_out, skip)
            got[name]["sweep"].append(ms(lambda: [
                b.sweep(c) for c in range(b.n_chunks)], args.reps))
            got[name]["wgrad"].append(ms(lambda: [
                b.wgrad(c) for c in range(b.n_chunks)], args.reps))
            if name == "phases":
                # one chunk's sweep, then each CTA's consumer-0 clocks
                b.sweep(0)
                torch.cuda.synchronize()
                cyc = (b.colsums[0::2, :6].contiguous().view(torch.int32)
                       .cpu().numpy().astype(np.uint32).astype(np.float64))
                tot = cyc.sum(1, keepdims=True)
                share = (cyc / tot).mean(0)
                phases = dict(zip(PHASE_NAMES, map(float, share)))
            del b
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {}
    for name in PATCHES:
        res[name] = {k: float(np.mean(x)) for k, x in got[name].items()}
        res[name]["turns"] = got[name]
        res[name]["spills"] = libs[name][1]
        print(json.dumps({name: res[name]}), flush=True)
    base = res["base"]
    print(json.dumps({"card": smi, "n": n, "saved_ms": {
        k: {"sweep": base["sweep"] - r["sweep"]}
        for k, r in res.items() if k not in ("base", "phases")},
        "sweep_phase_share": phases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
