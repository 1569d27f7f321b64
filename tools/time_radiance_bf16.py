#!/usr/bin/env python3
"""K2-bf16 and K3-bf16 (fused_radiance_and_alpha's bf16 forward and
backward) of two checkouts timed in turns in one run on one card, so the
two can be compared. Run it on a card:

    python3 tools/time_radiance_bf16.py --parent DIR [--n 196608]

DIR is another checkout of the repository (for example `git archive` of
the parent commit unpacked into _chipcheck/). Each turn is a fresh process
that imports psnerf_torch from one tree (building its kernels on first
use), makes the bf16 bear field (OccFieldConfig(compute_dtype=
"bfloat16"), random weights from seed 0) and N points from seed 1, and
times radiance_forward (5 launches) and radiance_backward (3 launches)
between CUDA events after one warm-up launch each. The turns go parent,
change, change, parent. Prints one JSON line per turn and one summary
line with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root, n):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.ops import fused_radiance as fr

    assert fr.__file__.startswith(os.path.abspath(root)), fr.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = OccFieldConfig(compute_dtype="bfloat16")
    field = init_occupancy_field(
        cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(1)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    skip = cfg.skips[0] - 1
    p = f(rng.normal(size=(n, 3)) * 0.5)
    v = rng.normal(size=(n, 3))
    rd = f(v / np.linalg.norm(v, axis=-1, keepdims=True))
    g_out = f(rng.uniform(0.5, 1.5, (n, 4)))

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

    with torch.no_grad():
        em, de, vpe, p3 = fr.radiance_inputs(p, rd, cfg)
        packed = fr.pack_radiance(field, cfg, torch.bfloat16)
        _, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip)
        k2 = ms(lambda: fr.radiance_forward(packed, em, de, vpe, p3, skip),
                5)
        k3 = ms(lambda: fr.radiance_backward(packed, em, de, vpe, p3, g_e,
                                             g_out, skip), 3)
    print(json.dumps({"root": root, "n": n, "k2_ms": k2, "k3_ms": k3}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the other checkout")
    ap.add_argument("--n", type=int, default=196608)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.n)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    got = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             trees[name], "--n", str(args.n)], capture_output=True,
            text=True, cwd=trees[name])
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        got[name].append(row)
        print(json.dumps({"turn": name, **row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "n": args.n, **{
        f"{name}_{k}": [r[k] for r in rows]
        for name, rows in got.items() for k in ("k2_ms", "k3_ms")}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
