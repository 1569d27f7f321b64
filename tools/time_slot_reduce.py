#!/usr/bin/env python3
"""The two fixed-order slot reductions of the fused_radiance backward, timed
three ways in turns with torch.sum over the same slots, on one card:

    python3 tools/time_slot_reduce.py [--root DIR] [--tag NAME]

  * the bf16 backward's reduce (`fr.Bf16Backward.reduce`: `fr.slot_sum`
    over its split-K slots) at the bf16 bear field at 2048 x 96 = 196,608
    points, on random slots (in a checkout
    before the bf16 form's split-K backward, `fr.slot_sum` over 132
    random slots of that field's per-CTA slot length);
  * the f32 backward's reduce (`fr.F32Backward.reduce`) over the split-K
    slots of the default field at 2048 x 96 = 196,608 points (3 chunks).

Each is timed by back-to-back CUDA events (20 launches), by the device
time of 20 launches that torch.profiler sums (device only; up to commit
110aa76 a CUDA graph of 20 captured launches), and by the host clock over
1,000 launches (host µs per launch), and held bit for bit against its
plain version (the f32 reduce where the checkout's gradients are views
of one flat sum). Also the host µs of one whole f32 backward as
`radiance_backward` runs it (a new `F32Backward`, then its launches; a
synchronize between backwards, outside the clock), and the prologue's
`split_weights` by events and host µs. --root imports psnerf_torch from another checkout (e.g.
the parent commit unpacked by `git archive` into _chipcheck/), which
builds its own kernels there, so two commits compare on one card: run
parent, change, change, parent. Prints one JSON line, with the card's
name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import cuda_ms, device_ms, host_us, in_turns  # noqa: E402


def three_ways(fns: dict) -> dict:
    order = list(fns) + list(fns)[::-1]
    ev = in_turns(fns, dict.fromkeys(fns, 20), order)
    dev = in_turns(fns, dict.fromkeys(fns, 20), order, timer=device_ms)
    host = in_turns(fns, dict.fromkeys(fns, 1000), order, timer=host_us)
    return {k: {"ms": ev[k], "device_ms": dev[k], "host_us": host[k]}
            for k in fns}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.ops import fused_radiance as fr

    check = lambda ok, what: ok or sys.exit(f"check failed: {what}")
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tag": args.tag, "root": os.path.abspath(args.root)}

    # the bf16 reduce
    gen = torch.Generator().manual_seed(0)
    cfg = OccFieldConfig(compute_dtype="bfloat16")
    field = init_occupancy_field(cfg, generator=gen, device=dev)
    n, skip = 2048 * 96, cfg.skips[0] - 1
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    noise = lambda *shape: torch.randn(shape, generator=torch.Generator(
        dev).manual_seed(0), device=dev)
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.bfloat16)
        if hasattr(fr, "Bf16Backward"):
            p = f(rng.normal(size=(n, 3)) * 0.5)
            v = rng.normal(size=(n, 3))
            rd = f(v / np.linalg.norm(v, axis=-1, keepdims=True))
            em, de, vpe, p3 = fr.radiance_inputs(p, rd, cfg)
            b = fr.Bf16Backward(packed, em, de, vpe, p3,
                                torch.zeros_like(em), f(np.ones((n, 4))),
                                skip)
            b.partial.copy_(noise(*b.partial.shape))
            want = fr.slot_sum_plain(b.partial)
            b.reduce()
            torch.cuda.synchronize()
            check(torch.equal(b.sum, want), "bf16 reduce bitwise")
            fns = {"kernel": b.reduce,
                   "torch_sum": lambda: torch.sum(b.partial, 0)}
            out["bf16_reduce"] = dict(three_ways(fns), n=n,
                                      slots=b.partial.shape[0],
                                      slot_floats=b.partial.shape[1])
            del b, em, de, vpe, p3, want
        else:
            total = sum(fr.bf16_slot_layout(*fr._dims(packed, skip))[1])
            slots = noise(132, total)
            want = fr.slot_sum_plain(slots)
            got = fr.slot_sum(slots)
            torch.cuda.synchronize()
            check(torch.equal(got, want), "slot sum bitwise")
            fns = {"kernel": lambda: fr.slot_sum(slots),
                   "torch_sum": lambda: torch.sum(slots, 0)}
            out["slot_sum"] = dict(three_ways(fns), slots=132,
                                   slot_floats=total)
            del slots, want

    # the f32 reduce
    cfg = OccFieldConfig()
    field = init_occupancy_field(cfg, generator=gen, device=dev)
    rng = np.random.default_rng(0)
    p = f(rng.normal(size=(n, 3)) * 0.5)
    v = rng.normal(size=(n, 3))
    rd = f(v / np.linalg.norm(v, axis=-1, keepdims=True))
    with torch.no_grad():
        em, de, vpe, p3 = fr.radiance_inputs(p, rd, cfg)
        packed = fr.pack_radiance(field, cfg, torch.float32)
        _, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip, "float32")
        b = fr.F32Backward(packed, em, de, vpe, p3, g_e,
                           f(rng.uniform(0.5, 1.5, (n, 4))), skip)
        b.run()
        torch.cuda.synchronize()
        parts = b.partial.view(b.n_chunks * b.splits, -1)
        want = fr.slot_sum_plain(parts)
        b.reduce()
        torch.cuda.synchronize()
        if hasattr(b, "sum"):
            check(torch.equal(b.sum, want), "f32 reduce bitwise")
        fns = {"kernel": b.reduce, "torch_sum": lambda: torch.sum(parts, 0)}
        out["f32_reduce"] = dict(three_ways(fns), slots=parts.shape[0],
                                 slot_floats=parts.shape[1], n=n)
        # one whole backward as radiance_backward runs it: a new
        # F32Backward, then its launches; and the prologue's split_weights
        g_out = f(rng.uniform(0.5, 1.5, (n, 4)))
        one = lambda: fr.F32Backward(packed, em, de, vpe, p3, g_e, g_out,
                                     skip).run()
        split = lambda: fr.split_weights(packed, skip)
        one()
        out["f32_backward_host_us"] = host_us(one, 50, batch=1)
        out["split"] = dict(ms=cuda_ms(split, 20),
                            host_us=host_us(split, 1000))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
