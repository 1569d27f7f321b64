#!/usr/bin/env python3
"""How far the stage-2 step's gradients on the card lie from the CPU's,
and why: one loss_and_grads of the full bear PSNet (8,192 pixels x 10
lights, 8 vis_plus lights, after the warm-up) from one parameter set,
batch and jitter draws (the inputs of tests/test_torch_gpu.py's stage-2
step test), run as

    python3 tools/stage2_grad_precision.py [--pixels N]

in f32 and f64 on the CPU and on the card, and in f32 with the positional
encoding computed in f64 (then rounded to f32) on both. Prints, per
gradient leaf, max |a - b| over the f64 CPU gradient's max |g| for each
pair (the ten leaves where the card and the CPU differ most in f32), the
card's f32 gradient rerun against itself, one JSON line of the maxima, and
last the card's name and power limit. TF32 is off.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from psnerf_torch.fields.psnet import PSNetConfig, init_psnet  # noqa: E402
from psnerf_torch.render import shading  # noqa: E402
from psnerf_torch.train import stage2  # noqa: E402

N_ROWS, N_LIGHTS, N_VIS = 40, 10, 8


def unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def make_batch(n, seed=8):
    """A batch of random pixels of a camera at 3 looking at the origin."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -3.0)
    k = np.asarray([[400.0, 0, 256, 0], [0, 400.0, 256, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float32)
    mask = rng.uniform(size=n) > 0.1
    return {
        "uv": f(rng.uniform(0, 512, size=(n, 2))), "pose": f(pose),
        "intrinsics": f(k), "object_mask": torch.as_tensor(mask),
        "points": f(rng.normal(size=(n, 3)) * 0.3),
        "normal": f(unit(rng, (n, 3))),
        "surface_mask": torch.as_tensor(mask | (rng.uniform(size=n) > 0.5)),
        "rgb_gt": f(rng.uniform(size=(N_LIGHTS, n, 3))),
        "l_slt": torch.as_tensor(rng.choice(N_ROWS, N_LIGHTS,
                                            replace=False)),
        "visibility": f(rng.uniform(size=(N_LIGHTS, n)) > 0.3),
        "light_vis_train": f(unit(rng, (N_VIS, 3))),
        "vis_train_gt": f(rng.uniform(size=(N_VIS, n)) > 0.3)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pixels", type=int, default=8192)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tcfg = PSNetConfig(), stage2.Stage2TrainConfig()
    model = init_psnet(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():      # a visibility above 0: the rgb loss flows
        model["visibility"][-1].b.add_(0.5)
    dirs = unit(np.random.default_rng(9), (N_ROWS, 3))
    batch = make_batch(args.pixels)
    noise = shading.draw_psnet_noise(args.pixels,
                                     torch.Generator().manual_seed(1))
    embed = shading.nerf_embed

    def grads(dev, dt, embed64=False):
        shading.nerf_embed = ((lambda x, n: embed(x.double(), n).to(x.dtype))
                              if embed64 else embed)
        try:
            params = stage2.init_stage2_params(
                copy.deepcopy(model).to(dev, dt), dirs,
                np.full((N_ROWS, 1), 2.0), dev)
            for k in ("light_dirs", "light_ints"):
                params[k] = params[k].to(dt)
            cast = lambda v: v.to(dev, dt) if v.is_floating_point() \
                else v.to(dev)
            _, step = stage2.make_stage2_train_step(cfg, tcfg)
            _, g = step.loss_and_grads(
                params, {k: cast(v) for k, v in batch.items()}, 6000,
                {k: cast(v) for k, v in noise.items()})
        finally:
            shading.nerf_embed = embed
        return {k: v.detach().double().cpu() for k, v in g.items()}

    f32, f64 = torch.float32, torch.float64
    runs = {"cpu32": grads("cpu", f32), "cpu64": grads("cpu", f64),
            "card32": grads("cuda", f32), "card64": grads("cuda", f64),
            "cpu32_embed64": grads("cpu", f32, True),
            "card32_embed64": grads("cuda", f32, True),
            "card32_rerun": grads("cuda", f32)}
    ref = runs["cpu64"]
    pairs = [("cpu32", "cpu64"), ("card32", "cpu64"), ("card64", "cpu64"),
             ("card32", "cpu32"), ("card32_embed64", "cpu32_embed64"),
             ("card32_rerun", "card32")]
    dist = {f"{a} - {b}": {k: (runs[a][k] - runs[b][k]).abs().max().item()
                           / (ref[k].abs().max().item() + 1e-8) for k in ref}
            for a, b in pairs}
    worst = sorted(ref, key=lambda k: -dist["card32 - cpu32"][k])[:10]
    print("%-18s" % "leaf" + "".join("%24s" % p for p in dist))
    for k in worst:
        print("%-18s" % k + "".join("%24.3e" % d[k] for d in dist.values()))
    print(json.dumps({"pixels": args.pixels, "max_over_leaves": {
        p: {"max": max(d.values()), "leaf": max(d, key=d.get)}
        for p, d in dist.items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
