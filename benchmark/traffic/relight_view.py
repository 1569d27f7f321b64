"""Stage-2 relighting as the command line's --render_envmap runs it:
`Stage2Runner.render_envmap` of the test views under a lat-long sky, one
directional light per texel (light_h x 2 light_h), the light sum in chunks
of the runner's ENV_CHUNK on the device, one PNG a view.

Set-up builds the scene, its shape export, the PSNet weights and the
runner as the evaluation cell does (traffic.train_stage2.build), draws the
sky from the seed and relights every test view once. The window calls
render_envmap over the test views for --seconds and counts whole views.
Two views of the window, drawn from the seed, are kept as the float
frames render_envmap hands its on_view callback (clipped, gamma-mapped,
white off the mask), and at a seeded sample of their surface pixels they
are held against the reference's relit rgb.
"""

from __future__ import annotations

import inspect
import json
import os
from contextlib import nullcontext

import numpy as np
import torch

from benchmark import harness, trace
from benchmark.reference import relight as rel
from benchmark.reference import stage2 as ref
from benchmark.reference.common import precision
from benchmark.traffic.train_stage2 import build


def sky(seed: int, light_h: int) -> np.ndarray:
    """A seeded lat-long HDR sky [light_h, 2 light_h, 3]: a blue gradient,
    brighter toward the zenith, and one warm sun of 2x2 texels at 20-50
    times the sky, above the horizon."""
    rng = np.random.default_rng(seed)
    h, w = light_h, 2 * light_h
    base = rng.uniform(0.004, 0.008)
    up = np.linspace(1.0, 0.3, h)[:, None, None]
    env = base * (0.5 + up) * np.asarray([0.7, 0.85, 1.0]) * np.ones((h, w, 1))
    r = rng.integers(1, max(2, h // 2 - 1))
    c = rng.integers(0, w - 1)
    env[r:r + 2, c:c + 2] = base * rng.uniform(20, 50) * np.asarray(
        [1.0, 0.9, 0.75])
    return env.astype(np.float32)


def setup(run):
    from psnerf_torch.runners.stage2 import Stage2Runner

    if "on_view" not in inspect.signature(Stage2Runner.render_envmap) \
            .parameters:
        raise RuntimeError("Stage2Runner.render_envmap takes no on_view")
    runner, net, w0, scene, export = build(run)
    p = run.params
    envmap = sky(run.seed, p["light_h"])
    out_dir = os.path.join(run.dir, "relit")
    runner.render_envmap(out_dir, envmap, split="test",
                         light_h=p["light_h"], tile=p["tile"])
    data = runner._eval_data("test")
    rng = np.random.default_rng(run.seed)
    picks = set(rng.choice(p["pick_from"], 2, replace=False).tolist())
    surf = [np.flatnonzero(data["surface_mask"][v].cpu().numpy())
            for v in range(len(data["views"]))]
    sample = [np.sort(rng.choice(s, min(len(s), p["pixels"]),
                                 replace=False)) for s in surf]
    run.work.update(n_surface=[len(s) for s in surf],
                    n_texels=int(envmap.shape[0] * envmap.shape[1]))
    return {"runner": runner, "envmap": envmap, "out_dir": out_dir,
            "picks": picks, "sample": sample, "net": net, "w0": w0,
            "scene": scene, "export": export, "kept": {}, "views": []}


def window(run, state):
    """render_envmap calls for --seconds. Untraced, a profiler of the device
    alone reads the card's kernel time per view (eval_view_kernel_ms)."""
    runner, p = state["runner"], run.params
    cuda = run.device != "cpu"
    prof = nullcontext() if run.trace else trace.device_only(cuda)

    def keep(v, img):
        i = len(state["views"])
        if i in state["picks"]:
            state["kept"][i] = (v, img)
        state["views"].append(v)

    def one():
        n = len(state["views"])
        runner.render_envmap(state["out_dir"], state["envmap"], split="test",
                             light_h=p["light_h"], tile=p["tile"],
                             on_view=keep)
        return len(state["views"]) - n

    with prof:
        w = harness.timed_loop(run, one, run.seconds)
    run.work["views"] = list(state["views"])
    metrics = {}
    if not run.trace:
        metrics["eval_view_kernel_ms"] = \
            1e3 * trace.kernel_busy_seconds(prof, cuda) / w["units"]
    return {"attempted": w["units"], "failed": 0, "elapsed": w["elapsed"],
            "metrics": metrics}


def collect(run, state):
    """The kept frames at the sampled pixels."""
    kept = []
    for i, (v, img) in sorted(state["kept"].items()):
        px = img.reshape(-1, 3)[state["sample"][v]]
        kept.append((v, torch.as_tensor(px)))
    return {"kept": kept, "sample": state["sample"], "net": state["net"],
            "w0": state["w0"], "scene": state["scene"],
            "export": state["export"], "envmap": state["envmap"]}


def reference(run, out, control=False):
    """The reference's relit rgb of every kept view at the sampled
    pixels."""
    dev = torch.device(run.device)
    with open(os.path.join(out["scene"], "params.json")) as f:
        params = json.load(f)
    views = params["view_test"]
    d = ref.load_views(out["scene"], out["export"], views, dev, images=False)
    w = params["imhw"][1]
    res = {}
    for v in {v for v, _ in out["kept"]}:
        idx = torch.as_tensor(out["sample"][v], device=dev)
        uv = torch.stack([idx % w, idx // w], -1).float()
        with precision(control):
            res[v] = rel.relight(out["w0"], out["net"], d["points"][v][idx],
                                 d["normals"][v][idx], uv, d["poses_cv"][v],
                                 d["K"], out["envmap"]).double().cpu()
    return res


def readings(run, out, variant="program") -> dict:
    want = reference(run, out)
    got = out["kept"] if variant == "program" else \
        list(reference(run, out, control=True).items())
    err, mean = 0.0, 0.0
    for v, g in got:
        e = (g.double() - want[v]).abs()
        err, mean = max(err, float(e.max())), max(mean, float(e.mean()))
    sums = torch.cat([want[v] for v in want])
    return {"relit_err": err, "relit_mean_err": mean,
            "views_compared": float(len(got)),
            "saturated_share": float((sums >= 1.0).double().mean())}


def check(run, out):
    r = readings(run, out)
    if not r.pop("views_compared"):
        return [("views_compared", float("nan"), 0.0)]
    return [(k, r[k], limit) for k, limit in run.limits.items()]
