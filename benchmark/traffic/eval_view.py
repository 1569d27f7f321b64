"""Stage-2 evaluation of test views as `evaluate` renders them:
`Stage2Runner.render_view` of each test view in a fixed order, every
pixel under the view's lights (trained_lights_for_view), with the outputs
evaluate asks for (rgb, albedo, rough, visibility, normal_pred) as host
arrays.

Set-up builds the scene, its analytic shape export, the PSNet weights
(visibility output lifted: at raw init it clips to ~0) and the runner,
then renders every test view once, three results held at a time as in
the window, so that the window's page-locked read-backs all find their
host blocks in the allocator's cache. The window renders views for
--seconds and counts whole views. Two views of the window, drawn from the
seed, are kept; at a seeded sample of their surface pixels every output
is held against the reference.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import nullcontext

import numpy as np
import torch

from benchmark import harness, trace
from benchmark.reference import stage2 as ref
from benchmark.reference.common import precision
from benchmark.scene import synthetic
from benchmark.traffic.train_stage2 import build

OUTPUTS = ("rgb", "albedo", "rough", "visibility", "normal_pred")


def setup(run):
    runner, net, w0, scene, export = build(run)
    data = runner._eval_data("test")
    n_views = len(data["views"])
    lights = [runner.trained_lights_for_view(data, v)
              for v in range(n_views)]
    rng = np.random.default_rng(run.seed)
    picks = set(rng.choice(run.params["pick_from"], 2, replace=False)
                .tolist())
    # Every test view once, holding as many results at a time as the
    # window does (the kept views and the one being rendered): each result
    # owns a page-locked block, and a block the host allocator has not
    # cached yet costs a cudaHostAlloc of a full frame (0.2-1 s).
    held = [runner.render_view(data, i % n_views, *lights[i % n_views])
            for i in range(max(n_views, len(picks) + 1))]
    del held
    surf = [np.flatnonzero(data["surface_mask"][v].cpu().numpy())
            for v in range(len(data["views"]))]
    sample = [np.sort(rng.choice(s, min(len(s), run.params["pixels"]),
                                 replace=False)) for s in surf]
    run.work.update(n_surface=[len(s) for s in surf],
                    n_lights=[len(d) for d, _ in lights],
                    n_pixels=int(data["surface_mask"].shape[1]))
    return {"runner": runner, "data": data, "lights": lights, "picks": picks,
            "sample": sample, "net": net, "w0": w0, "scene": scene,
            "export": export, "kept": {}, "views": []}


def _span_frames(run):
    """In the traced run, time the frame renderer render_view calls (with
    a sync after it), so the rest of render_view is the host's assembly."""
    import psnerf_torch.runners.stage2 as rs

    orig = getattr(rs, "render_frame_stage2", None)
    if orig is None:
        return lambda: None

    def frame(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        run.sync()
        run.span("frame", time.perf_counter() - t0)
        return out

    rs.render_frame_stage2 = frame
    return lambda: setattr(rs, "render_frame_stage2", orig)


def window(run, state):
    """Views for --seconds. Untraced, a profiler of the device alone reads
    the card's kernel time per view (eval_view_kernel_ms); the traced run
    has the full trace instead, and its spans."""
    runner, data, lights = state["runner"], state["data"], state["lights"]
    n_views = len(lights)
    restore = _span_frames(run) if run.trace else (lambda: None)
    cuda = run.device != "cpu"
    prof = nullcontext() if run.trace else trace.device_only(cuda)

    def one():
        i = len(state["views"])
        v = i % n_views
        t0 = time.perf_counter()
        r = runner.render_view(data, v, *lights[v])
        if run.trace:
            run.span("render_view", time.perf_counter() - t0)
        if i in state["picks"]:
            state["kept"][i] = (v, r)
        state["views"].append(v)
        return 1

    try:
        with prof:
            w = harness.timed_loop(run, one, run.seconds)
    finally:
        restore()
    run.work["views"] = list(state["views"])
    metrics = {}
    if not run.trace:
        metrics["eval_view_kernel_ms"] = \
            1e3 * trace.kernel_busy_seconds(prof, cuda) / w["units"]
    return {"attempted": w["units"], "failed": 0, "elapsed": w["elapsed"],
            "metrics": metrics}


def collect(run, state):
    """The kept views' outputs at the sampled pixels, as tensors."""
    dev = torch.device(run.device)
    h, w = state["data"]["img_res"]
    kept = []
    for i, (v, r) in sorted(state["kept"].items()):
        idx = state["sample"][v]
        got = {}
        for k in OUTPUTS:
            a = r[k]
            a = a.reshape(a.shape[0], h * w, -1)[:, idx] if a.ndim == 4 \
                else a.reshape(h * w, -1)[idx]
            got[k] = torch.as_tensor(np.ascontiguousarray(a), device=dev)
        kept.append((v, got))
    return {"kept": kept, "sample": state["sample"], "net": state["net"],
            "w0": state["w0"], "scene": state["scene"],
            "export": state["export"], "lights": state["lights"]}


def reference(run, out, control=False):
    """The reference's outputs of every kept view at the sampled pixels."""
    dev = torch.device(run.device)
    with open(os.path.join(out["scene"], "params.json")) as f:
        params = json.load(f)
    views = params["view_test"]
    d = ref.load_views(out["scene"], out["export"], views, dev, images=False)
    lw = synthetic.world_lights(params)
    w = params["imhw"][1]
    res = {}
    for v in {v for v, _ in out["kept"]}:
        idx = torch.as_tensor(out["sample"][v], device=dev)
        uv = torch.stack([idx % w, idx // w], -1).float()
        n_l = len(out["lights"][v][0])
        dirs = torch.as_tensor(lw[views[v]][:n_l], device=dev)
        ints = torch.full((n_l,), out["net"].light_int, device=dev)
        with precision(control):
            res[v] = ref.render_eval(out["w0"], out["net"],
                                     d["points"][v][idx],
                                     d["normals"][v][idx], uv,
                                     d["poses_cv"][v], d["K"], dirs, ints)
    return res


def readings(run, out, variant="program") -> dict:
    want = reference(run, out)
    got = {v: g for v, g in out["kept"]} if variant == "program" else \
        reference(run, out, control=True)
    errs = {f"{k}_err": 0.0 for k in OUTPUTS}
    for v, g in (out["kept"] if variant == "program" else got.items()):
        for k in OUTPUTS:
            e = float(torch.max(torch.abs(
                g[k].reshape(want[v][k].shape) - want[v][k])))
            errs[f"{k}_err"] = max(errs[f"{k}_err"], e)
    errs["views_compared"] = float(len(out["kept"]))
    return errs


def check(run, out):
    r = readings(run, out)
    if not r.pop("views_compared"):
        return [("views_compared", float("nan"), 0.0)]
    return [(k, v, run.limits[k]) for k, v in r.items()]
