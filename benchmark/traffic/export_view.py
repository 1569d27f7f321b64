"""The stage-1 shape export as the command line's `shape-extract
--visibility --vis_plus` runs it: `Stage1Runner.shape_extract` at the
faithful protocol (512 march steps; the train lights and vis_plus_num
farthest-point-sampled directions at 128 steps each), writing every view's
points, normals, mask and visibility npys.

Set-up builds the scene and the field's weights from the seed, resumes
the runner from a checkpoint of them and exports once without visibility
(the march and the normals warm). The window exports the scene's views
again and again for --seconds and counts whole views, the same views in
the same order every call. The last call's npys are held against the
reference at pixels drawn from the seed: the march's mask, points and
normals over the frame, and the visibility of a sample of surface pixels
toward every direction the program exported.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import stage1 as ref
from benchmark.reference.common import precision
from benchmark.scene import synthetic
from benchmark.traffic.train_stage1 import camera, write_checkpoint


def setup(run):
    from psnerf_torch.config import stage1_config_from_yaml
    from psnerf_torch.runners.stage1 import Stage1Runner

    dev = torch.device(run.device)
    p = run.params
    scene = os.path.join(run.dir, "scene")
    info = synthetic.generate(scene, harness.scene_spec(run.cfg), run.seed,
                              dev, light_images=False)
    fld = ref.Field(run.cfg["model"])
    w0 = ref.init_weights(fld, run.seed, dev, view=camera(info))
    wd = os.path.join(run.dir, "run")
    write_checkpoint(os.path.join(wd, "checkpoints", "model.npz"), w0,
                     p["resume_it"])
    yaml = harness.stage1_yaml(run.cfg, run.path("stage1.yaml"), scene, wd)
    runner = Stage1Runner(stage1_config_from_yaml(yaml), wd, seed=run.seed,
                          device=run.device, **run.runner_kw)
    runner.shape_extract(os.path.join(run.dir, "warm"), visibility=False)
    with open(os.path.join(scene, "params.json")) as f:
        params = json.load(f)
    run.work.update(mask_share=info["mask_share"],
                    n_views=params["n_view"],
                    n_pixels=params["imhw"][0] * params["imhw"][1])
    return {"runner": runner, "w0": w0, "fld": fld, "scene": scene,
            "out": os.path.join(run.dir, "shape_out"), "params": params}


def window(run, state):
    runner, p = state["runner"], run.params

    def one():
        runner.shape_extract(state["out"], visibility=True, vis_plus=True,
                             vis_plus_num=p["vis_plus_num"])
        return state["params"]["n_view"]

    w = harness.timed_loop(run, one, run.seconds)
    return {"attempted": w["units"], "failed": 0, "elapsed": w["elapsed"],
            "metrics": {"export_view_s": w["elapsed"] / w["units"]}}


def collect(run, state):
    """The last call's npys at the sampled pixels, as tensors."""
    dev = torch.device(run.device)
    out, params = state["out"], state["params"]
    rng = np.random.default_rng(run.seed)
    h, w = params["imhw"]
    with open(os.path.join(out, "vis_plus", "light_dir.json")) as f:
        vp = json.load(f)
    views, n_surface = [], []
    for v in range(params["n_view"]):
        name = f"view_{v + 1:02d}"
        ld = lambda sub: np.load(os.path.join(out, sub, name + ".npy"))
        mask = ld("mask").reshape(-1)
        n_surface.append(int(mask.sum()))
        idx = np.sort(rng.choice(h * w, run.params["pixels"], replace=False))
        on = idx[mask[idx]]
        vidx = np.sort(rng.choice(on, min(len(on), run.params[
            "vis_pixels"]), replace=False))
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        vis = ld("visibility").reshape(-1, h * w)[:, vidx]
        vplus = ld("vis_plus").reshape(-1, h * w)[:, vidx]
        views.append({
            "idx": t(idx), "vidx": t(vidx), "mask": t(mask[idx]),
            "points": t(ld("points").reshape(-1, 3)[idx]),
            "normal": t(ld("normal").reshape(-1, 3)[idx]),
            "visibility": t(vis), "vis_plus": t(vplus),
            "vp_dirs": t(np.asarray(vp[name], np.float32))})
    run.work["n_surface"] = n_surface
    return {"views": views, "w0": state["w0"], "fld": state["fld"],
            "scene": state["scene"], "params": params}


def reference(run, out, control=False):
    dev = torch.device(run.device)
    params = out["params"]
    w = params["imhw"][1]
    K = torch.as_tensor(np.asarray(params["K"], np.float32), device=dev)
    poses = np.asarray(params["pose_c2w"], np.float32)
    poses[:, :3, 1:3] *= -1.0
    lw = synthetic.world_lights(params)
    res = []
    with precision(control):
        for v, got in enumerate(out["views"]):
            pose = torch.as_tensor(poses[v], device=dev)
            pix = lambda i: torch.stack([i % w, i // w], -1).float()
            pts, nrm, msk = ref.shape_extract(
                out["w0"], out["fld"], run.cfg["rendering"], pix(got["idx"]),
                K, pose, run.params["march_steps"])
            vp, vn, vm = ref.shape_extract(
                out["w0"], out["fld"], run.cfg["rendering"],
                pix(got["vidx"]), K, pose, run.params["march_steps"])
            dirs = torch.as_tensor(lw[v], device=dev)
            steps = run.params["vis_steps"]
            res.append({
                "mask": msk, "points": pts, "normal": nrm, "vmask": vm,
                "visibility": ref.light_visibility(out["w0"], out["fld"], vp,
                                                   dirs, steps),
                "vis_plus": ref.light_visibility(out["w0"], out["fld"], vp,
                                                 got["vp_dirs"], steps)})
    return res


def readings(run, out, variant="program") -> dict:
    want = reference(run, out)
    gots = out["views"] if variant == "program" else \
        reference(run, out, control=True)
    r = {}
    for got, ref_ in zip(gots, want):
        both = got["mask"].bool() & ref_["mask"]
        r["mask_mismatch"] = max(r.get("mask_mismatch", 0.0), float(
            (got["mask"].bool() != ref_["mask"]).float().mean()))
        errs = {k: torch.abs(got[k] - ref_[k])[both]
                for k in ("points", "normal")}
        errs.update({k: torch.abs(got[k] - ref_[k])[:, ref_["vmask"]]
                     for k in ("visibility", "vis_plus")})
        for k, e in errs.items():
            for stat, fn in (("err", torch.max), ("mean_err", torch.mean)):
                v = float(fn(e)) if e.numel() else 0.0
                r[f"{k}_{stat}"] = max(r.get(f"{k}_{stat}", 0.0), v)
    return r


def check(run, out):
    r = readings(run, out)
    return [(k, r[k], limit) for k, limit in run.limits.items()]
