"""Stage-1 training as a user runs it: `Stage1Runner.train` on a scene and
weights made from the seed, resumed from a checkpoint at `resume_it`
(past outside_after and normal_after, so every step is the late step).

Set-up builds the runner, drives its own loop through the first
`first_steps` steps (recording the draws its sampler made and each
step's loss), then `warm_steps` more. The window continues the same loop
for --seconds (the runner's wall budget) and reports the window over the
steps completed. The reference follows the first steps from the same
weights and the recorded draws, gathering every batch again from the
scene's own files.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import compare
from benchmark.reference import stage1 as ref
from benchmark.reference.common import ADAM_B1, precision
from benchmark.scene import synthetic

# faults the calibration reads beside the control: half of each batch
# left out, the mean taken over the rest
FAULTS = ("half",)


def write_checkpoint(path: str, params: dict, it: int):
    """A checkpoint in the program's npz layout: params/<leaf>, Adam's
    state opt/{m,v,step}/<leaf> from zero, and the iteration."""
    flat = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        flat[f"params/{k}"] = a
        flat[f"opt/m/{k}"] = np.zeros_like(a)
        flat[f"opt/v/{k}"] = np.zeros_like(a)
        flat[f"opt/step/{k}"] = np.zeros((), np.int32)
    flat["__scalars__"] = np.frombuffer(json.dumps({"it": it}).encode(),
                                        np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat)


def camera(params) -> list:
    """The first camera's position: the export's and the batches' view."""
    return [row[3] for row in params["pose_c2w"][0][:3]]


def field_leaves(field) -> dict:
    return {k.replace(".", "/"): p for k, p in field.named_parameters()}


def spy(runner, n: int, record):
    """Record the first n draws of the runner's sampler (record(batch,
    noise, *args) -> what to keep) and the loss of each step its step
    function returns; returns the two lists."""
    draws, losses = [], []
    sample, step = runner.sample, runner.step_fn

    def sample_spy(*args):
        batch, noise = sample(*args)
        if len(draws) < n:
            draws.append(record(batch, noise, *args))
        return batch, noise

    def step_spy(*a, **kw):
        terms = step(*a, **kw)
        if len(losses) < n:
            losses.append(terms["loss"].detach().clone())
        return terms

    runner.sample, runner.step_fn = sample_spy, step_spy
    return draws, losses


def record(batch, noise, use_outside):
    return {"pixels": batch["pixels"].clone(),
            "world_mat": batch["world_mat"].clone(),
            "noise": {k: v.clone() for k, v in noise.items()},
            "use_outside": use_outside}


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
    if runner.it != p["resume_it"]:
        raise RuntimeError(f"the runner resumed at {runner.it}, not "
                           f"{p['resume_it']}")
    n = p["first_steps"]
    draws, losses = spy(runner, n, record)
    runner.train(runner.it + 1)
    g1 = {k: runner.opt_state["m"][k].detach().clone() / (1 - ADAM_B1)
          for k in field_leaves(runner.field)}
    runner.train(p["resume_it"] + n)
    w_n = {k: v.detach().clone() for k, v in field_leaves(runner.field)
           .items()}
    runner.train(runner.it + p["warm_steps"])
    run.work.update(mask_share=info["mask_share"])
    return {"runner": runner, "w0": w0, "fld": fld, "scene": scene,
            "draws": draws, "losses": losses, "g1": g1, "w_n": w_n,
            "n_views": runner.n_views}


def window(run, state):
    runner = state["runner"]
    it0 = runner.it
    run.sync()
    t0 = time.perf_counter()
    runner.train(10 ** 9, wall_budget_s=run.seconds)
    run.sync()
    elapsed = time.perf_counter() - t0
    steps = runner.it - it0
    return {"attempted": steps, "failed": 0, "elapsed": elapsed,
            "metrics": {"stage1_step_ms": elapsed * 1e3 / steps}}


def collect(run, state):
    return {k: v for k, v in state.items() if k != "runner"}


def reference(run, out, control=False, half=False):
    """The reference's first steps (or the control's; or with half of
    each batch left out)."""
    dev = torch.device(run.device)
    data = ref.load_scene(out["scene"], dev)
    draws = []
    for d in out["draws"]:
        view = int(torch.argmin(torch.sum(
            (data["poses"] - d["world_mat"][None]) ** 2, dim=(1, 2))))
        keep = slice(None) if not half else slice(0, d["pixels"].shape[0] // 2)
        noise = {k: (v if v.ndim == 0 else v[keep])
                 for k, v in d["noise"].items()}
        draws.append({"view": view, "pixels": d["pixels"][keep],
                      "noise": noise, "use_outside": d["use_outside"]})
    with precision(control):
        return ref.train_steps(out["w0"], out["fld"], run.cfg, data, draws,
                               run.params["resume_it"], out["n_views"])


def readings(run, out, variant="program") -> dict:
    """The compared numbers of the program (or, as the program's stand-in,
    the control: "control"; the half-batch fault: "half") against the
    reference."""
    losses_r, g_r, w_r = reference(run, out)
    if variant == "program":
        losses_p = [float(x) for x in out["losses"]]
        g_p, w_p = out["g1"], out["w_n"]
    else:
        losses_p, g_p, w_p = reference(run, out, control=variant == "control",
                                       half=variant == "half")
    return compare.training(losses_p, losses_r, g_p, g_r, out["w0"], w_p,
                            w_r)


def check(run, out):
    r = readings(run, out)
    return [(k, r[k], limit) for k, limit in run.limits.items()]
