"""Stage-2 training as the command line runs it: `Stage2Runner.train` with
the configuration's checkpoint cadence, on a scene, its analytic stage-1
shape export and PSNet weights made from the seed, resumed from a
checkpoint at `resume_it` (past the warm-up).

Set-up drives the runner's own loop through the first `first_steps` steps
(recording the sampler's draws and each step's loss) and `warm_steps`
more; the window continues the loop for --seconds (the runner's wall
budget), and at the latest up to the next multiple of plot_freq, where it
stops before the plot: every window holds the same kind of step and one
checkpoint, the wall budget's or the last step's, at its end. Set-up plots
nothing, since the window never does. The reference follows the first
steps from the same weights and the recorded draws, gathering every batch
again from the scene's files.

The window records the process's device memory peak at its close in
run.work["peak_mem_gb"].
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import compare
from benchmark.reference import stage2 as ref
from benchmark.reference.common import ADAM_B1, precision
from benchmark.scene import synthetic
from benchmark.traffic.train_stage1 import spy

# faults the calibration reads beside the control: half of each batch
# left out, the mean taken over the rest. Every other pixel goes: the
# sampler puts the object's pixels first, and at every pixel of a view the
# first half holds all of them, which leaves the masked means unchanged.
FAULTS = ("half",)


def make_weights(run, dev, scene, export):
    """The PSNet's weights from the seed, the visibility output lifted on
    the first train view, and the light tables as the runner initialises
    them from the SDPS predictions (the same for every train view here)."""
    net = ref.Net(run.cfg)
    w = ref.init_weights(net, run.seed, dev)
    with open(os.path.join(scene, "params.json")) as f:
        params = json.load(f)
    views = params["view_train"]
    lw = synthetic.world_lights(params)
    pts = np.load(os.path.join(export, "points",
                               f"view_{views[0] + 1:02d}.npy"))
    msk = np.load(os.path.join(export, "mask",
                               f"view_{views[0] + 1:02d}.npy"))
    shift = ref.lift_visibility(
        w, net, torch.as_tensor(pts[msk], device=dev),
        torch.as_tensor(lw[views[0]], device=dev))
    dirs = np.concatenate([lw[v] for v in views]).astype(np.float32)
    w["light_dirs"] = torch.as_tensor(dirs, device=dev)
    w["light_ints"] = torch.full((len(dirs), 1), net.light_int,
                                 device=dev)
    return net, w, shift


def write_checkpoint(path, w, it):
    flat = {}
    for k, v in w.items():
        a = v.detach().cpu().numpy()
        if k.startswith("light_"):
            flat[f"params/{k}"] = a
            for s in ("m", "v"):
                flat[f"opt/{k}/{s}"] = np.zeros_like(a)
            flat[f"opt/{k}/step"] = np.zeros((), np.int32)
        else:
            flat[f"params/model/{k}"] = a
            for s in ("m", "v"):
                flat[f"opt/model/{s}/{k}"] = np.zeros_like(a)
            flat[f"opt/model/step/{k}"] = np.zeros((), np.int32)
    flat["__scalars__"] = np.frombuffer(json.dumps({"it": it}).encode(),
                                        np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat)


def record(batch, noise):
    keep = ("pix", "lidx", "pose", "light_vis_train")
    return {"batch": {k: batch[k].clone() for k in keep},
            "noise": {k: v.clone() for k, v in noise.items()}}


def leaves(runner) -> dict:
    out = {k.replace(".", "/"): p
           for k, p in runner.params["model"].named_parameters()}
    out.update(light_dirs=runner.params["light_dirs"],
               light_ints=runner.params["light_ints"])
    return out


def first_moments(runner) -> dict:
    st = runner.opt_state
    out = dict(st["model"]["m"])
    out.update(light_dirs=st["light_dirs"]["m"],
               light_ints=st["light_ints"]["m"])
    return {k: v.detach().clone() / (1 - ADAM_B1) for k, v in out.items()}


def build(run, light_images=True):
    """Scene, export, weights, checkpoint and the runner, resumed."""
    from psnerf_torch.config import stage2_config_from_conf
    from psnerf_torch.runners.stage2 import Stage2Runner

    dev = torch.device(run.device)
    scene = os.path.join(run.dir, "scene")
    export = os.path.join(run.dir, "export")
    spec = dict(harness.scene_spec(run.cfg))
    n_vp = spec.pop("n_vis_plus")
    info = synthetic.generate(scene, spec, run.seed, dev,
                              light_images=light_images, export_dir=export,
                              n_vis_plus=n_vp)
    net, w0, shift = make_weights(run, dev, scene, export)
    wd = os.path.join(run.dir, "run")
    write_checkpoint(os.path.join(wd, "checkpoints", "model.npz"), w0,
                     run.params["resume_it"])
    conf = harness.stage2_conf(run.cfg, run.path("stage2.conf"), scene,
                               export)
    runner = Stage2Runner(stage2_config_from_conf(conf), wd, seed=run.seed,
                          device=run.device, **run.runner_kw)
    if runner.it != run.params["resume_it"]:
        raise RuntimeError(f"the runner resumed at {runner.it}")
    run.work.update(mask_share=info["mask_share"], vis_bias_shift=shift)
    return runner, net, w0, scene, export


def setup(run):
    runner, net, w0, scene, export = build(run)
    p = run.params
    n = p["first_steps"]
    draws, losses = spy(runner, n, record)
    runner.train(runner.it + 1)
    g1 = first_moments(runner)
    runner.train(p["resume_it"] + n)
    w_n = {k: v.detach().clone() for k, v in leaves(runner).items()}
    runner.train(runner.it + p["warm_steps"])
    run.work.update(num_pixels=runner.num_pixels, light_bs=runner.light_bs,
                    vis_train_num=runner.cfg.vis_train_num)
    return {"runner": runner, "net": net, "w0": w0, "scene": scene,
            "export": export, "draws": draws, "losses": losses, "g1": g1,
            "w_n": w_n, "n_views": runner.n_views,
            "light_bs": runner.light_bs}


def window(run, state):
    runner = state["runner"]
    it0 = runner.it
    plot_freq = runner.cfg.plot_freq
    run.sync()
    t0 = time.perf_counter()
    runner.train((it0 // plot_freq + 1) * plot_freq, plot_every=plot_freq,
                 wall_budget_s=run.seconds)
    run.sync()
    elapsed = time.perf_counter() - t0
    if run.device != "cpu":
        run.work["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    steps = runner.it - it0
    return {"attempted": steps, "failed": 0, "elapsed": elapsed,
            "metrics": {"stage2_step_ms": elapsed * 1e3 / steps}}


def collect(run, state):
    return {k: v for k, v in state.items() if k != "runner"}


def gather(data, lw_init, vp_dirs, d, keep):
    """A batch gathered again from the scene's own arrays at the program's
    draws: its pixels, lights and vis_plus rows (matched to the pool of the
    view's vis_plus directions and its initial light directions)."""
    b = d["batch"]
    view = int(torch.argmin(torch.sum(
        (data["poses_cv"] - b["pose"][None]) ** 2, dim=(1, 2))))
    pix, lidx = b["pix"][keep], b["lidx"]
    w = data["params"]["imhw"][1]
    om = data["object_mask"][view][pix]
    rgb = data["imgs"][view][lidx][:, pix].float() / 255.0 * \
        om[None, :, None].float()
    pool = torch.cat([vp_dirs[view], lw_init[view]])
    sidx = torch.argmin(torch.cdist(b["light_vis_train"], pool), dim=1)
    n_vp = vp_dirs.shape[1]
    vis_src = torch.cat([data["vis_plus"][view], data["visibility"][view]])
    return {"uv": torch.stack([pix % w, pix // w], -1).float(),
            "pose": data["poses_cv"][view], "K": data["K"],
            "object_mask": om, "points": data["points"][view][pix],
            "normal": data["normals"][view][pix],
            "surface_mask": data["surface_mask"][view][pix],
            "rgb_gt": rgb, "l_slt": data["row0"][view] + lidx,
            "light_vis_train": pool[sidx],
            "vis_train_gt": vis_src[sidx][:, pix], "_n_vp": n_vp}


def reference(run, out, control=False, half=False):
    dev = torch.device(run.device)
    with open(os.path.join(out["scene"], "params.json")) as f:
        params = json.load(f)
    views = params["view_train"]
    data = ref.load_views(out["scene"], out["export"], views, dev)
    lw = synthetic.world_lights(params)[views]
    lw_init = torch.as_tensor(lw / np.linalg.norm(lw, axis=-1,
                                                  keepdims=True), device=dev)
    with open(os.path.join(out["export"], "vis_plus", "light_dir.json")) as f:
        vpj = json.load(f)
    vp_dirs = torch.as_tensor(np.asarray(
        [vpj[f"view_{v + 1:02d}"] for v in views], np.float32), device=dev)
    load = lambda sub: torch.as_tensor(np.stack([np.load(os.path.join(
        out["export"], sub, f"view_{v + 1:02d}.npy")) for v in views]),
        device=dev)
    data["vis_plus"], data["visibility"] = load("vis_plus"), load(
        "visibility")
    n_l = lw.shape[1]
    data["row0"] = [i * n_l for i in range(len(views))]
    batches, noises = [], []
    for d in out["draws"]:
        n = d["batch"]["pix"].shape[0]
        keep = slice(None) if not half else slice(0, n, 2)
        batches.append(gather(data, lw_init, vp_dirs, d, keep))
        noises.append({k: v[keep] for k, v in d["noise"].items()})
    with precision(control):
        return ref.train_steps(out["w0"], out["net"], run.cfg, batches,
                               noises, run.params["resume_it"],
                               out["n_views"], out["light_bs"])


def readings(run, out, variant="program") -> dict:
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
