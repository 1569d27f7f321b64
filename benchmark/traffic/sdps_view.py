"""SDPS-Net on one view at a time, as the program's preprocessing runs it:
`psnerf_torch.preprocess.runner.sdps_view` (LCNet for the lights, NENet for
the normals at the mask crop) on each view's light images, every output
read back to the host.

Set-up generates the scene (its light images and norm_mask), draws the
LCNet and NENet weights from the seed, writes them as the converted npz
files the command line loads and loads them with `load_sdps_net`, reads
each view's images once with `read_view` and runs every view once. The
window runs views 0, 1, 0, 1, ... back to back for --seconds and counts
whole views, every view once a pass; no PNG is read and no npy is written
inside it (run_sdps's disk legs are host I/O). Two views of the window,
drawn from the seed, are kept with LCNet's logits; the reference runs on
the same images: LCNet's logits and classes (away from near-ties), the
lights read back (each light's direction and intensity against the
published codec on the reference's classes, where those are clear of
near-ties), and NENet's normals (away from near-degenerate ones) from the
program's lights.
"""

from __future__ import annotations

import os
from contextlib import nullcontext

import numpy as np
import torch

from benchmark import harness, trace
from benchmark.reference import sdps as ref
from benchmark.reference.common import precision
from benchmark.scene import synthetic

HEADS = ("dir_x", "dir_y", "ints")


def write_npz(path: str, flat: dict) -> str:
    np.savez(path, **{k: v.numpy() for k, v in flat.items()})
    return path


def setup(run):
    from psnerf_torch.preprocess.runner import read_view, sdps_view
    from psnerf_torch.preprocess.sdps import load_sdps_net

    dev = torch.device(run.device)
    cfg = run.cfg
    scene = os.path.join(run.dir, "scene")
    spec = dict(cfg["dataset_shape"], n_views_train=cfg["n_views"],
                n_views_test=0)
    synthetic.generate(scene, spec, run.seed, dev, light_images=True)
    weights = ref.init_weights(cfg, run.seed)
    nets = {k: load_sdps_net(write_npz(run.path(f"{k}.npz"), weights[k]),
                             k, run.device) for k in ("lcnet", "nenet")}
    for net in nets.values():
        net.eval()
    spy = {}
    # the logits of the latest LCNet call, left on the device
    nets["lcnet"].register_forward_hook(
        lambda m, a, out: spy.update(last={h: out[k] for h, k in zip(
            HEADS, ("dirs_x", "dirs_y", "ints"))}))
    img_root = f"img_intnorm_sdps_l{cfg['dataset_shape']['n_lights']}"
    views = [read_view(scene, f"view_{v + 1:02d}", img_root)
             for v in range(cfg["n_views"])]
    test_hw = tuple(cfg["lcnet"]["test_hw"])
    for imgs, mask in views:
        sdps_view(nets["lcnet"], nets["nenet"], imgs, mask, test_hw)
    rng = np.random.default_rng(run.seed)
    picks = set(rng.choice(run.params["pick_from"], 2, replace=False)
                .tolist())
    run.work.update(n_lights=int(views[0][0].shape[0]),
                    test_hw=list(test_hw))
    return {"sdps_view": sdps_view, "nets": nets, "spy": spy,
            "views": views, "weights": weights, "picks": picks,
            "test_hw": test_hw, "kept": {}, "order": []}


def window(run, state):
    """Views for --seconds. Untraced, a profiler of the device alone reads
    the card's kernel time per view (eval_view_kernel_ms)."""
    sdps_view, nets, views = state["sdps_view"], state["nets"], state["views"]
    cuda = run.device != "cpu"
    prof = nullcontext() if run.trace else trace.device_only(cuda)

    def one():
        # every view once, so that each view's share of the window is the
        # same whatever the host's speed
        for v, (imgs, mask) in enumerate(views):
            i = len(state["order"])
            r = sdps_view(nets["lcnet"], nets["nenet"], imgs, mask,
                          state["test_hw"])
            if i in state["picks"]:
                state["kept"][i] = (v, r, state["spy"]["last"])
            state["order"].append(v)
        return len(views)

    with prof:
        w = harness.timed_loop(run, one, run.seconds)
    run.work["views"] = list(state["order"])
    metrics = {}
    if not run.trace:
        metrics["eval_view_kernel_ms"] = \
            1e3 * trace.kernel_busy_seconds(prof, cuda) / w["units"]
    return {"attempted": w["units"], "failed": 0, "elapsed": w["elapsed"],
            "metrics": metrics}


def collect(run, state):
    kept = [(v, r, {h: x.detach().cpu() for h, x in logits.items()})
            for _, (v, r, logits) in sorted(state["kept"].items())]
    return {"kept": kept, "views": state["views"],
            "weights": state["weights"]}


def reference(run, out, v, r, control=False):
    """The reference on view v's images, NENet from the program's lights
    (r, its sdps_view result)."""
    dev = torch.device(run.device)
    imgs, mask = out["views"][v]
    weights = {k: {n: t.to(dev) for n, t in d.items()}
               for k, d in out["weights"].items()}
    with precision(control), torch.no_grad():
        return ref.view(weights, run.cfg, imgs, mask, r["dirs"], r["intens"],
                        dev)


def compare(logits, dirs, intens, normal, want, cfg, tie, short) -> dict:
    """The numbers of one view: logits [L, classes] per head, the lights
    (dirs [L, 3], intens [L]) and the normals on the crop [h, w, 3],
    against the reference's. Classes are compared away from near-ties (the
    reference's top two within `tie` of the head's largest logit), and so
    are the lights: a direction where both its heads are clear, an
    intensity where its head is, against the published codec on the
    reference's classes. Normals are compared away from near-degenerate
    pixels (a raw normal shorter than `short` of the median on the mask,
    where normalising amplifies float32's rounding without bound)."""
    rel, flips, ties, clear = 0.0, 0, 0, {}
    for h in HEADS:
        w = want["logits"][h].double().cpu()
        g = logits[h].double().cpu()
        scale = float(w.abs().max())
        rel = max(rel, float((g - w).abs().max()) / scale)
        top2 = torch.topk(w, 2, dim=1).values
        clear[h] = (top2[:, 0] - top2[:, 1]) > tie * scale
        ties += int((~clear[h]).sum())
        flips += int((clear[h] & (g.argmax(1) != w.argmax(1))).sum())
    want_dirs, want_intens = ref.lights(
        {h: x.cpu() for h, x in want["logits"].items()}, cfg)
    dir_gap = (torch.as_tensor(dirs).double() - want_dirs).abs().amax(1)
    int_gap = (torch.as_tensor(intens).double() - want_intens).abs()
    dir_gap = dir_gap[clear["dir_x"] & clear["dir_y"]]
    int_gap = int_gap[clear["ints"]]
    m = (want["mask"] > 0.5).cpu()
    length = want["length"].cpu()
    keep = m & (length >= short * length[m].median())
    err = (torch.as_tensor(normal).double() -
           want["normal"].double().cpu()).abs()[keep]
    return {"lcnet_logit_rel": rel, "class_mismatch": float(flips),
            "light_dir_err": float(dir_gap.max()) if len(dir_gap) else 0.0,
            "light_int_err": float(int_gap.max()) if len(int_gap) else 0.0,
            "normal_err": float(err.max()), "normal_mean_err":
            float(err.mean()), "near_ties": ties,
            "short_normals": int((m & ~keep).sum())}


def readings(run, out, variant="program") -> dict:
    tie, short = run.params["near_tie"], run.params["short_normal"]
    res = {"lcnet_logit_rel": 0.0, "class_mismatch": 0.0,
           "light_dir_err": 0.0, "light_int_err": 0.0, "normal_err": 0.0,
           "normal_mean_err": 0.0}
    ties = shorts = 0
    for v, r, logits in out["kept"]:
        want = reference(run, out, v, r)
        if variant == "program":
            t, l, b = r["crop"][0], r["crop"][1], want["box"]
            h, w = b[2] - b[0], b[3] - b[1]
            normal = np.zeros(tuple(want["normal"].shape), np.float32)
            normal[:h, :w] = r["normal"][t:t + h, l:l + w]
            got = compare(logits, r["dirs"], r["intens"], normal, want,
                          run.cfg, tie, short)
            if tuple(int(x) for x in r["crop"]) != want["box"]:
                got["normal_err"] = float("inf")
        else:
            low = reference(run, out, v, r, control=True)
            dirs, intens = ref.lights(
                {h: x.cpu() for h, x in low["logits"].items()}, run.cfg)
            got = compare(low["logits"], dirs, intens, low["normal"].cpu(),
                          want, run.cfg, tie, short)
        for k in res:
            res[k] = max(res[k], got[k])
        ties += got["near_ties"]
        shorts += got["short_normals"]
    res["views_compared"] = float(len(out["kept"]))
    res["near_ties"], res["short_normals"] = ties, shorts
    return res


def check(run, out):
    r = readings(run, out)
    if not r.pop("views_compared"):
        return [("views_compared", float("nan"), 0.0)]
    return [(k, r[k], limit) for k, limit in run.limits.items()]
