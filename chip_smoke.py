#!/usr/bin/env python3
"""Smoke run of psnerf_torch on one CUDA card: the quickest proof that the
port builds, is right and runs its main path on the GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card: name, count, and nvidia-smi's name and power limit;
  2. build: nvcc builds every CUDA source of psnerf_torch/ops/csrc;
  3. kernels: fused_visibility and fused_vis_shade (layouts lnc and cnl, and
     the light sum) at the main path's widths (N = 65,536 pixels, L = 96,
     the 8x256 visibility net), each held against its plain PyTorch version
     and timed with CUDA events in turns (plain, kernel, kernel, plain),
     beside a chain of bf16 torch.matmul calls over the same trunk (a
     yardstick only; the port never calls it) and the least time the card
     could take (tensor-core FLOPs over 989 TFLOP/s; input and output bytes
     over 3.35 TB/s are far less);
  4. main path: a 512x512 synthetic scene under 96 lights (2 train views, 1
     test view) with its analytic stage-1 export; a full-width PSNet made
     from a seed, checkpointed, resumed by a fresh Stage2Runner, which runs
     evaluate(split="test") and render_view for the rgb and rgb_sum routes,
     with the kernels' launch counts set to 0 just before and read just
     after; the kernel route is held against the plain route of the view;
  5. one JSON line of kernels, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It needs no network and writes only inside the checkout (a work directory
that it removes at the end, and the kernel build under psnerf_torch/ops).
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_chip_smoke_work")
SEED = 0
DEV = "cuda"
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
N_KERNEL, L_KERNEL = 65536, 96
HW, N_LIGHTS = (512, 512), 96
RAW_REL, RAW_CORR = 0.05, 0.999   # raw vis bars (tests/test_fused_vis.py)
RGB_MAX, RGB_MEAN = 2e-2, 2e-3    # rgb bars (tests/test_fused_vis.py)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """A failed check ends the run (not an assert: -O does not skip it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps):
    """Mean ms of `reps` back-to-back calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns: dict, reps: dict, order):
    """Time each named fn in the given order (e.g. plain, kernel, kernel,
    plain); returns {name: mean ms over its turns}."""
    for fn in fns.values():       # warm-up
        fn()
    torch.cuda.synchronize()
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(cuda_ms(fns[k], reps[k]))
    return {k: float(np.mean(v)) for k, v in got.items()}


def trunk_flops(n, n_lights, ke, width=256, n_trunk=7):
    """Tensor-core FLOPs of the visibility trunk: per (light, pixel) seven
    W x W products and the W-wide output dot; per pixel the two point
    halves (em @ W0x, em @ W5x) at the kernel's K, the embedding width
    padded to a multiple of 16 (64 for the 63-wide embedding)."""
    return (n * n_lights * (n_trunk * 2 * width * width + 2 * width)
            + n * 2 * 2 * ke * width)


def bound_ms(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


@torch.no_grad()
def library_trunk(ops):
    """The same trunk as a chain of bf16 torch.matmul calls (cuBLAS), the
    yardstick of library_ms; raw visibility [L, N]."""
    bf = torch.bfloat16
    em = ops["em"]
    a0 = torch.matmul(em, ops["w0xT"].T).float()
    b5 = torch.matmul(em, ops["w5xT"].T).float()
    n, n_l, w = ops["n"], ops["n_lights"], ops["width"]
    y = torch.relu(a0[None] + ops["r0"][:, None]).to(bf).reshape(n_l * n, w)
    for i, wt in enumerate(ops["trunk_wT"]):
        z = torch.matmul(y, wt.T).float().reshape(n_l, n, w)
        z = (z + b5[None]) + ops["r5"][:, None] if i == ops["n_pre"] \
            else z + ops["trunk_b"][i]
        z = torch.relu_(z).reshape(n_l * n, w)
        y = z if i == len(ops["trunk_wT"]) - 1 else z.to(bf)
    return (y @ ops["w8"] + ops["b8"]).reshape(n_l, n)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ phases

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log(json.dumps({"card": info}))
    return info


def phase_build():
    from psnerf_torch.ops.build import load_library

    t0 = time.perf_counter()
    load_library("fused_vis")
    log(json.dumps({"build_s": {"fused_vis": time.perf_counter() - t0}}))


def raw_errors(got, ref):
    """Raw visibility errors at the JAX kernel tests' metric."""
    err = (got - ref).abs()
    return {"shape": list(got.shape), "max_abs_err": err.max().item(),
            "mean_abs_err": err.mean().item(),
            "rel": (err / (ref.abs() + 1e-2)).max().item(),
            "corr": float(np.corrcoef(got.flatten().cpu().numpy(),
                                      ref.flatten().cpu().numpy())[0, 1])}


def check_raw(got, ref, what):
    m = raw_errors(got, ref)
    log(json.dumps({what: m}))
    check(torch.isfinite(got).all(), f"{what} finite")
    check(m["rel"] < RAW_REL and m["corr"] > RAW_CORR, f"{what} {m}")
    return m


def kernel_inputs(n, n_lights, seed):
    from psnerf_torch.core.encoding import nerf_embed
    from psnerf_torch.fields.mlp import skip_mlp_init

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    dev = DEV
    layers = skip_mlp_init(126, 1, 256, 8, (4,), generator=gen, device=dev)

    def unit(shape):
        v = rng.normal(size=shape)
        return torch.as_tensor(
            (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
                np.float32), device=dev)

    f = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    pts = f(rng.normal(size=(n, 3)) * 0.3)
    ld = unit((n_lights, 3))
    shade = dict(
        normal=unit((n, 3)), view=unit((n, 3)),
        albedo=f(rng.uniform(size=(n, 3))),
        weights=f(np.maximum(rng.normal(size=(n, 27)) * 0.3, 0)),
        mask=torch.as_tensor(rng.uniform(size=n) > 0.3, device=dev),
        light_dirs=ld, light_ints=f(rng.uniform(size=n_lights) * 2 + 0.5))
    return layers, nerf_embed(pts, 10), nerf_embed(ld, 10), shade


def phase_kernels():
    from psnerf_torch.ops import fused_vis as fv

    n, n_l = N_KERNEL, L_KERNEL
    layers, pe, le, sh = kernel_inputs(n, n_l, SEED)
    ops = fv.pack_vis_operands(layers, pe, le)
    flops = trunk_flops(n, n_l, ops["ke"])
    op_bytes = nbytes(*(ops[k] for k in ("em", "w0xT", "w5xT", "r0", "r5",
                                         "trunk_wT", "trunk_b", "w8")))

    # ---- K4 fused_visibility
    raw = fv.fused_visibility(layers, pe, le)
    torch.cuda.synchronize()
    ref = fv.fused_visibility_plain(layers, pe, le)
    m = check_raw(raw, ref, "fused_visibility")
    lib_err = (library_trunk(ops) - ref).abs().max().item()
    log(json.dumps({"library_max_abs_err": lib_err}))
    t = in_turns(
        {"plain": lambda: fv.fused_visibility_plain(layers, pe, le),
         "kernel": lambda: fv.fused_visibility(layers, pe, le),
         "library": lambda: library_trunk(ops)},
        {"plain": 2, "kernel": 5, "library": 3},
        ["plain", "kernel", "library", "library", "kernel", "plain"])
    b, by = bound_ms(flops, op_bytes + raw.numel() * 4)
    k4 = dict(max_abs_err=m["max_abs_err"], ms=t["kernel"],
              plain_ms=t["plain"], bound_ms=b, bound_by=by,
              library_ms=t["library"], flops=flops)
    log(json.dumps({"fused_visibility_ms": k4}))
    del raw, ref

    # ---- K5 fused_vis_shade, three output forms
    args = (layers, pe, le, sh["normal"], sh["view"], sh["albedo"],
            sh["weights"], sh["mask"], sh["light_dirs"], sh["light_ints"])
    shade_bytes = op_bytes + nbytes(sh["normal"], sh["view"], sh["albedo"],
                                    sh["weights"], sh["mask"],
                                    sh["light_dirs"], sh["light_ints"])
    modes = {}
    for name, kw in (("lnc", {}), ("cnl", {"layout": "cnl"}),
                     ("sum", {"sum_lights": True})):
        got = fv.fused_vis_shade(*args, **kw)
        torch.cuda.synchronize()
        ref = fv.fused_vis_shade_plain(*args, **kw)
        err = (got - ref).abs()
        m = dict(shape=list(got.shape), max_abs_err=err.max().item(),
                 mean_abs_err=err.mean().item())
        if name == "sum":       # a sum of L values: the bars scale with L
            m["max_abs_err_per_light"] = m["max_abs_err"] / n_l
            m["mean_abs_err_per_light"] = m["mean_abs_err"] / n_l
        log(json.dumps({f"fused_vis_shade_{name}": m}))
        check(torch.isfinite(got).all(), f"{name} rgb finite")
        scale = n_l if name == "sum" else 1
        check(m["max_abs_err"] < RGB_MAX * scale, f"{name} {m}")
        check(m["mean_abs_err"] < RGB_MEAN * scale, f"{name} {m}")
        fns = {"kernel": lambda kw=kw: fv.fused_vis_shade(*args, **kw)}
        reps = {"kernel": 5}
        order = ["kernel", "kernel"]
        if name == "lnc":
            fns["plain"] = lambda: fv.fused_vis_shade_plain(*args)
            fns["library"] = lambda: library_trunk(ops)
            reps.update(plain=2, library=3)
            order = ["plain", "kernel", "library", "library", "kernel",
                     "plain"]
        m.update(in_turns(fns, reps, order))
        m["bound_ms"], m["bound_by"] = bound_ms(
            flops, shade_bytes + got.numel() * 4)
        modes[name] = m
        del got, ref
    lnc = modes["lnc"]
    k5 = dict(max_abs_err=max(modes["lnc"]["max_abs_err"],
                              modes["cnl"]["max_abs_err"]),
              ms=lnc["kernel"], plain_ms=lnc["plain"],
              bound_ms=lnc["bound_ms"], bound_by=lnc["bound_by"],
              library_ms=lnc["library"], flops=flops,
              modes={k: {kk: v[kk] for kk in ("kernel", "max_abs_err",
                                               "mean_abs_err", "bound_ms")}
                     for k, v in modes.items()})
    log(json.dumps({"fused_vis_shade_ms": k5}))
    return k4, k5


def make_scene():
    from psnerf_torch.data.synthetic import (SNOWMAN_SPHERES,
                                             generate_synthetic_scene,
                                             write_stage1_exports)

    scene = os.path.join(WORK, "scene")
    t0 = time.perf_counter()
    # the default 64x64 scene's framing, at 512x512: focal scales with size
    generate_synthetic_scene(scene, n_views=2, n_test=1, n_lights=N_LIGHTS,
                             hw=HW, focal=80.0 * HW[0] / 64, seed=SEED,
                             spheres=SNOWMAN_SPHERES, light_spread=0.6)
    write_stage1_exports(scene, os.path.join(scene, "exports"), n_vis_plus=8)
    log(json.dumps({"scene_s": time.perf_counter() - t0}))
    return scene


def phase_main_path():
    from psnerf_torch.config import Stage2Config
    from psnerf_torch.data.stage2 import decode_imgs
    from psnerf_torch.eval.metrics import psnr, ssim
    from psnerf_torch.fields.psnet import PSNetConfig
    from psnerf_torch.ops import fused_vis as fv
    from psnerf_torch.runners.stage2 import Stage2Runner
    from psnerf_torch.train.stage2 import Stage2TrainConfig

    scene = make_scene()
    cfg = Stage2Config(
        net=PSNetConfig(), train=Stage2TrainConfig(), data_dir=scene,
        stage1_shape_path=os.path.join(scene, "exports"),
        inten_normalize=None)
    wd = os.path.join(WORK, "run")
    t0 = time.perf_counter()
    first = Stage2Runner(cfg, wd, seed=SEED, resume=False, device=DEV)
    ck = first.save(1)
    del first
    # another seed's init, then the checkpoint's weights over it
    runner = Stage2Runner(cfg, wd, seed=SEED + 1, device=DEV)
    check(runner.it == 1, f"resumed at it={runner.it}")
    with np.load(ck) as saved:
        for key, t in (("params/model/visibility/0/w",
                        runner.params["model"]["visibility"][0].w),
                       ("params/light_dirs", runner.params["light_dirs"])):
            np.testing.assert_array_equal(t.detach().cpu().numpy(),
                                          saved[key])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    data = runner._eval_data("test")
    torch.cuda.synchronize()
    out_dir = os.path.join(WORK, "eval")

    # ---- the main path: counts set to 0 just before, read just after
    fv.fused_visibility.launches = 0
    fv.fused_vis_shade.launches = 0
    t0 = time.perf_counter()
    runner.evaluate(out_dir, split="test")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    n_views = len(data["views"])
    dirs, ints = runner.trained_lights_for_view(data, 0)
    frame_ms = {"rgb": [], "rgb_sum": []}
    renders = {}
    for outputs in (("rgb",), ("rgb_sum",)):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            renders[outputs[0]] = runner.render_view(data, 0, dirs, ints,
                                                     outputs=outputs)
            torch.cuda.synchronize()
            frame_ms[outputs[0]].append((time.perf_counter() - t0) * 1e3)
    launches = {"fused_visibility": fv.fused_visibility.launches,
                "fused_vis_shade": fv.fused_vis_shade.launches}
    log(json.dumps({"main_path": {
        "checkpoint": os.path.relpath(ck, ROOT), "setup_s": setup_s,
        "evaluate_s_per_view": eval_s / n_views, "views": n_views,
        "frame_ms": frame_ms, "launches": launches}}))
    check(launches["fused_visibility"] >= n_views, f"launches {launches}")
    check(launches["fused_vis_shade"] >= 6, f"launches {launches}")

    # ---- the output tree of evaluate
    name = f"view_{int(data['views'][0]) + 1:02d}"
    pngs = os.listdir(os.path.join(out_dir, "rgb", "img", name))
    check(len(pngs) == N_LIGHTS, f"{len(pngs)} rgb pngs")
    for sub in ("visibility", "rough"):
        n_png = len(os.listdir(os.path.join(out_dir, sub, "img", name)))
        check(n_png == N_LIGHTS, f"{n_png} {sub} pngs")
    npy = lambda sub: np.load(os.path.join(out_dir, sub, "npy",
                                           name + ".npy"))
    mask = npy("mask")
    rgb, vis, rough, alb, nrm = (npy("rgb"), npy("visibility"),
                                 npy("rough"), npy("albedo"), npy("normal"))
    check(mask.shape == HW and 0.05 < mask.mean() < 0.9,
          f"mask {mask.shape}, coverage {mask.mean()}")
    check(rgb.shape == (N_LIGHTS, *HW, 3) and vis.shape == (N_LIGHTS, *HW),
          f"rgb {rgb.shape}, visibility {vis.shape}")
    for k, a in (("rgb", rgb), ("visibility", vis), ("rough", rough),
                 ("albedo", alb), ("normal", nrm)):
        check(np.isfinite(a).all(), k)
    out = ~mask
    check((rgb[:, out] == 1.0).all() and (vis[:, out] == 1.0).all(),
          "rgb and visibility fills outside the mask")
    check((rough[:, out] == 1.0).all() and (alb[out] == 1.0).all(),
          "rough and albedo fills outside the mask")
    check((nrm[out] == 0.0).all(), "normal zero outside the mask")
    check((renders["rgb_sum"]["rgb_sum"][out] == float(len(dirs))).all(),
          "rgb_sum outside the mask is L")

    # ---- K4 on the operands of evaluate's launch, against its plain version
    check_k4_at_view(runner, data, dirs)

    # ---- the kernel route against the plain route of the same view
    plain = runner.render_view(data, 0, dirs, ints,
                               outputs=("rgb", "rgb_sum", "visibility"),
                               use_fused_vis=False)
    kern_vis = runner.render_view(data, 0, dirs, ints,
                                  outputs=("visibility",))["visibility"]
    check(np.abs(vis - np.clip(kern_vis[..., 0], 0, 1)).max() < 1e-6,
          "evaluate's visibility is the kernel route's, clipped")
    check_raw(torch.as_tensor(kern_vis[:, mask, 0]),
              torch.as_tensor(plain["visibility"][:, mask, 0]),
              "raw_vis_kernel_vs_plain_route")
    kern = renders["rgb"]["rgb"]
    err = np.abs(kern - plain["rgb"])
    sum_err = np.abs(renders["rgb_sum"]["rgb_sum"] - plain["rgb_sum"])
    np.testing.assert_allclose(kern.sum(0), renders["rgb_sum"]["rgb_sum"],
                               atol=1e-3 * len(dirs))
    vis_err = np.abs(vis - np.clip(plain["visibility"][..., 0], 0, 1))
    # the scene's images against the render (random weights: no target)
    gt = decode_imgs(data["imgs"][0, 0]).cpu().numpy().reshape(*HW, 3)
    gt = gt + (1.0 - mask[..., None])
    quality = {"psnr_light0": psnr(kern[0], gt, mask),
               "ssim_light0": ssim(kern[0], gt)}
    route = {"rgb_max_abs_err": float(err.max()),
             "rgb_mean_abs_err": float(err.mean()),
             "rgb_sum_max_abs_err": float(sum_err.max()),
             "rgb_sum_mean_abs_err": float(sum_err.mean()),
             "vis_max_abs_err": float(vis_err.max()),
             "vis_mean_abs_err": float(vis_err.mean()), **quality}
    log(json.dumps({"kernel_vs_plain_route": route}))
    check(err.max() < RGB_MAX and err.mean() < RGB_MEAN, f"route {route}")
    n_l = len(dirs)               # a sum of L values: the bars scale with L
    check(sum_err.max() < RGB_MAX * n_l and sum_err.mean() < RGB_MEAN * n_l,
          f"route {route}")
    check(np.isfinite(list(quality.values())).all(), f"quality {quality}")
    breakdown = frame_breakdown(runner, data, dirs, ints)
    rgb_ms = float(np.median(frame_ms["rgb"]))
    return launches, {
        "evaluate_s_per_view": eval_s / n_views, "frame_ms": frame_ms,
        "rgb_pixel_lights_per_s": HW[0] * HW[1] * N_LIGHTS / (rgb_ms / 1e3),
        **breakdown}


def check_k4_at_view(runner, data, dirs, tile=4096):
    """fused_visibility on the operands evaluate gives it for view 0 (the
    surface-mask pixels, padded to the tile with pixel 0 as render_view
    pads them), held against its plain version."""
    from psnerf_torch.core.encoding import nerf_embed
    from psnerf_torch.ops import fused_vis as fv

    n_freqs = runner.cfg.net.n_freqs_xyz
    sel = torch.nonzero(data["surface_mask"][0].reshape(-1) > 0).flatten()
    sel = torch.cat([sel, sel.new_zeros((-sel.numel()) % tile)])
    pe = nerf_embed(data["points"][0][sel], n_freqs)
    le = nerf_embed(torch.as_tensor(dirs, dtype=torch.float32, device=DEV),
                    n_freqs)
    layers = runner.params["model"]["visibility"]
    raw = fv.fused_visibility(layers, pe, le)
    torch.cuda.synchronize()
    check_raw(raw, fv.fused_visibility_plain(layers, pe, le),
              "fused_visibility_at_evaluate_view")


def frame_breakdown(runner, data, dirs, ints):
    """Where one view's time goes, after the counted run: the render part
    of evaluate (its default outputs, host clock), and one rgb-route frame
    under torch.profiler (device busy time by kernel against the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.render_view(data, 0, dirs, ints)
    torch.cuda.synchronize()
    eval_render_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.render_view(data, 0, dirs, ints, outputs=("rgb",))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}                      # device-side events only: kernels, copies
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            dev[name] = dev.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    out = {"evaluate_render_ms": eval_render_ms,
           "rgb_frame_profiled": {"wall_ms": wall_ms, "device_busy_ms": busy,
                                  "idle_share": 1.0 - busy / wall_ms,
                                  "top_device_ms": top}}
    log(json.dumps({"frame_breakdown": out}))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import psnerf_torch  # noqa: F401  (fails outside the checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        with torch.no_grad():     # the layers are nn.Parameters
            card = phase_card()
            phase_build()
            k4, k5 = phase_kernels()
            launches, e2e = phase_main_path()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    def entry(name, replaces, k, launches_n):
        return {"name": name, "route": "cuda",
                "source": "psnerf_torch/ops/csrc/fused_vis.cu",
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                "status": "ported", "flops": k["flops"],
                **({"modes": k["modes"]} if "modes" in k else {})}

    not_ported = [
        {"name": "fused_occ_logit", "status": "not ported",
         "replaces": "psnerf_tpu/ops/fused_occ.py:113",
         "path": "stage-1 march, eval and shape export; MISE"},
        {"name": "fused_radiance_and_alpha (forward)",
         "status": "not ported",
         "replaces": "psnerf_tpu/ops/fused_radiance.py:390",
         "path": "stage-1 train step"},
        {"name": "fused_radiance_and_alpha (backward)",
         "status": "not ported",
         "replaces": "psnerf_tpu/ops/fused_radiance.py:410",
         "path": "stage-1 train step"}]
    log(json.dumps({"card": card["nvidia_smi"], "main_path": e2e}))
    log(card["nvidia_smi"])
    log(json.dumps({"kernels": [
        entry("fused_visibility", "psnerf_tpu/ops/fused_vis.py:219", k4,
              launches["fused_visibility"]),
        entry("fused_vis_shade", "psnerf_tpu/ops/fused_vis.py:387", k5,
              launches["fused_vis_shade"])], "not_ported": not_ported}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
