#!/usr/bin/env python3
"""Smoke run of psnerf_torch on one CUDA card: the quickest proof that the
port builds, is right and runs its main paths on the GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card: name, count, and nvidia-smi's name and power limit;
  2. build: one nvcc per CUDA source of psnerf_torch/ops/csrc, all at once;
  3. stage-2 kernels: fused_visibility and fused_vis_shade (layouts lnc and
     cnl, and the light sum) at the main path's widths (N = 65,536 pixels,
     L = 96, the 8x256 visibility net), each held against its plain
     PyTorch version and timed with CUDA events in turns (plain, kernel,
     kernel, plain), beside a chain of bf16 torch.matmul calls over the
     same trunk (a yardstick only; the port never calls it) and the least
     time the card could take (tensor-core FLOPs over 989 TFLOP/s; input
     and output bytes over 3.35 TB/s are far less); the light sum's bits
     are held from run to run;
  4. stage-1 kernels at the bear field (8x256, bf16 operands): fused_occ
     at the march's 2048 x 256 points and at a secant pass's 2048 (its
     bound the larger of the tensor time and its softplus epilogue's MUFU
     and FP32 instructions, counted in the built kernel's SASS with
     cuobjdump, at the card's highest SM clock), fused_radiance forward
     and backward
     at the integration batch of 2048 x 96 samples, each held against its
     plain version and timed the same way (yardsticks: the bf16 matmul
     chain for fused_occ, the plain autograd route for fused_radiance);
     the bf16 forward at most K2_BF16_MAX_MS, the bf16 backward bit for
     bit over three launches, at most K3_BF16_MAX_MS and faster than
     autograd, and each of its kernels (sweep, split-K weight-gradient
     products, the fixed-order sum) held against its plain version
     and timed alone;
  5. the f32-operand form of fused_radiance (the default field's) at 2048
     x 64 and 2048 x 96 points, held against its plain f32 version at the
     JAX kernel tests' bars (rgb and alpha 1e-5, each gradient leaf 2e-4
     of its max), its backward bit for bit from run to run, and timed the
     same way (yardstick: the f32 autograd route); an f64 run of the plain
     version shows how far f32 itself is from exact where ReLU kinks flip;
     at 2048 x 96 each of its kernels (prologue split, sweep, weight-
     gradient pass, reduce) is held against its plain version and timed
     alone, with the workspace's bytes;
  6. stage-2 main path: a 512x512 synthetic scene under 96 lights (2 train
     views, 1 test view) with its analytic stage-1 export; a full-width
     PSNet made from a seed, checkpointed, resumed by a fresh Stage2Runner,
     which runs evaluate(split="test") and render_view for the rgb and
     rgb_sum routes, with the kernels' launch counts set to 0 just before
     and read just after; the kernel route is held against the plain route;
  7. relighting and material edits on that runner, each path with the
     counts set to 0 just before and read just after: render_envmap of the
     test view under a sky written as .hdr by a small RGBE writer here
     (2 x 16^2 texel lights with per-channel intensities, the light sum in
     4 launches of 128 lights), one chunk's light sum held against the
     plain route at the light-sum bars and timed at its operands against
     its bound (per-channel and scalar intensities bit for bit from run to
     run); edit_material with an albedo and an SG-basis edit (the
     visibility kernel's precompute, plain shading) held against the plain
     route at the rgb bars, and the visibility kernel at its operands;
  8. stage-2 training on the same scene: Stage2Runner.train at the full
     bear PSNet (8,192 pixels x 10 lights, a vis_plus pool of 8) for 20
     warm-up and 20 more steps, with one plot_to_disk (fused_vis_shade's
     and the Adam kernel's launches set to 0 just before and read just
     after: two Adam launches a call, one call a warm-up step, three
     after); albedo, rough and the light tables bit for bit in the warm-up;
     a fresh runner's resume restores it, the params and the optimizer
     state bit for bit; ms per step and it/s, one profiled step; the
     card's step against the CPU's from identical params, batch and draws,
     in f32 and in f64 (loss, gradients, params);
  9. stage-1 main path on the same scene, twice: at the bf16 field (10 + 5
     steps) and at the default f32 field (20 + 10 steps, with the
     visualisation strip): Stage1Runner.train (2048 rays, 256 march steps,
     64 samples), counts of each kernel and form set to 0 just before and
     read just after (two Adam launches a step); a checkpoint at it=6000
     resumed by a fresh runner that trains at 96 samples; ms per step at
     64 and 96 samples; one profiled step; the kernel route's step held
     against the plain route's from identical params, batch and noise;
 10. stage-1 eval and export on the trained default field: render_view of
     the test view, eval_views("test"), and the faithful shape_extract of
     all three views toward the 96 training lights and 32 vis_plus
     directions, with fused_occ's launches counted; a self-shadow check,
     and the kernel route's export of one view toward 4 lights held
     against the plain route's;
 11. mesh extraction of that field, fused_occ's counts set to 0 just
     before and read just after: extract_mesh_both at the config's 64 and
     3 upsampling steps (a 513^3 grid, K1 at batches of 2^20 points) with
     silhouette carving, the seconds of each leg, both PLYs reloaded; one
     MISE round's K1 batch held against the plain version and timed
     against its bound; the K1 route's mesh against the plain route's at
     32 / 2 within one voxel by Chamfer; one refine_mesh of 20 steps;
 12. the export protocols on that field, each against phase 10's faithful
     export with fused_occ's launches counted: rescaled at 64 steps, mixed
     (faithful train lights, rescaled vis_plus at 32), guided vis_plus (16
     steps over a 64^3 guide grid's interval), light chunks of 4 and 8;
     the mixed and guided train-light visibility bit for bit the faithful
     one's, the chunks equal to chunk 1, every protocol's binary vis_plus
     agreement with the faithful export recorded, the guided one > 93% of
     the surface pairs; on the same field with its occupancy logit 8x
     steeper, the guided and rescaled ones > 93%; K1 at the
     guide grid's 262,144 points against its plain version and its bound;
 13. the command line (psnerf_torch.cli.main) at full width, in process:
     stage1-train, stage1-eval, shape-extract, extract-mesh, stage2-train,
     stage2-eval (evaluate, envmap, material edit) and evaluation from a
     YAML over configs/stage1/default.yaml and a conf of bear.conf's
     blocks, each command's kernel launches counted (every command must
     launch its path's kernels) and its seconds logged; one stage2-eval
     as `python -m psnerf_torch.cli.main` in a fresh process;
 14. preprocessing, conversion and LPIPS, with cuDNN's TF32 set back to
     PyTorch's default (on) for the phase, so that the port's own f32
     setting is what holds: reference-layout LCNet, NENet, stage-1 and
     stage-2 torch checkpoints made from seed 0, each through
     convert-ckpt and its npz loaded back leaf for leaf; sdps-preprocess
     over a copy of the phase-6 scene (LCNet from the converted npz,
     NENet from the .pth.tar), its seconds per view and per leg, LCNet and
     NENet ms per view by CUDA events beside their f32 FLOPs and bound;
     view 1's first SDPS_CMP_LIGHTS lights through both nets on the card
     and on the CPU (logits, classes away from near-ties, normals);
     light-avg and the SDPS-normalized averages of the port's own output,
     then stage1-train on them (inten_normalize: sdps), K1 and K2/K3-f32
     launched; evaluation --lpips_weights (a random npz) on phase 13's
     stage2-eval output, and one pair's LPIPS on the card against the CPU;
 15. data-parallel runs (psnerf_torch.parallel): two gloo ranks sharing
     cuda:0 (NCCL refuses two ranks on one device), spawned by
     parallel.launch after the build, first hold all_reduce, all_gather
     and broadcast on CUDA tensors; then each path with the counts set
     to 0 just before and read just after on each rank, against the same
     path in this one process: Stage1Runner(mesh=...).train at the f32
     field (5 steps) and the bf16 field (2), the first step's loss and
     all-reduced gradients at MESH_STEP_BARS, the params within Adam's
     2 lr a step and at least MESH_PARAM_SHARE of their elements inside
     rtol 2e-4, atol 2e-6 (tests/test_parallel.py:342);
     Stage1Runner(mesh=...).shape_extract, the faithful export (512 march
     steps, the 128-step visibility toward each view's 96 lights over the
     1 x 2 rays x lights layout) of the 3 views on one trained field, its
     npys against one process's: points and normals at 1e-5, the
     visibility at phase 10's route bar; Stage2Runner(mesh=...).train (5
     steps) at the same bars as stage 1; on one
     lifted checkpoint, evaluate's npys and render_view's rgb route at
     1e-5 abs, and over a 1 x 2 mesh one envmap chunk's light sum at the
     light-sum bars and render_envmap; then stage1-train --mesh-devices 1
     through the command line (one NCCL rank). Each rank's counts of K1,
     K2/K3 (both forms), K4 and K5 must be > 0 on the paths that take
     them; every wall is logged beside the card's name and power limit;
 16. the multi-tensor Adam (psnerf_torch/ops/csrc/adam.cu): one training
     step's adam_update calls on the card at the default widths, stage 1's
     field (42 leaves, one call) and the PSNet (44 leaves) with both light
     tables under row masks (three calls), held bit for bit (p, m, v,
     step) against adam_update_plain over ADAM_STEPS steps, two launches a
     call counted; each route timed in turns (plain, kernel, kernel,
     plain) by CUDA events, by the profiler's device time and by the host
     clock (µs a step), beside the byte bound (28 B a value at 3.35 TB/s);
 17. one JSON line of kernels, then the last line
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
PEAK_TF32_FLOPS = 495e12          # dense TF32 tensor cores
PEAK_F32_FLOPS = 67e12            # f32 FFMA outside the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
FP32_LANES, MUFU_LANES = 128, 16  # per SM and clock (sm_90 throughput table)
N_KERNEL, L_KERNEL = 65536, 96
HW, N_LIGHTS = (512, 512), 96
RAW_REL, RAW_CORR = 0.05, 0.999   # raw vis bars (tests/test_fused_vis.py)
RGB_MAX, RGB_MEAN = 2e-2, 2e-3    # rgb bars (tests/test_fused_vis.py)
N_RAYS, MARCH_STEPS = 2048, 256  # stage-1 rays per step, march steps
N_OCC = N_RAYS * MARCH_STEPS      # the march's proposal points per step
N_SECANT = N_RAYS                 # the points of one secant pass
N_RAD = N_RAYS * 96               # the integration batch after it > 5000
OCC_MAX, OCC_CORR = 0.05, 0.9999  # logit bars (tests/test_fused_occ.py)
OCC_MMA_SYNC_MAX = 5.5e-3         # the mma.sync design's max error (PERF.md)
GRAD_REL, GRAD_CORR = 2e-2, 0.999   # per-leaf gradient bars
# f32-operand form: tests/test_fused_radiance.py:39-42 and :73-75
F32_RGB, F32_GRAD_REL = 1e-5, 2e-4
KINK = 1e-4          # appearance pre-activations this close to 0 may flip
TILE = 4096          # the runners' pixel tile
K2_BF16_MAX_MS = 5.0    # the bf16 forward at N_RAD
K3_BF16_MAX_MS = 25.0   # the bf16 backward at N_RAD: sweeps, wgrad, reduce
K2_BF16_TARGET_MS, K3_BF16_TARGET_MS = 4.0, 20.0   # recorded, not held
# the bf16 sweep's workspace against radiance_sweep_plain (bf16): relu
# masks that a bf16 rounding flips move single elements by their size, so
# each array is held by its mean error over its mean and its correlation
SWEEP_MEAN_REL, SWEEP_CORR = 1e-2, 0.999
# the bf16 weight-gradient products against weight_grads_plain on the
# kernel's own workspace: the same bf16 operands, f32 sums in another order
WGRAD_REL = 1e-4
K3_SPREAD_RUNS = 10     # single launches of it timed for its spread
# stage-2 training at the bear config (configs/stage2/bear.conf) with
# bench.py's batch: 8,192 pixels x 10 lights, a vis_plus pool of 8
S2_PIXELS, S2_LIGHTS, S2_VIS, S2_WARMUP, S2_STEPS = 8192, 10, 8, 20, 40
# the card's stage-2 step against the CPU's (tests/test_torch_gpu.py's
# bars): loss relative; each gradient leaf over its scale; params where
# |g| > big_grad (a near-zero gradient's param moves by up to lr under
# Adam, so there only 2 lr holds). f32 gradients within 1e-3: the f32 sin
# and cos of the positional encoding differ by an ulp between the card's
# and the CPU's math libraries (tools/stage2_grad_precision.py)
S2_F32_BARS = {"loss_rel": 1e-4, "grad_rel": 1e-3, "param_abs": 1e-5,
               "big_grad": 1e-6}
S2_F64_BARS = {"loss_rel": 1e-12, "grad_rel": 1e-9, "param_abs": 1e-10,
               "big_grad": 1e-6}
# envmap relighting: a light_h x 2 light_h lat-long map (its light sum in
# launches of the runner's ENV_CHUNK = 128 lights,
# psnerf_tpu/runners/stage2.py:571-579)
LIGHT_H = 16
ALBEDO_NEW, BASIS_NEW = (0.8, 0.35, 0.2), 5     # the material edit
# a light sum (or an edited image) must span this many of its max bars on
# the surface mask, so that a kernel writing zeros or a constant fails
SUM_SPAN = 4.0
N_MISE = 1 << 20          # mesh extraction's MISE batch on the K1 route
MESH_ROUTE_RES = (32, 2)  # resolution0, upsampling of the route comparison
REFINE_STEPS = 20
GUIDE_RES, GUIDE_BOX = 64, 1.1   # the guided export's grid (its defaults)
# the export protocols on phase 9's trained default field, each against the
# faithful export of phase 10 (96 train lights, 32 vis_plus directions)
PROTOCOLS = {"rescaled": dict(vis_rescale=True, vis_steps=64),
             "mixed": dict(vis_plus_steps=32, vis_plus_rescale=True),
             "guided": dict(vis_plus_guided=True),
             "chunk4": dict(light_chunk=4), "chunk8": dict(light_chunk=8)}
VIS_AGREE = 0.93        # binary vis_plus agreement (tests/test_pipeline.py)
SHARPEN = 8.0           # the agreement bar's field: its logit 8x steeper
CHUNK_DEV = 1e-6        # light_chunk against chunk 1, if not bit for bit
S2_CLI_ITERS = 100      # stage2-train through the CLI: one log line
# phase 14: SDPS-Net and LPIPS on the card against the CPU (f32 both)
SDPS_CMP_LIGHTS = 8     # view 1's first lights
SDPS_LOGIT_REL = 1e-4   # LCNet logits, of each head's max |logit|
SDPS_TIE = 1e-3         # a top-two logit gap under this share of that max
                        # may flip a class: logged, not held
SDPS_NORMAL_ABS = 1e-4  # NENet normals inside the mask
S1_SDPS_STEPS = 5       # stage1-train on the port's own SDPS output
LPIPS_REL = 1e-5
# phase 15: data-parallel runs, two gloo ranks sharing cuda:0
MESH_RANKS = 2
MESH_S1_STEPS = {"float32": 5, "bfloat16": 2}
MESH_S2_STEPS = 5
MESH_PARAM_BARS = dict(rtol=2e-4, atol=2e-6)   # tests/test_parallel.py:342
# the least share of a run's param elements inside MESH_PARAM_BARS: the
# card measured 99.84% at the bf16 field (its lowest), 100% and 99.999%
MESH_PARAM_SHARE = 0.995
# the first step's loss (relative) and gradients (of each leaf's max):
# tests/test_parallel.py's step bars and the stage-1 step's gradient bar
# of tests/test_torch_stage1_train.py; the bf16 field's at GRAD_REL (its
# plain autograd rounds each rank's partial weight gradients to bf16)
MESH_STEP_BARS = {"stage1_float32": (1e-4, 1e-4),
                  "stage1_bfloat16": (1e-4, GRAD_REL),
                  "stage2": (1e-5, 1e-4)}
MESH_EVAL_ABS = 1e-5     # frames (tests/test_parallel.py:49-52)
MESH_MARCH_STEPS, MESH_VIS_STEPS = 512, 128     # the faithful export's
MESH_CLI_STEPS = 3
MESH_TIMEOUT_S = 400
# phase 16: the multi-tensor Adam against adam_update_plain
ADAM_BYTES = 28      # a value: p, g, m, v read; p, m, v written
ADAM_STEPS = 3       # steps held bit for bit


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


def host_us(fn, reps, batch=100):
    """Host µs per call: the host clock over `reps` calls in batches of
    `batch`, with no synchronize between the calls of a batch (one between
    batches, outside the clock, keeps the launch queue short)."""
    total = 0.0
    for _ in range(reps // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / (reps // batch * batch) * 1e6


def in_turns(fns: dict, reps: dict, order, timer=cuda_ms):
    """Time each named fn in the given order (e.g. plain, kernel, kernel,
    plain) with `timer` (cuda_ms: back-to-back calls between two events);
    returns {name: mean over its turns}."""
    for fn in fns.values():       # warm-up
        fn()
    torch.cuda.synchronize()
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(timer(fns[k], reps[k]))
    return {k: float(np.mean(v)) for k, v in got.items()}


def device_ms(fn, reps):
    """Device-only ms per call: the time of the device work that `reps`
    back-to-back calls launch, summed by torch.profiler (profile_device),
    without the gaps between launches."""
    return profile_device(lambda: [fn() for _ in range(reps)])[
        "device_busy_ms"] / reps


def time_slot_reduce(kernel, plain, library):
    """A fixed-order slot reduction of the engine (csrc/slot_reduce.cuh):
    `kernel` (a launch returning the sum) held bit for bit against `plain`
    (its plain version) on the same slots, then timed three ways, in turns
    with `library` (torch.sum over the same slots): back-to-back CUDA
    events (cuda_ms, the kernel table's number; the plain version's too),
    device only (device_ms) and host µs per launch (host_us over 1,000
    launches). Returns {kernel, library, plain: {ms, device_ms,
    host_us}, err: max |kernel - plain|}."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.equal(got, want), "slot reduction against its plain "
          f"version: {err}")
    fns = {"kernel": kernel, "library": library}
    order = ["library", "kernel", "kernel", "library"]
    ev = in_turns(dict(fns, plain=plain),
                  {"kernel": 20, "library": 20, "plain": 3},
                  ["plain"] + order + ["plain"])
    dev = in_turns(fns, dict.fromkeys(fns, 20), order, timer=device_ms)
    host = in_turns(fns, dict.fromkeys(fns, 1000), order, timer=host_us)
    out = {k: {"ms": ev[k], "device_ms": dev[k], "host_us": host[k]}
           for k in fns}
    out["plain"] = {"ms": ev["plain"]}
    out["err"] = err
    return out


def reduction_row(t, bnd, by, **extra):
    """The kernels-line row of a slot reduction timed by time_slot_reduce."""
    k, lib = t["kernel"], t["library"]
    return dict(max_abs_err=t["err"], ms=k["ms"], device_ms=k["device_ms"],
                host_us=k["host_us"], plain_ms=t["plain"]["ms"],
                bound_ms=bnd, bound_by=by, library_ms=lib["ms"],
                library_device_ms=lib["device_ms"],
                library_host_us=lib["host_us"], **extra)


def trunk_flops(n, n_lights, ke, width=256, n_trunk=7):
    """Tensor-core FLOPs of the visibility trunk: per (light, pixel) seven
    W x W products and the W-wide output dot; per pixel the two point
    halves (em @ W0x, em @ W5x) at the kernel's K, the embedding width
    padded to a multiple of 16 (64 for the 63-wide embedding)."""
    return (n * n_lights * (n_trunk * 2 * width * width + 2 * width)
            + n * 2 * 2 * ke * width)


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "max_sm_clock_mhz": float(clock),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log(json.dumps({"card": info}))
    return info


def phase_build():
    from psnerf_torch.ops.build import build_all, sources

    t0 = time.perf_counter()
    per_source = build_all()
    log(json.dumps({"build_s": {"total": time.perf_counter() - t0,
                                "per_source": per_source,
                                "sources": sources()}}))
    regs = ptxas_registers()
    log(json.dumps({"ptxas": regs}))
    return regs


def kernel_name(sym):
    """A short name of a mangled kernel symbol: the name that ends in
    "kernel", with its width and operand type where it is a template."""
    import re

    i = 0
    while i < len(sym):
        m = re.match(r"\d+", sym[i:])
        if not m:
            i += 1
            continue
        j = i + len(m.group(0))
        name = sym[j:j + int(m.group(0))]
        if name.endswith("kernel"):
            rest = sym[j + len(name):j + len(name) + 40]
            w = re.findall(r"Li(\d+)E", rest[:rest.find("Ev") + 1])
            return (name + (f"<{','.join(w)}>" if w else "")
                    + (" bf16" if "bfloat16" in rest else ""))
        i = j + max(len(name), 1)
    return sym


def ptxas_registers():
    """{source: {kernel: registers and spill bytes}} from the build's ptxas
    reports."""
    import re

    from psnerf_torch.ops.build import BUILD_DIR, sources

    out = {}
    for name in sources():
        kern, rows = None, {}
        for line in (BUILD_DIR / f"{name}.ptxas.txt").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kern = kernel_name(m.group(1))
                rows[kern] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and kern:
                rows[kern].update(spill_stores=int(m.group(1)),
                                  spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and kern:
                rows[kern]["registers"] = int(m.group(1))
        out[name] = rows
    return out


def sass_counts(lib_path, kernel, width):
    """Static SASS instruction counts (cuobjdump -sass) of the kernel
    instantiation named `kernel` at `width`: special-function (MUFU), FP32
    pipe (FADD, FMUL, FFMA, FMNMX, FSEL, FSETP, FSET and the F2FP packs),
    tensor (HGMMA, HMMA) and all instructions, and the MUFU and FP32 counts
    per MUFU.EX2 (one per softplus in fused_occ)."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    fp32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET", "F2FP"}
    c = {"mufu": 0, "mufu_ex2": 0, "fp32": 0, "tensor": 0, "total": 0}
    inside = False
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            inside = kernel in m.group(1) and f"Li{width}E" in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]\s+)?"
                     r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)", line)
        if not (inside and m):
            continue
        op, mods = m.group(1), m.group(2)
        c["total"] += 1
        c["mufu"] += op == "MUFU"
        c["mufu_ex2"] += op == "MUFU" and ".EX2" in mods
        c["fp32"] += op in fp32
        c["tensor"] += op in ("HGMMA", "HMMA")
    check(c["total"] > 0, f"no SASS of {kernel}<{width}> in {lib_path}")
    sites = max(c["mufu_ex2"], 1)
    c["mufu_per_softplus"] = c["mufu"] / sites
    c["fp32_per_softplus"] = c["fp32"] / sites
    return c


def occ_epilogue_ms(n, ops, counts, card):
    """The least time of fused_occ's epilogue instructions: per softplus
    (W of them per point and layer, 1 + n_trunk layers) the SASS's MUFU
    and FP32 counts, over the SMs' MUFU and FP32 lanes at the card's
    highest SM clock."""
    elems = n * ops["width"] * (1 + ops["trunk_wT"].shape[0])
    per_s = card["sms"] * card["max_sm_clock_mhz"] * 1e6
    return {"fp32_ms": elems * counts["fp32_per_softplus"]
            / (FP32_LANES * per_s) * 1e3,
            "mufu_ms": elems * counts["mufu_per_softplus"]
            / (MUFU_LANES * per_s) * 1e3}


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
            # the light sum's order is fixed: the same bits from run to run
            m["rerun_bitwise"] = bool(torch.equal(
                got, fv.fused_vis_shade(*args, **kw)))
            check(m["rerun_bitwise"], "light sum bitwise from run to run")
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
                     for k, v in modes.items()},
              rerun_bitwise=modes["sum"]["rerun_bitwise"])
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


def phase_main_path(scene):
    from psnerf_torch.config import Stage2Config
    from psnerf_torch.data.stage2 import decode_imgs
    from psnerf_torch.eval.metrics import psnr, ssim
    from psnerf_torch.fields.psnet import PSNetConfig
    from psnerf_torch.ops import fused_vis as fv
    from psnerf_torch.runners.stage2 import Stage2Runner
    from psnerf_torch.train.stage2 import Stage2TrainConfig

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
        **breakdown}, runner


def write_hdr(path, img):
    """A float RGB image [H, W, 3] as a Radiance .hdr of flat RGBE
    scanlines (Ward's float2rgbe: the shared exponent of the largest
    channel, mantissas truncated to 8 bits)."""
    h, w = img.shape[:2]
    m = img.max(axis=-1)
    mant, ex = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.maximum(m, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = (img * scale[..., None]).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, ex + 128, 0)
    with open(path, "wb") as fh:
        fh.write(f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n"
                 .encode())
        fh.write(rgbe.tobytes())


def sky_envmap(h=64, w=128):
    """An outdoor-like lat-long map [h, w, 3]: a blue sky over a darker
    ground, and a small warm sun."""
    lat = np.linspace(np.pi / 2, -np.pi / 2, h)[:, None, None]
    lng = np.linspace(np.pi, -np.pi, w)[None, :, None]
    sky = np.where(lat > 0, np.asarray([0.35, 0.55, 1.0]) * (0.4 + 0.6 *
                                                              np.sin(lat)),
                   np.asarray([0.25, 0.2, 0.15]) * 0.5)
    sun = np.exp(-((lat - 0.7) ** 2 + (lng - 0.8) ** 2) / 0.01) \
        * np.asarray([40.0, 36.0, 30.0])
    return (0.004 * (sky + sun)).astype(np.float32)


def envmap_chunk_operands(runner, data, dirs, ints, tile=TILE):
    """The operands render_view gives fused_vis_shade for one light chunk of
    view 0: the surface-mask pixels padded to the tile with pixel 0 (the
    mask compaction), their heads and camera rays, the chunk's lights and
    intensities."""
    from psnerf_torch.core.encoding import nerf_embed
    from psnerf_torch.core.rays import get_camera_params
    from psnerf_torch.render.shading import psnet_point_heads

    cfg = runner.cfg.net
    h, w = data["img_res"]
    sel = torch.nonzero(data["surface_mask"][0].reshape(-1) > 0).flatten()
    sel = torch.cat([sel, sel.new_zeros((-sel.numel()) % tile)])
    ys, xs = torch.meshgrid(torch.arange(h, device=DEV),
                            torch.arange(w, device=DEV), indexing="ij")
    uv = torch.stack([xs, ys], -1).reshape(-1, 2).float()[sel]
    rays, _ = get_camera_params(uv, data["poses"][0], data["K"])
    heads = psnet_point_heads(runner.params["model"], cfg,
                              data["points"][0][sel], data["normals"][0][sel])
    ld = torch.as_tensor(dirs, dtype=torch.float32, device=DEV)
    li = torch.as_tensor(ints, dtype=torch.float32, device=DEV)
    return (runner.params["model"]["visibility"], heads["point_emb"],
            nerf_embed(ld, cfg.n_freqs_xyz), heads["normal"], -rays,
            heads["albedo"], heads["weights"],
            torch.ones(sel.numel(), dtype=torch.bool, device=DEV), ld, li)


def time_envmap_chunk(args):
    """fused_vis_shade's light sum at one envmap chunk's operands, with the
    texels' per-channel intensities [L, 3] and with scalar intensities:
    held against its plain version at the light-sum bars (the rgb bars
    times each channel's intensity sum) and bit for bit from run to run,
    its plain version spanning many bars, then timed in turns with its
    plain version and the bf16 matmul chain over the same trunk."""
    from psnerf_torch.ops import fused_vis as fv

    n_l = args[-2].shape[0]
    m = {}
    for name, li in (("per_channel", args[-1]),
                     ("scalar", args[-1].mean())):
        a = args[:-1] + (li,)
        got = fv.fused_vis_shade(*a, sum_lights=True)
        again = fv.fused_vis_shade(*a, sum_lights=True)
        torch.cuda.synchronize()
        ref = fv.fused_vis_shade_plain(*a, sum_lights=True)
        err = (got - ref).abs()
        scale = (li.sum(0) if li.dim() else n_l * li.expand(3)).cpu().numpy()
        m[name] = {"max_abs_err": err.max().item(),
                   "mean_abs_err": err.mean().item(),
                   "max_abs_err_rgb": err.amax(0).tolist(),
                   "mean_abs_err_rgb": err.mean(0).tolist(),
                   "bar_max_rgb": (RGB_MAX * scale).tolist(),
                   "bar_mean_rgb": (RGB_MEAN * scale).tolist(),
                   "sum_range": [ref.amin(0).tolist(), ref.amax(0).tolist()],
                   "rerun_bitwise": bool(torch.equal(got, again))}
        check(torch.isfinite(got).all(), f"envmap chunk sum finite ({name})")
        check(m[name]["rerun_bitwise"], f"envmap chunk sum bitwise ({name})")
        check((err.amax(0).cpu().numpy() < RGB_MAX * scale).all()
              and (err.mean(0).cpu().numpy() < RGB_MEAN * scale).all(),
              f"envmap chunk sum against plain ({name}) {m[name]}")
        span = (ref.amax(0) - ref.amin(0)).cpu().numpy()
        check((span > SUM_SPAN * RGB_MAX * scale).all(),
              f"envmap chunk sum spans {SUM_SPAN} max bars ({name}) "
              f"{m[name]}")
    ops = fv.pack_vis_operands(args[0], args[1], args[2])
    t = in_turns(
        {"plain": lambda: fv.fused_vis_shade_plain(*args, sum_lights=True),
         "kernel": lambda: fv.fused_vis_shade(*args, sum_lights=True),
         "library": lambda: library_trunk(ops)},
        {"plain": 2, "kernel": 10, "library": 3},
        ["plain", "kernel", "library", "library", "kernel", "plain"])
    n = ops["n"]
    flops = trunk_flops(n, n_l, ops["ke"])
    op_bytes = nbytes(*(ops[k] for k in ("em", "w0xT", "w5xT", "r0", "r5",
                                         "trunk_wT", "trunk_b", "w8")),
                      *args[3:])
    b, by = bound_ms(flops, op_bytes + n * 3 * 4)
    row = dict(n=n, n_lights=n_l, max_abs_err=m["per_channel"]["max_abs_err"],
               sum_range=m["per_channel"]["sum_range"], ms=t["kernel"],
               plain_ms=t["plain"], library_ms=t["library"], bound_ms=b,
               bound_by=by, flops=flops, intensities=m)
    log(json.dumps({"fused_vis_shade_envmap_chunk": row}))
    return row


def lift_visibility(runner, data, dirs, n_pix=4096):
    """Shift the visibility MLP's output bias so that its raw output at
    view 0's surface points under `dirs` has median 0.5: at random init it
    sits at or below 0, so the clipped visibility, and with it every light
    sum and edited image, is near black and tests nothing. Returns the shift
    and the share of (pixel, light) pairs whose clip is strictly inside
    (0, 1) after it."""
    from psnerf_torch.core.encoding import nerf_embed
    from psnerf_torch.ops import fused_vis as fv

    n_freqs = runner.cfg.net.n_freqs_xyz
    sel = torch.nonzero(data["surface_mask"][0].reshape(-1) > 0).flatten()
    sel = sel[::max(1, sel.numel() // n_pix)]
    layers = runner.params["model"]["visibility"]
    raw = fv.fused_visibility_plain(
        layers, nerf_embed(data["points"][0][sel], n_freqs),
        nerf_embed(torch.as_tensor(dirs, dtype=torch.float32, device=DEV),
                   n_freqs))
    shift = 0.5 - raw.median().item()
    layers[-1].b.add_(shift)
    raw = raw + shift
    return {"bias_shift": shift,
            "open_share": ((raw > 0) & (raw < 1)).float().mean().item()}


def phase_relight_edit(runner, data):
    """Envmap relighting and material edits on phase 6's runner, its
    visibility output lifted (lift_visibility), each path with the
    kernels' counts set to 0 just before and read just after:
    render_envmap of the test view under a sky written as .hdr (2 x 16^2
    lights, 4 light-sum launches a view), one chunk's rgb_sum held against
    the plain route at the light-sum bars (the rgb bars times each
    channel's intensity sum) and the light sum timed at its operands;
    edit_material with an albedo and an SG-basis edit (the visibility
    kernel's precompute, plain shading), held against the plain route at
    the rgb bars, and the visibility kernel at its operands."""
    from psnerf_torch.core.spherical import gen_light_xyz
    from psnerf_torch.data.scene import imread
    from psnerf_torch.ops import fused_vis as fv
    from psnerf_torch.runners.stage2 import ENV_CHUNK, load_envmap

    hdr = os.path.join(WORK, "sky.hdr")
    write_hdr(hdr, sky_envmap())
    env = load_envmap(hdr, LIGHT_H)
    check(env.shape == (LIGHT_H, 2 * LIGHT_H, 3) and np.isfinite(env).all()
          and env.max() > 0, f"envmap {env.shape}")
    n_views = len(data["views"])
    name = f"view_{int(data['views'][0]) + 1:02d}"
    mask = data["surface_mask"][0].cpu().numpy().reshape(HW)
    lxyz, _ = gen_light_xyz(LIGHT_H, 2 * LIGHT_H, envmap_radius=1.0)
    dirs = lxyz.reshape(-1, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    lift = lift_visibility(runner, data, dirs)
    log(json.dumps({"visibility_lift": lift}))

    # ---- relighting: counts set to 0 just before, read just after
    out = os.path.join(WORK, "relight")
    fv.fused_visibility.launches = 0
    fv.fused_vis_shade.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.render_envmap(out, env, split="test", light_h=LIGHT_H, tile=TILE)
    torch.cuda.synchronize()
    relight_s = time.perf_counter() - t0
    relight = {"fused_visibility": fv.fused_visibility.launches,
               "fused_vis_shade": fv.fused_vis_shade.launches}
    n_lights = 2 * LIGHT_H * LIGHT_H
    chunks = -(-n_lights // ENV_CHUNK)
    check(relight == {"fused_visibility": 0,
                      "fused_vis_shade": chunks * n_views},
          f"relight launches {relight}")
    img = imread(os.path.join(out, "rgb", "img", name + ".png"))
    probe = imread(os.path.join(out, "light_probe.png"))
    check(img.shape == (*HW, 3) and probe.shape[:2] == (LIGHT_H * 8,
                                                         2 * LIGHT_H * 8),
          f"relight pngs {img.shape} {probe.shape}")
    check((img[~mask] == 255).all() and (img[mask] < 255).any(),
          "relit view: white off the mask, rendered on it")

    # one chunk's light sum: the kernel route against the plain route
    texels = env.reshape(-1, 3)[:ENV_CHUNK]
    kern = runner.render_view(data, 0, dirs[:ENV_CHUNK], texels,
                              outputs=("rgb_sum",))["rgb_sum"]
    plain = runner.render_view(data, 0, dirs[:ENV_CHUNK], texels,
                               outputs=("rgb_sum",),
                               use_fused_vis=False)["rgb_sum"]
    err = np.abs(kern - plain)[mask]              # [P, 3]
    scale = texels.sum(0)                         # each channel's sum
    span = plain[mask].max(0) - plain[mask].min(0)
    route_sum = {"max_abs_err": err.max(0).tolist(),
                 "mean_abs_err": err.mean(0).tolist(),
                 "bar_max": (RGB_MAX * scale).tolist(),
                 "bar_mean": (RGB_MEAN * scale).tolist(),
                 "sum_range": [plain[mask].min(0).tolist(),
                               plain[mask].max(0).tolist()]}
    check((err.max(0) < RGB_MAX * scale).all()
          and (err.mean(0) < RGB_MEAN * scale).all(),
          f"envmap chunk route {route_sum}")
    check((span > SUM_SPAN * RGB_MAX * scale).all(),
          f"envmap chunk sum spans {SUM_SPAN} max bars {route_sum}")
    k5_env = time_envmap_chunk(envmap_chunk_operands(
        runner, data, dirs[:ENV_CHUNK], texels))

    # ---- material edit: counts set to 0 just before, read just after
    out = os.path.join(WORK, "edit")
    fv.fused_visibility.launches = 0
    fv.fused_vis_shade.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.edit_material(out, split="test", albedo_new=ALBEDO_NEW,
                         basis_new=BASIS_NEW, tile=TILE)
    torch.cuda.synchronize()
    edit_s = time.perf_counter() - t0
    edit = {"fused_visibility": fv.fused_visibility.launches,
            "fused_vis_shade": fv.fused_vis_shade.launches}
    check(edit == {"fused_visibility": n_views, "fused_vis_shade": 0},
          f"edit launches {edit}")
    pngs = os.listdir(os.path.join(out, "rgb", "img", name))
    check(len(pngs) == N_LIGHTS, f"{len(pngs)} edited pngs")
    tdirs, tints = runner.trained_lights_for_view(data, 0)
    kw = dict(outputs=("rgb", "albedo"), albedo_new=ALBEDO_NEW,
              basis_new=BASIS_NEW)
    kern = runner.render_view(data, 0, tdirs, tints, **kw)
    plain = runner.render_view(data, 0, tdirs, tints, use_fused_vis=False,
                               **kw)
    err = np.abs(kern["rgb"] - plain["rgb"])[:, mask]
    on = plain["rgb"][:, mask]
    route_edit = {"rgb_max_abs_err": float(err.max()),
                  "rgb_mean_abs_err": float(err.mean()),
                  "rgb_range": [float(on.min()), float(on.max())]}
    check(err.max() < RGB_MAX and err.mean() < RGB_MEAN,
          f"edit route {route_edit}")
    check(on.max() - on.min() > SUM_SPAN * RGB_MAX,
          f"edited rgb spans {SUM_SPAN} max bars {route_edit}")
    check(np.allclose(kern["albedo"][mask], ALBEDO_NEW), "edited albedo")
    # the visibility kernel at the edit's operands
    check_k4_at_view(runner, data, tdirs)
    e2e = {"visibility_lift": lift, "relight_s_per_view": relight_s / n_views,
           "relight_launches": relight, "relight_lights": n_lights,
           "relight_chunk_route": route_sum, "edit_s_per_view":
           edit_s / n_views, "edit_launches": edit,
           "edit_route": route_edit}
    log(json.dumps({"relight_edit": e2e}))
    return {"relight": relight, "edit": edit}, e2e, k5_env


def stage2_train_config(scene):
    """The full bear PSNet (PSNetConfig()) and train config, at bench.py's
    stage-2 batch (8,192 pixels, 10 lights, a vis_plus pool of 8; bear.conf's
    train_all_pixels off as bench.py sets it), the warm-up cut to
    S2_WARMUP steps."""
    from psnerf_torch.config import Stage2Config
    from psnerf_torch.fields.psnet import PSNetConfig
    from psnerf_torch.train.stage2 import Stage2TrainConfig

    return Stage2Config(
        net=PSNetConfig(), train=Stage2TrainConfig(warmup_iters=S2_WARMUP),
        data_dir=scene, stage1_shape_path=os.path.join(scene, "exports"),
        inten_normalize=None, light_bs=S2_LIGHTS, vis_train_num=S2_VIS,
        num_pixels=S2_PIXELS, train_all_pixels=False, ckpt_freq=10 ** 9)


def stage2_leaves(runner):
    """{name: a copy} of the PSNet's leaves and the light tables."""
    from psnerf_torch.train.stage2 import model_params

    out = {k: v.detach().clone()
           for k, v in model_params(runner.params["model"]).items()}
    out.update({k: runner.params[k].clone()
                for k in ("light_dirs", "light_ints")})
    return out


def stage2_step_ms(runner, reps=10, warmup=5):
    """Median ms of one stage-2 training step (the batch and jitter draws
    included), host clock around synchronize, after `warmup` steps; the
    runner's parameters keep training, its `it` stays."""
    times = []
    for _ in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, noise = runner.sample()
        runner.step_fn(runner.params, runner.opt_state, batch, runner.it,
                       noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[warmup:])), times[warmup:]


def phase_stage2_train(scene):
    """Stage2Runner.train at the full bear width on the stage-2 scene: a
    warm-up of S2_WARMUP steps (albedo, rough and the light tables held bit
    for bit), then to S2_STEPS with one plot_to_disk (K5's launches counted
    just around the run), a resume that restores it, the params and the
    optimizer state bit for bit, ms per step, one profiled step, and the
    card's step against the CPU's from identical params, batch and draws
    (f32 and f64)."""
    from psnerf_torch.ops import adam
    from psnerf_torch.ops import fused_vis as fv
    from psnerf_torch.runners.stage2 import Stage2Runner

    cfg = stage2_train_config(scene)
    wd = os.path.join(WORK, "stage2_train")
    runner = Stage2Runner(cfg, wd, seed=SEED, resume=False, device=DEV)
    check(runner.device.type == "cuda" and runner.num_pixels == S2_PIXELS
          and runner.light_bs == S2_LIGHTS, "stage-2 runner on the card")
    before = stage2_leaves(runner)
    frozen = [k for k in before if k.split("/")[0] in
              ("albedo", "rough", "light_dirs", "light_ints")]

    # ---- the main path: counts set to 0 just before, read just after
    fv.fused_visibility.launches = 0
    fv.fused_vis_shade.launches = 0
    adam.fused_adam.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.train(S2_WARMUP, log_every=S2_WARMUP // 2)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after_warm = stage2_leaves(runner)
    kept = all(torch.equal(before[k], after_warm[k]) for k in frozen)
    moved = [k for k in before if not torch.equal(before[k], after_warm[k])]
    t0 = time.perf_counter()
    runner.train(S2_STEPS, log_every=S2_WARMUP // 2,
                 plot_every=S2_WARMUP + S2_WARMUP // 2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"fused_visibility": fv.fused_visibility.launches,
                "fused_vis_shade": fv.fused_vis_shade.launches,
                "fused_adam": adam.fused_adam.launches}
    recs = read_losses(wd)
    losses = [r["loss"] for r in recs if "loss" in r]
    plots = [r for r in recs if "train_psnr" in r]
    after = stage2_leaves(runner)
    moved_after = [k for k in frozen
                   if not torch.equal(after_warm[k], after[k])]
    out = {"steps": [S2_WARMUP, S2_STEPS], "warmup_wall_s": warm_s,
           "train_wall_s": train_s, "launches": launches, "losses": losses,
           "plot": plots, "frozen_kept_in_warmup": kept,
           "moved_in_warmup": len(moved), "frozen_moved_after": moved_after}
    log(json.dumps({"stage2_train": out}))
    check(kept, "albedo, rough and the light tables bit for bit in warm-up")
    check(any(k.startswith("visibility/") for k in moved),
          "the visibility net trains in the warm-up")
    check(len(losses) == S2_STEPS // (S2_WARMUP // 2)
          and np.isfinite(losses).all(), f"losses {losses}")
    check(any(k.startswith("albedo/") for k in moved_after),
          f"albedo trains after the warm-up: {moved_after}")
    check(len(plots) == 1 and os.path.exists(os.path.join(
        wd, "plots", f"it_{S2_WARMUP + S2_WARMUP // 2}.png")),
        f"plot_to_disk {plots}")
    check(launches["fused_vis_shade"] >= 2, f"K5 in plot_to_disk {launches}")
    # Adam: the PSNet's call every step, a call per trained light table
    # after the warm-up (frozen in it), two launches a call
    tc = cfg.train
    lights = (int(tc.light_train) + int(tc.light_inten_train)) * int(
        not tc.ana_fixlight)
    adam_calls = S2_WARMUP + (S2_STEPS - S2_WARMUP) * (1 + lights)
    check(launches["fused_adam"] == 2 * adam_calls,
          f"Adam launches {launches}, {adam_calls} calls")

    # ---- the end-of-run checkpoint, resumed by a fresh runner
    resumed = Stage2Runner(cfg, wd, seed=SEED + 1, device=DEV)
    check(resumed.it == S2_STEPS, f"resumed at it={resumed.it}")
    got = stage2_leaves(resumed)
    check(all(torch.equal(after[k], got[k]) for k in after),
          "resumed params bit for bit")
    from psnerf_torch.train.checkpoints import flatten_tree
    a, b = (flatten_tree(r.opt_state) for r in (runner, resumed))
    check(set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a),
          "resumed optimizer state bit for bit")
    del resumed

    # ---- ms per step, one profiled step
    ms, times = stage2_step_ms(runner)
    batch, noise = runner.sample()
    prof = profile_device(lambda: runner.step_fn(
        runner.params, runner.opt_state, batch, runner.it, noise))

    # ---- the card's step against the CPU's from identical params, batch
    # and draws, in f32 (the runner's precision) and in f64 (the card's
    # backward itself): the loss, every gradient leaf (loss_and_grads) and
    # every param after the step
    route = {}
    for dt, bars in ((torch.float32, S2_F32_BARS), (torch.float64,
                                                    S2_F64_BARS)):
        route[str(dt).removeprefix("torch.")] = stage2_step_vs_cpu(
            runner, cfg, batch, noise, dt, bars)
    e2e = {"ms_per_step": ms, "it_per_s": 1e3 / ms, "step_ms": times,
           "step_profiled": prof, "card_vs_cpu": route, **out}
    log(json.dumps({"stage2_train_main_path": e2e}))
    for dt, bars in (("float32", S2_F32_BARS), ("float64", S2_F64_BARS)):
        r = route[dt]
        check(r["leaves_match"], f"card and CPU gradient leaves ({dt})")
        check(r["loss_rel_diff"] <= bars["loss_rel"],
              f"card vs CPU loss ({dt}) {r}")
        check(r["grad_max_diff_over_scale"] <= bars["grad_rel"],
              f"card vs CPU gradients ({dt}) {r}")
        check(r["param_max_diff_where_grad_big"] <= bars["param_abs"],
              f"card vs CPU params where the gradient is not near 0 ({dt}) "
              f"{r}")
        check(r["param_max_diff_over_lr"] <= 2 * (1 + 1e-4),
              f"card vs CPU params within 2 lr ({dt}) {r}")
    return launches, e2e


def stage2_step_vs_cpu(runner, cfg, batch, noise, dt, bars):
    """One stage-2 step (loss_and_grads, then the step from a fresh
    optimizer state) from the runner's params on the card and on the CPU
    in dtype dt; the distances between the two."""
    import copy

    from psnerf_torch.train import stage2

    tcfg = runner.tcfg
    steps = {}
    for dev in (DEV, "cpu"):
        params = {"model": copy.deepcopy(runner.params["model"]).to(dev, dt),
                  **{k: runner.params[k].to(dev, dt, copy=True)
                     for k in ("light_dirs", "light_ints")}}
        cast = lambda v: v.to(dev, dt) if v.is_floating_point() \
            else v.to(dev)
        b = {k: cast(v) for k, v in batch.items()}
        nz = {k: cast(v) for k, v in noise.items()}
        init, step = stage2.make_stage2_train_step(cfg.net, tcfg)
        _, grads = step.loss_and_grads(params, b, runner.it, nz)
        t = step(params, init(params), b, runner.it, nz)
        flat = {k: v.detach().cpu() for k, v in
                stage2.model_params(params["model"]).items()}
        flat.update({k: params[k].cpu() for k in ("light_dirs",
                                                  "light_ints")})
        steps[dev] = (float(t["loss"]), {k: g.cpu() for k, g in
                                         grads.items()}, flat)
    (loss_g, g_g, p_g), (loss_c, g_c, p_c) = steps[DEV], steps["cpu"]
    lrs = {"light_dirs": tcfg.light_learning_rate,
           "light_ints": tcfg.light_inten_lr}
    grad_rel, p_big, over = {}, {}, {}
    for k, v in p_c.items():
        grad_rel[k] = ((g_g[k] - g_c[k]).abs().max().item()
                       / (g_c[k].abs().max().item() + 1e-8))
        big = g_c[k].abs() > bars["big_grad"]
        diff = (p_g[k] - v).abs()
        p_big[k] = diff[big].max().item() if big.any() else 0.0
        over[k] = diff.max().item() / lrs.get(k, tcfg.sg_learning_rate)
    worst = lambda d: max(d, key=d.get)
    return {"loss_card": loss_g, "loss_cpu": loss_c,
            "loss_rel_diff": abs(loss_g - loss_c) / abs(loss_c),
            "leaves_match": set(g_g) == set(g_c) == set(p_c),
            "grad_max_diff_over_scale": max(grad_rel.values()),
            "grad_worst_leaf": worst(grad_rel),
            "param_max_diff_where_grad_big": max(p_big.values()),
            "param_big_worst_leaf": worst(p_big),
            "param_max_diff_over_lr": max(over.values()),
            "worst_leaf": worst(over)}


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


def profile_device(fn):
    """Run fn once under torch.profiler: the wall (host clock to a
    synchronize), device busy time summed over device-side events (kernels,
    copies), the idle share and the top device ops by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            dev[name] = dev.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(dev.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "top_device_ms": sorted(dev.items(), key=lambda kv: -kv[1])[:8]}


def frame_breakdown(runner, data, dirs, ints):
    """Where one view's time goes, after the counted run: the render part
    of evaluate (its default outputs, host clock), and one rgb-route frame
    under torch.profiler (device busy time by kernel against the wall)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.render_view(data, 0, dirs, ints)
    torch.cuda.synchronize()
    eval_render_ms = (time.perf_counter() - t0) * 1e3
    out = {"evaluate_render_ms": eval_render_ms,
           "rgb_frame_profiled": profile_device(
               lambda: runner.render_view(data, 0, dirs, ints,
                                          outputs=("rgb",)))}
    log(json.dumps({"frame_breakdown": out}))
    return out


# ------------------------------------------------------------ stage 1

def occ_flops(n, ops):
    """Tensor-core FLOPs of fused_occ per call: per point layer 0 and the
    skip's PE half at the kernel's K (E = 39 padded to 48), the trunk's
    W x W products, and the W-wide logit dot."""
    w, ke, nt = ops["width"], ops["ke"], ops["trunk_wT"].shape[0]
    return n * 2 * w * (2 * ke + nt * w + 1)


def radiance_flops(n, w, ke, kv, nt):
    """Tensor-core FLOPs of fused_radiance per call, at the kernels' padded
    K (ke = 48, kv = 32) and the rgb head's 8 columns. Forward: trunk (nt),
    feature head, reverse sweep (nt), wf and the 3 appearance layers, W x W
    each; layer 0, the skip's PE half and their two transposes (ke), wv
    (kv). Backward: the recompute (nt + 5), the appearance backward (10:
    3 x (dTn + dnT), wf, g_feat, w8f, h_bar), the tangent forward (nt)
    and the doubled reverse sweep (4 nt), W x W each; 8 ke and 2 kv narrow
    products; the rgb head's few."""
    fwd = n * 2 * w * ((2 * nt + 5) * w + 4 * ke + kv + 8)
    bwd = n * 2 * w * ((6 * nt + 15) * w + 8 * ke + 2 * kv + 6)
    return fwd, bwd


@torch.no_grad()
def library_occ(ops, em):
    """fused_occ's trunk as a chain of bf16 torch.matmul calls (cuBLAS) with
    f32 softplus passes: the yardstick of library_ms, never called by the
    port."""
    from psnerf_torch.ops.fused_occ import _sp100

    bf = torch.bfloat16
    y = _sp100(torch.matmul(em, ops["w0T"].T).float() + ops["b0"])
    b_pe = torch.matmul(em, ops["wskipT"].T).float()
    for i, wT in enumerate(ops["trunk_wT"]):
        h = torch.matmul(y.to(bf), wT.T).float() + ops["trunk_b"][i]
        y = _sp100(h + b_pe if i == ops["n_pre"] else h)
    return y @ ops["w8"] + ops["b8"]


def leaf_errors(got, want):
    """Per gradient leaf: max |diff| over max |plain|, and the correlation."""
    out = {}
    for k, b in want.items():
        a = got[k]
        scale = b.abs().max().item() + 1e-30
        corr = (float(np.corrcoef(a.flatten().cpu().numpy(),
                                  b.flatten().cpu().numpy())[0, 1])
                if b.numel() > 1 else 1.0)
        diff = (a - b).abs().max().item()
        out[k] = {"abs": diff, "rel": diff / scale, "corr": corr}
    return out


def time_radiance(field, cfg, p, rd, packed, inputs, g_e, g_out, skip,
                  compute):
    """K2 and K3 of one operand form timed in turns (plain, kernel,
    kernel, plain) beside the plain autograd route (library: its forward
    with the create_graph normals, and torch.autograd.grad of the weights),
    with their bounds at the form's tensor-core peak: bf16 one pass at 989
    TFLOP/s; f32 three TF32 passes (3xTF32, the least work that meets the
    f32 form's bars) at 495 TFLOP/s. Each kernel time is all of the form's
    launches of one call (the f32 form: prologue and forward; prologue,
    sweeps, weight-gradient passes and reduce). Returns the forward's and
    the backward's dicts."""
    from psnerf_torch.fields.occupancy import radiance_and_alpha
    from psnerf_torch.ops import fused_radiance as fr

    em, de, vpe, p3 = inputs
    n = em.shape[0]

    def library_graph():
        with torch.enable_grad():
            rgb, a = radiance_and_alpha(field, p, rd, cfg)
            return (torch.cat([rgb, a[:, None]], 1) * g_out).sum()

    params = list(field.parameters())
    graph = library_graph()
    with torch.no_grad():
        t = in_turns(
            {"fwd_plain": lambda: fr.radiance_forward_plain(
                packed, em, de, vpe, p3, skip, compute),
             "fwd_kernel": lambda: fr.radiance_forward(
                 packed, em, de, vpe, p3, skip, compute),
             "bwd_plain": lambda: fr.radiance_backward_plain(
                 packed, em, de, vpe, p3, g_e, g_out, skip, compute),
             "bwd_kernel": lambda: fr.radiance_backward(
                 packed, em, de, vpe, p3, g_e, g_out, skip, compute),
             "fwd_library": library_graph,
             "bwd_library": lambda: torch.autograd.grad(
                 graph, params, retain_graph=True)},
            {"fwd_plain": 2, "fwd_kernel": 5, "bwd_plain": 2,
             "bwd_kernel": 3, "fwd_library": 2, "bwd_library": 2},
            ["fwd_plain", "fwd_kernel", "bwd_plain", "bwd_kernel",
             "fwd_library", "bwd_library", "bwd_library", "fwd_library",
             "bwd_kernel", "bwd_plain", "fwd_kernel", "fwd_plain"])
    del graph
    w, ke, kv = cfg.hidden_dim, em.shape[1], vpe.shape[1]
    f_fwd, f_bwd = radiance_flops(n, w, ke, kv, cfg.num_layers - 1)
    bf16 = compute == "bfloat16"
    w_bytes = (nbytes(fr.bf16_slabs(packed)) if bf16
               else sum(x.numel() * 4 for x in packed.values()))
    op = 2 if bf16 else 4                          # em and vpe reach it so
    in_bytes = n * (ke * op + ke * 4 + kv * op + 3 * 4)
    grad_bytes = sum(x.numel() * 4 for x in packed.values())
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS
    passes = 1 if bf16 else 3
    b2, by2 = bound_ms(passes * f_fwd, in_bytes + w_bytes + n * (4 + ke) * 4,
                       peak)
    b3, by3 = bound_ms(passes * f_bwd, in_bytes + w_bytes + n * (ke + 4) * 4
                       + grad_bytes, peak)
    k2 = dict(ms=t["fwd_kernel"], plain_ms=t["fwd_plain"], bound_ms=b2,
              bound_by=by2, library_ms=t["fwd_library"], flops=f_fwd, n=n)
    k3 = dict(ms=t["bwd_kernel"], plain_ms=t["bwd_plain"], bound_ms=b3,
              bound_by=by3, library_ms=t["bwd_library"], flops=f_bwd, n=n)
    return k2, k3


def phase_stage1_kernels(card):
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.ops import fused_occ as fo
    from psnerf_torch.ops import fused_radiance as fr

    cfg = OccFieldConfig(compute_dtype="bfloat16")
    field = init_occupancy_field(
        cfg, generator=torch.Generator().manual_seed(SEED), device=DEV)
    rng = np.random.default_rng(SEED)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEV)

    # ---- K1 fused_occ_logit at the march's points and a secant pass's;
    # its bound: the larger of the tensor (or byte) time and the epilogue's
    # MUFU and FP32 instructions, counted in the built kernel's SASS
    from psnerf_torch.ops.build import library_path

    sass = sass_counts(library_path("fused_occ"), "occ_kernel",
                       cfg.hidden_dim)
    log(json.dumps({"fused_occ_sass": sass}))
    k1 = None
    with torch.no_grad():
        ops = fo.pack_occ_operands(field, cfg)
        for n in (N_OCC, N_SECANT):
            p = f(rng.normal(size=(n, 3)) * 0.6)
            em = fo.occ_embed(p, ops)
            out = torch.empty((n,), dtype=torch.float32, device=DEV)
            got = fo.fused_occ_logit(field, p, cfg)
            torch.cuda.synchronize()
            ref = fo._logit_plain(ops, em)
            err = (got - ref).abs()
            m1 = {"n": n, "max_abs_err": err.max().item(),
                  "mean_abs_err": err.mean().item(),
                  "corr": float(np.corrcoef(got.cpu().numpy(),
                                            ref.cpu().numpy())[0, 1]),
                  "library_max_abs_err": (library_occ(ops, em) - ref).abs()
                  .max().item()}
            log(json.dumps({"fused_occ_logit": m1}))
            check(torch.isfinite(got).all(), "fused_occ finite")
            check(m1["max_abs_err"] < OCC_MAX and m1["corr"] > OCC_CORR
                  and m1["max_abs_err"] <= 2 * OCC_MMA_SYNC_MAX,
                  f"fused_occ {m1}")
            big = n == N_OCC
            t = in_turns({"plain": lambda: fo._logit_plain(ops, em),
                          "kernel": lambda: fo._launch(ops, em, out),
                          "library": lambda: library_occ(ops, em)},
                         {"plain": 3 if big else 20,
                          "kernel": 10 if big else 200,
                          "library": 5 if big else 50},
                         ["plain", "kernel", "library", "library", "kernel",
                          "plain"])
            flops = occ_flops(n, ops)
            op_bytes = nbytes(em, ops["slabs"], *(ops[k] for k in (
                "b0", "trunk_b", "w8", "b8")))
            b_tc, by = bound_ms(flops, op_bytes + out.numel() * 4)
            epi = occ_epilogue_ms(n, ops, sass, card)
            b = max(b_tc, epi["fp32_ms"], epi["mufu_ms"])
            row = dict(max_abs_err=m1["max_abs_err"], ms=t["kernel"],
                       plain_ms=t["plain"], bound_ms=b,
                       bound_by=by if b == b_tc else "operations",
                       library_ms=t["library"], flops=flops, n=n,
                       bound_parts={"tensor_or_bytes_ms": b_tc,
                                    "tensor_or_bytes_by": by, **epi})
            log(json.dumps({"fused_occ_logit_ms": row}))
            if big:
                k1 = dict(row, sass=sass)
            else:
                k1["at_secant_pass"] = row
            del p, em, out, got, ref

    # ---- K2 / K3 fused_radiance_and_alpha at the integration batch
    p = f(rng.normal(size=(N_RAD, 3)) * 0.5)
    v = rng.normal(size=(N_RAD, 3))
    rd = f(v / np.linalg.norm(v, axis=-1, keepdims=True))
    skip = cfg.skips[0] - 1
    with torch.no_grad():
        em, de, vpe, p3 = fr.radiance_inputs(p, rd, cfg)
        packed = fr.pack_radiance(field, cfg, torch.bfloat16)
        out, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip)
        torch.cuda.synchronize()
        ref, g_e_ref = fr.radiance_forward_plain(packed, em, de, vpe, p3, skip)
        finish = lambda o: torch.cat([torch.tanh(o[:, :3]) * 0.5 + 0.5,
                                      torch.sigmoid(-10.0 * o[:, 3:])], 1)
        err = (finish(out) - finish(ref)).abs()
        m2 = {"rgb_alpha_max_abs_err": err.max().item(),
              "rgb_alpha_mean_abs_err": err.mean().item(),
              "raw_max_abs_err": (out - ref).abs().max().item(),
              "g_e_rel": ((g_e - g_e_ref).abs().max()
                          / g_e_ref.abs().max()).item()}
        log(json.dumps({"fused_radiance_forward": m2}))
        check(torch.isfinite(out).all() and torch.isfinite(g_e).all(),
              "fused_radiance forward finite")
        check(m2["rgb_alpha_max_abs_err"] < RGB_MAX
              and m2["rgb_alpha_mean_abs_err"] < RGB_MEAN, f"K2 {m2}")
        # the backward under two upstream gradients: a loss that grows with
        # every output (its sums add up, as a training loss's mostly do)
        # holds the bars; random signs (sums that cancel, so bf16 rounding
        # and relu-mask flips show most) are reported and held by corr
        g_pos = f(rng.uniform(0.5, 1.5, size=(N_RAD, 4)))
        g_rand = f(rng.normal(size=(N_RAD, 4)))
        errs = {}
        for name, g in (("positive", g_pos), ("random_sign", g_rand)):
            got = fr.radiance_backward(packed, em, de, vpe, p3, g_e_ref, g,
                                       skip)
            torch.cuda.synchronize()
            want = fr.radiance_backward_plain(packed, em, de, vpe, p3,
                                              g_e_ref, g, skip)
            errs[name] = leaf_errors(got, want)
            for k, e in errs[name].items():
                check(all(np.isfinite(list(e.values()))), f"K3 {k} {e}")
                check(e["corr"] > GRAD_CORR, f"K3 {name} {k} {e}")
                if name == "positive":
                    check(e["rel"] < GRAD_REL, f"K3 {name} {k} {e}")
            del got, want
        # split-K and column-sum slots summed in fixed order: the same
        # bits from run to run
        rerun = [fr.radiance_backward(packed, em, de, vpe, p3, g_e_ref,
                                      g_pos, skip) for _ in range(3)]
        bitwise = all(torch.equal(rerun[0][k], r[k])
                      for r in rerun[1:] for k in rerun[0])
        del rerun
        log(json.dumps({"fused_radiance_backward": errs,
                        "rerun_bitwise_equal": bitwise}))
        check(bitwise, "K3 bf16: three launches agree bit for bit")
        g_out = g_pos

    k2, k3 = time_radiance(field, cfg, p, rd, packed, (em, de, vpe, p3),
                           g_e_ref, g_out, skip, "bfloat16")
    k2.update(max_abs_err=m2["rgb_alpha_max_abs_err"])
    # the spread of K3's time: single launches, each timed on its own
    with torch.no_grad():
        single = [cuda_ms(lambda: fr.radiance_backward(
            packed, em, de, vpe, p3, g_e_ref, g_out, skip), 1)
            for _ in range(K3_SPREAD_RUNS)]
    k3.update(max_abs_err=max(e["abs"] for e in errs["positive"].values()),
              max_rel_err=max(e["rel"] for e in errs["positive"].values()),
              rerun_bitwise_equal=bitwise,
              single_launch_ms={"min": min(single),
                                "median": float(np.median(single)),
                                "max": max(single), "runs": single})
    log(json.dumps({"fused_radiance_ms": {"forward": k2, "backward": k3}}))
    check(k3["ms"] <= K3_BF16_MAX_MS and k3["ms"] < k3["library_ms"],
          f"K3 bf16 at most {K3_BF16_MAX_MS} ms and faster than autograd: "
          f"{k3['ms']} ms, autograd {k3['library_ms']} ms")
    check(k2["ms"] <= K2_BF16_MAX_MS,
          f"K2 bf16 at most {K2_BF16_MAX_MS} ms: {k2['ms']} ms")
    k2["meets_target"] = k2["ms"] <= K2_BF16_TARGET_MS
    k3["meets_target"] = k3["ms"] <= K3_BF16_TARGET_MS
    stages = time_bf16_stages(packed, (em, de, vpe, p3), g_e_ref, g_out,
                              skip)
    k3["stages_ms"] = {k: v["ms"] for k, v in stages.items() if "ms" in v}
    k3["host_us"] = stages["workspace"]["backward_host_us"]
    return k1, k2, k3, stages


def bf16_stage_flops(n, w, ke, kv, nt):
    """Tensor-core FLOPs of the bf16 backward's stages at the kernels'
    padded K: the sweep's activation products (as the f32 form's, one bf16
    pass) and the weight-gradient products (the trunk's two segments 2 nt,
    w8f, wf and wa 5, W x W each; wv's kv rows, w0 and wskip's 4 ke, the
    rgb head's 8 columns)."""
    sweep = f32_stage_flops(n, w, ke, kv, nt)[0]
    wgrad = n * 2 * w * ((2 * nt + 5) * w + kv + 4 * ke + 8)
    return sweep, wgrad


def time_bf16_stages(packed, inputs, g_e, g_out, skip):
    """The bf16 backward kernel by kernel (Bf16Backward: sweeps, split-K
    weight-gradient passes, the fixed-order sum), each held against
    its plain version on the same inputs and timed in turns with it
    (plain, kernel, kernel, plain): radiance_sweep_plain at bf16 per chunk
    (each workspace array by SWEEP_MEAN_REL and SWEEP_CORR; the column
    sums, the bias-like leaves, wp, wn and w8l, against weight_grads_plain
    of the plain sweep by GRAD_REL); weight_grads_plain on the kernel's
    own workspace, summed over the chunks, for the products' leaves
    (WGRAD_REL); the reduce bit for bit against slot_sum_plain of the
    split-K slots (the last chunk's splits carry the column sums). Its
    library_ms is torch.sum over those slots; no single PyTorch call
    computes the sweep or the weight-gradient pass, so theirs is null."""
    from psnerf_torch.ops import fused_radiance as fr

    em, de, vpe, p3 = inputs
    n = em.shape[0]
    b = fr.Bf16Backward(packed, em, de, vpe, p3, g_e, g_out, skip)
    w, ke, kv, nt = b.dims
    chunks = range(b.n_chunks)
    rows = [slice(c * fr.CHUNK, c * fr.CHUNK + b._chunk(c)[1])
            for c in chunks]
    leaves, p_floats, c_floats = fr.bf16_slot_layout(*b.dims)
    sums = [k for k in fr.PACK_ORDER if leaves[k] >= p_floats]
    prods = [k for k in fr.PACK_ORDER if leaves[k] < p_floats]
    f32_only = ("p3", "n3", "w8lt")
    with torch.no_grad():
        sweep_mean, sweep_corr, ws_kernel, cs_plain = 0.0, 1.0, [], None
        for c in chunks:
            b.sweep(c)
            b.wgrad(c)
            got = b.workspace(c)
            r = rows[c]
            want = fr.radiance_sweep_plain(packed, em[r], de[r], vpe[r],
                                           p3[r], g_e[r], g_out[r], skip)
            for k, x in got.items():
                y = want[k].to(torch.bfloat16).float()
                sweep_mean = max(sweep_mean, ((x - y).abs().mean()
                                              / (y.abs().mean() + 1e-30))
                                 .item())
                if x.numel() > 1 and y.std() > 0:
                    sweep_corr = min(sweep_corr, float(np.corrcoef(
                        x.flatten().cpu().numpy(),
                        y.flatten().cpu().numpy())[0, 1]))
            d = fr.weight_grads_plain(want, skip)
            cs_plain = d if cs_plain is None else {
                k: cs_plain[k] + d[k] for k in d}
            ws_kernel.append(dict(got, **{k: want[k] for k in f32_only}))
            del want
        grads = b.reduce()
        torch.cuda.synchronize()
        reduce_plain = lambda: fr.slot_sum_plain(b.partial)
        sum_want = reduce_plain()
        check(torch.equal(b.sum, sum_want),
              "the bf16 reduce against its plain version: "
              f"{(b.sum - sum_want).abs().max().item()}")
        rel = lambda a, x: ((a - x).abs().max()
                            / (x.abs().max() + 1e-30)).item()
        colsum_err = max(rel(grads[k], cs_plain[k]) for k in sums)
        wg_plain = None
        for ws in ws_kernel:
            d = fr.weight_grads_plain(ws, skip)
            wg_plain = d if wg_plain is None else {
                k: wg_plain[k] + d[k] for k in d}
        wgrad_err = max(rel(grads[k], wg_plain[k]) for k in prods)
        t = in_turns(
            {"sweep": lambda: [b.sweep(c) for c in chunks],
             "sweep_plain": lambda: [fr.radiance_sweep_plain(
                 packed, em[r], de[r], vpe[r], p3[r], g_e[r], g_out[r],
                 skip) for r in rows],
             "wgrad": lambda: [b.wgrad(c) for c in chunks],
             "wgrad_plain": lambda: [fr.weight_grads_plain(ws, skip)
                                     for ws in ws_kernel]},
            {"sweep": 3, "sweep_plain": 2, "wgrad": 3, "wgrad_plain": 2},
            ["sweep_plain", "sweep", "sweep", "sweep_plain",
             "wgrad_plain", "wgrad", "wgrad", "wgrad_plain"])
        # (the wgrad turns above recomputed every chunk's slots from the
        # last chunk's workspace: the check below takes them as they are)
        t_reduce = time_slot_reduce(lambda: (b.reduce(), b.sum)[1],
                                    reduce_plain,
                                    lambda: torch.sum(b.partial, 0))
        one_backward = lambda: fr.Bf16Backward(packed, em, de, vpe, p3, g_e,
                                               g_out, skip).run()
        one_backward()
        backward_host_us = host_us(one_backward, 20, batch=1)
    del ws_kernel
    f_sweep, f_wgrad = bf16_stage_flops(n, w, ke, kv, nt)
    ws_bytes = n * fr.ws_layout(w, ke, kv, nt, "bfloat16")[1] * 2
    w_bytes = b.weights[0].numel() * 2 + sum(
        x.numel() * 4 for x in b.weights[1:])
    in_bytes = n * ((ke + kv) * 2 + (2 * ke + 3 + 4) * 4)
    p_bytes, c_bytes = b.partial.numel() * 4, b.colsums.numel() * 4
    out = {}
    for name, flops, nbytes_, err in (
            ("sweep", f_sweep, in_bytes + w_bytes + ws_bytes + c_bytes,
             sweep_mean),
            ("wgrad", f_wgrad, ws_bytes + p_bytes, wgrad_err)):
        bnd, by = bound_ms(flops, nbytes_)
        out[name] = dict(ms=t[name], plain_ms=t[name + "_plain"],
                         bound_ms=bnd, bound_by=by, library_ms=None,
                         max_abs_err=err, flops=flops, n=n,
                         bound_ops_ms=flops / PEAK_BF16_FLOPS * 1e3,
                         bound_bytes_ms=nbytes_ / PEAK_BYTES * 1e3)
    out["sweep"].update(corr_min=sweep_corr, colsum_rel_err=colsum_err)
    bnd, by = bound_ms(0, p_bytes + b.sum.numel() * 4)
    out["reduce"] = reduction_row(t_reduce, bnd, by, flops=0, n=n,
                                  slots=b.partial.shape[0],
                                  slot_floats=p_floats + c_floats)
    for k in ("sweep", "wgrad"):
        out[k]["library_note"] = ("null: no single PyTorch call computes "
                                  "this stage")
    out["reduce"]["library_note"] = ("torch.sum over the split-K slots; "
                                     "the gradients are views of the sum")
    out["sweep"]["err_is"] = ("max over workspace arrays of mean |diff| / "
                              "mean |plain| (relu flips move single "
                              "elements); corr_min the least correlation")
    out["wgrad"]["err_is"] = ("max over the products' leaves of max |diff| "
                              "/ max |plain|, on the kernel's workspace, "
                              "wgrad and reduce together")
    out["reduce"]["err_is"] = ("max |diff| against the split-K slots "
                               "summed one by one (bitwise)")
    out["workspace"] = {"bytes": b.workspace_bytes(), "ws_bytes": ws_bytes,
                        "split_k_slot_bytes": p_bytes,
                        "column_sum_slot_bytes": c_bytes,
                        "chunk": fr.CHUNK, "chunks": b.n_chunks,
                        "splits": b.splits,
                        "rows_per_point": fr.ws_layout(w, ke, kv, nt,
                                                       "bfloat16")[1],
                        "backward_host_us": backward_host_us}
    log(json.dumps({"fused_radiance_bf16_stages": out}))
    check(sweep_mean < SWEEP_MEAN_REL and sweep_corr > SWEEP_CORR
          and colsum_err < GRAD_REL,
          f"the bf16 sweep against its plain version {sweep_mean} "
          f"{sweep_corr} {colsum_err}")
    check(wgrad_err < WGRAD_REL,
          f"the bf16 weight-gradient products against their plain "
          f"version {wgrad_err}")
    del b
    return out


def kink_free(packed, em, de, vpe, p3, g_e, skip):
    """Indices of the points whose appearance pre-activations all lie at
    least KINK from the ReLU kink in the plain f32 forward: there no f32
    rounding can flip a mask, so the kernel's gradient sums must agree."""
    from psnerf_torch.ops import fused_radiance as fr

    r, cast = fr._ops(packed, "float32")
    c = fr._forward_core(r, cast, em, de, vpe, p3, skip, g_e=g_e)
    margin = torch.stack([z.abs().amin(1) for z in c["za"]], 1).amin(1)
    return torch.nonzero(margin > KINK).flatten()


def phase_radiance_f32():
    """K2/K3 in the f32-operand form (3xTF32) at the default field, at both
    integration batches, against the plain f32 version (TF32 off)."""
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.ops import fused_radiance as fr

    cfg = OccFieldConfig()
    check(cfg.compute_dtype == "float32" and fr.supports(cfg),
          "the default field is the f32 form and the kernels take it")
    field = init_occupancy_field(
        cfg, generator=torch.Generator().manual_seed(SEED), device=DEV)
    rng = np.random.default_rng(SEED + 1)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEV)
    skip, f32 = cfg.skips[0] - 1, "float32"
    finish = lambda o: torch.cat([torch.tanh(o[:, :3]) * 0.5 + 0.5,
                                  torch.sigmoid(-10.0 * o[:, 3:])], 1)
    d64 = lambda x: x.double()
    res = {}
    for n in (N_RAYS * 64, N_RAD):
        p = f(rng.normal(size=(n, 3)) * 0.5)
        v = rng.normal(size=(n, 3))
        rd = f(v / np.linalg.norm(v, axis=-1, keepdims=True))
        with torch.no_grad():
            em, de, vpe, p3 = fr.radiance_inputs(p, rd, cfg)
            packed = fr.pack_radiance(field, cfg, torch.float32)
            out, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip, f32)
            torch.cuda.synchronize()
            ref, g_e_ref = fr.radiance_forward_plain(packed, em, de, vpe, p3,
                                                     skip, f32)
            p64 = {k: d64(x) for k, x in packed.items()}
            ref64, _ = fr.radiance_forward_plain(
                p64, d64(em), d64(de), d64(vpe), d64(p3), skip, f32)
            fin, fin_ref = finish(out), finish(ref)
            err = (fin - fin_ref).abs()
            fwd = {"rgb_alpha_max_abs_err": err.max().item(),
                   "rgb_alpha_max_excess": (err - F32_RGB * fin_ref.abs())
                   .max().item(),
                   "raw_max_abs_err": (out - ref).abs().max().item(),
                   "raw_kernel_vs_f64": (out.double() - ref64).abs().max()
                   .item(),
                   "raw_plain_vs_f64": (ref.double() - ref64).abs().max()
                   .item(),
                   "g_e_rel": ((g_e - g_e_ref).abs().max()
                               / g_e_ref.abs().max()).item()}
            log(json.dumps({"fused_radiance_f32_forward": {"n": n, **fwd}}))
            check(torch.isfinite(out).all() and torch.isfinite(g_e).all(),
                  "K2 f32 finite")
            # rtol = atol = 1e-5, as np.testing.assert_allclose reads them
            check(fwd["rgb_alpha_max_excess"] <= F32_RGB, f"K2 f32 {fwd}")
            del ref64
            keep = kink_free(packed, em, de, vpe, p3, g_e_ref, skip)
            sub = lambda x: x[keep].contiguous()
            bwd = {"kink_free_points": int(keep.numel())}
            g_out = f(rng.uniform(0.5, 1.5, (n, 4)))
            for name, g in (("positive", g_out),
                            ("random_sign", f(rng.normal(size=(n, 4))))):
                got = fr.radiance_backward(packed, em, de, vpe, p3, g_e_ref,
                                           g, skip, f32)
                torch.cuda.synchronize()
                want = fr.radiance_backward_plain(packed, em, de, vpe, p3,
                                                  g_e_ref, g, skip, f32)
                w64 = fr.radiance_backward_plain(
                    p64, d64(em), d64(de), d64(vpe), d64(p3), d64(g_e_ref),
                    d64(g), skip, f32)
                e_all = leaf_errors(got, want)
                e_k = leaf_errors(
                    fr.radiance_backward(packed, sub(em), sub(de), sub(vpe),
                                         sub(p3), sub(g_e_ref), sub(g), skip,
                                         f32),
                    fr.radiance_backward_plain(packed, sub(em), sub(de),
                                               sub(vpe), sub(p3),
                                               sub(g_e_ref), sub(g), skip,
                                               f32))
                rel64 = lambda a: max(
                    ((a[k].double() - w64[k]).abs().max()
                     / (w64[k].abs().max() + 1e-30)).item() for k in w64)
                bwd[name] = {
                    "max_rel_err": max(e["rel"] for e in e_all.values()),
                    "max_abs_err": max(e["abs"] for e in e_all.values()),
                    "worst_leaf": max(e_all, key=lambda k: e_all[k]["rel"]),
                    "kink_free_max_rel_err": max(e["rel"]
                                                 for e in e_k.values()),
                    "kernel_vs_f64_rel": rel64(got),
                    "plain_vs_f64_rel": rel64(want)}
                for k, e in e_all.items():
                    check(all(np.isfinite(list(e.values()))), f"K3 f32 {k}")
                check(bwd[name]["kink_free_max_rel_err"] < F32_GRAD_REL,
                      f"K3 f32 {name} {bwd[name]}")
                if name == "positive":
                    check(bwd[name]["max_rel_err"] < F32_GRAD_REL,
                          f"K3 f32 {name} {bwd[name]}")
                del got, want, w64
            # the f32 backward sums in fixed order: bit for bit run to run
            rerun = [fr.radiance_backward(packed, em, de, vpe, p3, g_e_ref,
                                          g_out, skip, f32) for _ in range(2)]
            bwd["rerun_bitwise_equal"] = all(
                torch.equal(rerun[0][k], rerun[1][k]) for k in rerun[0])
            del rerun
            log(json.dumps({"fused_radiance_f32_backward": {"n": n, **bwd}}))
            check(bwd["rerun_bitwise_equal"],
                  "K3 f32: two launches agree bit for bit")
            del p64

        k2, k3 = time_radiance(field, cfg, p, rd, packed,
                               (em, de, vpe, p3), g_e_ref, g_out, skip, f32)
        extra = dict(bound_peak="3xTF32: three tf32 passes at 495 TFLOP/s")
        for k in (k2, k3):
            k.update(extra, bound_tf32_single_ms=k["flops"] / PEAK_TF32_FLOPS
                     * 1e3, bound_ffma_ms=k["flops"] / PEAK_F32_FLOPS * 1e3)
        k2.update(max_abs_err=fwd["rgb_alpha_max_abs_err"])
        k3.update(max_abs_err=bwd["positive"]["max_abs_err"],
                  max_rel_err=bwd["positive"]["max_rel_err"],
                  random_sign=bwd["random_sign"],
                  rerun_bitwise_equal=bwd["rerun_bitwise_equal"])
        if n == N_RAD:
            stages = time_f32_stages(packed, (em, de, vpe, p3), g_e_ref,
                                     g_out, skip)
            k3["stages_ms"] = {k: v["ms"] for k, v in stages.items()
                               if "ms" in v}
            k3["host_us"] = stages["workspace"]["backward_host_us"]
        res[n] = (k2, k3)
        log(json.dumps({"fused_radiance_f32_ms": {"forward": k2,
                                                  "backward": k3}}))
        del p, rd, em, de, vpe, p3, packed, out, g_e, ref, g_e_ref
    k2, k3 = res[N_RAD]
    small = {"n": N_RAYS * 64,
             **{f"{which}_{key}": res[N_RAYS * 64][i][key]
                for i, which in enumerate(("fwd", "bwd"))
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "max_abs_err")}}
    return dict(k2, at_64_samples=small), k3, stages


def f32_stage_flops(n, w, ke, kv, nt):
    """Tensor-core FLOPs of one tf32 pass of the f32 backward's stages: the
    sweep's activation products (recompute nt + 5, appearance backward 5,
    tangent nt, doubled reverse sweep 2 nt, W x W each; 4 ke + kv narrow)
    and the weight-gradient products (the trunk's two segments 2 nt, w8f,
    wf and wa 5, W x W each; the app0 block's kv + 6 extra rows, w0 and
    wskip's 4 ke, the rgb head's 8 columns)."""
    sweep = n * 2 * w * ((4 * nt + 10) * w + 4 * ke + kv)
    wgrad = n * 2 * w * ((2 * nt + 5) * w + kv + 6 + 4 * ke + 8)
    return sweep, wgrad


def time_f32_stages(packed, inputs, g_e, g_out, skip):
    """The f32 backward kernel by kernel (prologue, sweeps, weight-gradient
    passes, reduce: F32Backward), each held against its plain version on
    the same inputs and timed in turns with it (plain, kernel, kernel,
    plain): split_weights_plain; radiance_sweep_plain per chunk (held on
    the points clear of the relu kinks, where no f32 rounding flips a
    mask); weight_grads_plain on the kernel's own workspace, summed over
    the chunks (held for wgrad and reduce together); for the reduce, the
    slots summed in order one by one. Its library_ms is torch.sum over the
    slots (the leaves are views of that sum); no single PyTorch call
    computes any of the other three, so theirs is null."""
    from psnerf_torch.ops import fused_radiance as fr

    em, de, vpe, p3 = inputs
    n = em.shape[0]
    b = fr.F32Backward(packed, em, de, vpe, p3, g_e, g_out, skip)
    w, ke, kv, nt = b.dims
    chunks = range(b.n_chunks)
    rows = [slice(c * fr.CHUNK, c * fr.CHUNK + b._chunk(c)[1])
            for c in chunks]
    clear = torch.zeros(n, dtype=torch.bool, device=em.device)
    clear[kink_free(packed, em, de, vpe, p3, g_e, skip)] = True
    with torch.no_grad():
        b.split()
        torch.cuda.synchronize()
        split_err = (b.frags != fr.split_weights_plain(packed)).sum().item()
        sweep_err, ws_kernel = 0.0, []
        for c in chunks:
            b.sweep(c)
            b.wgrad(c)
            got = b.workspace(c)
            r = rows[c]
            want = fr.radiance_sweep_plain(packed, em[r], de[r], vpe[r],
                                           p3[r], g_e[r], g_out[r], skip,
                                           "float32")
            m = clear[r]
            sweep_err = max(sweep_err, max(
                ((got[k][m] - x[m]).abs().max() / (x.abs().max() + 1e-30))
                .item() for k, x in want.items()))
            ws_kernel.append(got)
            del want
        grads = b.reduce()
        slots = b.partial
        torch.cuda.synchronize()
        # the kernel's order: slot by slot from zero
        reduce_plain = lambda: fr.slot_sum_plain(slots)
        sum_want = reduce_plain()
        check(torch.equal(b.sum, sum_want),
              "the f32 reduce against its plain version: "
              f"{(b.sum - sum_want).abs().max().item()}")
        wg_plain = None
        for ws in ws_kernel:
            d = fr.weight_grads_plain(ws, skip, "float32")
            wg_plain = d if wg_plain is None else {
                k: wg_plain[k] + d[k] for k in d}
        wgrad_err = max(((grads[k] - x).abs().max() / (x.abs().max() + 1e-30))
                        .item() for k, x in wg_plain.items())
        t = in_turns(
            {"split": b.split, "split_plain": lambda: fr.split_weights_plain(
                packed),
             "sweep": lambda: [b.sweep(c) for c in chunks],
             "sweep_plain": lambda: [fr.radiance_sweep_plain(
                 packed, em[r], de[r], vpe[r], p3[r], g_e[r], g_out[r],
                 skip, "float32") for r in rows],
             "wgrad": lambda: [b.wgrad(c) for c in chunks],
             "wgrad_plain": lambda: [fr.weight_grads_plain(ws, skip,
                                                           "float32")
                                     for ws in ws_kernel]},
            {"split": 20, "split_plain": 3, "sweep": 3, "sweep_plain": 2,
             "wgrad": 3, "wgrad_plain": 2},
            ["split_plain", "split", "split", "split_plain",
             "sweep_plain", "sweep", "sweep", "sweep_plain",
             "wgrad_plain", "wgrad", "wgrad", "wgrad_plain"])
        # (the wgrad turns above recomputed every chunk's slots from the
        # last chunk's workspace: the check below takes them as they are)
        t_reduce = time_slot_reduce(lambda: (b.reduce(), b.sum)[1],
                                    reduce_plain, lambda: torch.sum(slots, 0))
        # host µs of one backward as radiance_backward runs it: a new
        # F32Backward (its buffers), then its launches
        one_backward = lambda: fr.F32Backward(packed, em, de, vpe, p3, g_e,
                                              g_out, skip).run()
        one_backward()                 # the allocator keeps its buffers
        backward_host_us = host_us(one_backward, 20, batch=1)
    del ws_kernel
    f_sweep, f_wgrad = f32_stage_flops(n, w, ke, kv, nt)
    ws_bytes = n * fr.ws_layout(w, ke, kv, nt)[1] * 4
    w_bytes = sum(x.numel() * 4 for x in packed.values())
    in_bytes = n * (3 * ke + kv + 3 + 4) * 4
    slot_bytes = b.partial.numel() * 4
    out = {}
    for name, flops, nbytes_, err in (
            ("split", 0, w_bytes + b.frags.numel() * 4, float(split_err)),
            ("sweep", 3 * f_sweep, in_bytes + w_bytes + ws_bytes, sweep_err),
            ("wgrad", 3 * f_wgrad, ws_bytes + slot_bytes, wgrad_err)):
        bnd, by = bound_ms(flops, nbytes_, PEAK_TF32_FLOPS)
        out[name] = dict(ms=t[name], plain_ms=t[name + "_plain"],
                         bound_ms=bnd, bound_by=by, library_ms=None,
                         max_abs_err=err, flops=flops, n=n)
    bnd, by = bound_ms(0, slot_bytes + b.sum.numel() * 4, PEAK_TF32_FLOPS)
    out["reduce"] = reduction_row(t_reduce, bnd, by, flops=0, n=n,
                                  slots=b.partial.shape[0],
                                  slot_floats=b.slot_floats)
    for k in ("split", "sweep", "wgrad"):
        out[k]["library_note"] = ("null: no single PyTorch call computes "
                                  "this stage")
    out["reduce"]["library_note"] = ("torch.sum over the split-K slots; "
                                     "the gradients are views of the sum")
    out["split"]["err_is"] = "words differing from split_weights_plain"
    out["sweep"]["err_is"] = ("max over arrays of max |diff| / max |plain|, "
                              "on the points clear of the relu kinks")
    out["reduce"]["err_is"] = ("max |diff| against the slots summed one by "
                               "one (bitwise)")
    out["wgrad"]["err_is"] = ("max over leaves of max |diff| / max |plain|, "
                              "wgrad and reduce together")
    out["workspace"] = {"bytes": b.workspace_bytes(), "ws_bytes": ws_bytes,
                        "slot_bytes": slot_bytes, "chunk": fr.CHUNK,
                        "chunks": b.n_chunks, "splits": b.splits,
                        "rows_per_point": fr.ws_layout(w, ke, kv, nt)[1],
                        "backward_host_us": backward_host_us}
    log(json.dumps({"fused_radiance_f32_stages": out}))
    check(split_err == 0, "the prologue's split equals split_weights_plain")
    check(sweep_err < F32_GRAD_REL and wgrad_err < F32_GRAD_REL,
          f"f32 stages against their plain versions {sweep_err} {wgrad_err}")
    del b
    return out


def stage1_step_ms(runner, use_outside, reps=8, warmup=2, step=None):
    """Median ms of one training step (batch and noise draws included),
    host clock around synchronize, after warm-up; the runner's field keeps
    training, its `it` stays. step: another step function of the same
    field (another route), else the runner's own."""
    step = step or runner.step_fn
    times = []
    for _ in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, noise = runner.sample(use_outside)
        step(runner.field, runner.opt_state, batch, runner.it, noise,
             use_outside=use_outside)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[warmup:])), times[warmup:]


@torch.no_grad()
def march_hits(runner):
    """The kernel march on one sampled batch: the share of rays it hits,
    the scene's mask coverage of the same pixels, and their agreement."""
    from psnerf_torch.ops.fused_occ import make_fused_occ_fn
    from psnerf_torch.render.unisurf import _march_and_surface

    cfg = runner.cfg
    batch, noise = runner.sample(False)
    *_, smask = _march_and_surface(
        runner.field, cfg.field, cfg.render, batch["pixels"],
        batch["camera_mat"], batch["world_mat"],
        cfg.render.ray_marching_steps, phase=noise["phase"],
        occ_fn=make_fused_occ_fn(runner.field, cfg.field))
    gt = batch["mask_gt"] > 0.5
    return {"hit_share": smask.float().mean().item(),
            "mask_coverage": gt.float().mean().item(),
            "agreement": (smask == gt).float().mean().item()}


def read_losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def stage1_config(scene, compute):
    """The bear field at the operand form `compute` (the default
    OccFieldConfig() is float32) and counts; the scene's own distances
    (camera at 3, objects inside radius 1.2)."""
    from psnerf_torch.config import Stage1Config
    from psnerf_torch.fields.occupancy import OccFieldConfig
    from psnerf_torch.render.unisurf import UnisurfConfig
    from psnerf_torch.train.stage1 import Stage1TrainConfig

    field = (OccFieldConfig() if compute == "float32"
             else OccFieldConfig(compute_dtype=compute))
    return Stage1Config(
        field=field,
        render=UnisurfConfig(near=1.2, far=5.0, radius=1.2,
                             interval_start=0.6, interval_end=0.05,
                             ray_marching_steps=MARCH_STEPS),
        train=Stage1TrainConfig(n_training_points=N_RAYS), data_dir=scene,
        inten_normalize=None, checkpoint_every=10 ** 9, backup_every=10 ** 9)


def phase_stage1_main(scene, compute, steps, steps96, vis_every=0):
    """Stage1Runner.train at the field of operand form `compute`: `steps`
    steps at 64 samples, then `steps96` at 96 after a resume at it=6000.
    Returns (launches, end-to-end numbers, the resumed runner)."""
    import copy

    from psnerf_torch.data.scene import imread
    from psnerf_torch.ops import adam
    from psnerf_torch.ops import fused_occ as fo
    from psnerf_torch.ops import fused_radiance as fr
    from psnerf_torch.render.unisurf import _march_and_surface
    from psnerf_torch.runners.stage1 import Stage1Runner
    from psnerf_torch.train.optim import multistep_lr
    from psnerf_torch.train.stage1 import make_stage1_train_step

    cfg = stage1_config(scene, compute)
    other = "bfloat16" if compute == "float32" else "float32"
    wd = os.path.join(WORK, f"stage1_{compute}")
    runner = Stage1Runner(cfg, wd, seed=SEED, resume=False, device=DEV)
    check(runner.use_fused_occ and runner.use_fused_radiance,
          f"the runner's defaults take both kernel families on the card "
          f"({compute} field)")
    # the march on the initial sphere hits about the scene's silhouette
    hit_init = march_hits(runner)
    check(hit_init["hit_share"] > 0.05
          and abs(hit_init["hit_share"] - hit_init["mask_coverage"]) < 0.15,
          f"march on the initial field: {hit_init}")
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after
    fo.fused_occ_logit.launches = 0
    fr.reset_launches()
    adam.fused_adam.launches = 0
    t0 = time.perf_counter()
    runner.train(steps, log_every=steps // 2, vis_every=vis_every)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"fused_adam": adam.fused_adam.launches,
                "fused_occ_logit": fo.fused_occ_logit.launches,
                "fused_radiance_fwd": dict(fr.radiance_forward.launches),
                "fused_radiance_bwd": dict(fr.radiance_backward.launches),
                "fused_radiance_f32": dict(fr.f32_launches),
                "fused_radiance_bf16": dict(fr.bf16_launches),
                "fused_radiance_slot_sum": fr.slot_sum.launches}
    if vis_every:
        # the strip's render_view of 2 views: a march (proposal pass and 8
        # secant passes) per pixel tile
        n_tiles = -(-HW[0] * HW[1] // TILE)
        launches["fused_occ_logit_strip"] = 2 * 9 * n_tiles * (
            (steps - 1) // vis_every)
    log(json.dumps({f"stage1_train_{compute}": {
        "steps": steps, "wall_s": train_s, "vis_every": vis_every,
        "launches": launches}}))
    check(launches["fused_occ_logit"] >= 9 * steps, f"launches {launches}")
    # one Adam call of the field's 42 leaves a step, two launches
    check(launches["fused_adam"] == 2 * steps, f"Adam launches {launches}")
    for k in ("fused_radiance_fwd", "fused_radiance_bwd"):
        check(launches[k][compute] >= steps and launches[k][other] == 0,
              f"{k}: {compute} form launched, {other} form not: {launches}")
    f32k = launches["fused_radiance_f32"]
    if compute == "float32":
        # every kernel of the f32 form: a prologue per forward and per
        # backward, a sweep and a weight-gradient pass per chunk
        check(f32k["fwd"] >= steps and f32k["split"] >= 2 * steps
              and f32k["sweep"] >= steps and f32k["wgrad"] >= steps
              and f32k["reduce"] >= steps, f"f32 kernels {f32k}")
        check(not any(launches["fused_radiance_bf16"].values())
              and launches["fused_radiance_slot_sum"] == 0,
              f"bf16 kernels at the f32 field {launches}")
    else:
        check(not any(f32k.values()), f"f32 kernels at the bf16 field {f32k}")
        # every kernel of the bf16 form: the forward per forward; a sweep
        # and a weight-gradient pass per chunk of a backward; one fixed-
        # order sum per backward
        bf16k = launches["fused_radiance_bf16"]
        n_bwd = launches["fused_radiance_bwd"]["bfloat16"]
        check(bf16k["fwd"] == launches["fused_radiance_fwd"]["bfloat16"]
              and bf16k["sweep"] == bf16k["wgrad"] >= n_bwd
              and launches["fused_radiance_slot_sum"] == n_bwd,
              f"bf16 kernels per forward and backward {launches}")
    recs = read_losses(wd)
    check(runner.it == steps
          and [r["it"] for r in recs] == [steps // 2, steps],
          f"it {runner.it}, logs {recs}")
    check(all(np.isfinite(r["loss"]) for r in recs), f"losses {recs}")
    strip_shape = None
    if vis_every:
        strip = imread(os.path.join(wd, "vis", f"it_{vis_every}.png"))
        strip_shape = list(strip.shape)
        # two training views of 8 panels (gt, render, normal, SDPS normal,
        # error, mask, acc, phong)
        check(strip.shape == (2 * HW[0], 8 * HW[1], 3),
              f"strip {strip.shape}")
    ms64, times64 = stage1_step_ms(runner, use_outside=False)

    hit_trained = march_hits(runner)

    # ---- a checkpoint at it=6000, resumed: steps96 steps at 96 samples
    ck = runner.save(6000)
    r2 = Stage1Runner(cfg, wd, seed=SEED + 1, device=DEV)
    check(r2.it == 6000, f"resumed at it={r2.it}")
    with np.load(ck) as saved:
        np.testing.assert_array_equal(
            r2.field.geo[0].v.detach().cpu().numpy(), saved["params/geo/0/v"])
    fr.reset_launches()
    r2.train(6000 + steps96, log_every=steps96, vis_every=0)
    torch.cuda.synchronize()
    recs2 = read_losses(wd)[len(recs):]
    check(r2.it == 6000 + steps96
          and [r["it"] for r in recs2] == [6000 + steps96]
          and np.isfinite(recs2[0]["loss"]), f"resumed run {recs2}")
    check(fr.radiance_forward.launches[compute] >= steps96
          and fr.radiance_backward.launches[compute] >= steps96
          and fr.radiance_forward.launches[other] == 0,
          f"launches at 96 samples {fr.radiance_forward.launches}")
    ms96, times96 = stage1_step_ms(r2, use_outside=True)
    batch, noise = r2.sample(True)
    prof = profile_device(lambda: r2.step_fn(
        r2.field, r2.opt_state, batch, r2.it, noise, use_outside=True))
    # the same step with the radiance kernels off (K1 on): what the
    # fused_radiance pair buys end to end
    _, step_off = make_stage1_train_step(cfg.field, cfg.render, r2.tcfg,
                                         True, False)
    ms96_off, _ = stage1_step_ms(r2, use_outside=True, step=step_off)

    # ---- the kernel route against the plain route: one step from
    # identical params, batch and noise
    batch, noise = r2.sample(True)
    fk, fp = copy.deepcopy(r2.field), copy.deepcopy(r2.field)
    # bf16: the plain route has neither kernel; f32: K1 runs in both routes
    # and only K2/K3 differ
    occ_plain = compute == "float32"
    init, step_k = make_stage1_train_step(cfg.field, cfg.render, r2.tcfg,
                                          True, True)
    _, step_p = make_stage1_train_step(cfg.field, cfg.render, r2.tcfg,
                                       occ_plain, False)
    with torch.no_grad():
        marches = [_march_and_surface(
            fld, cfg.field, cfg.render, batch["pixels"], batch["camera_mat"],
            batch["world_mat"], cfg.render.ray_marching_steps,
            phase=noise["phase"], occ_fn=fn)
            for fld, fn in ((fk, fo.make_fused_occ_fn(fk, cfg.field)),
                            (fp, fo.make_fused_occ_fn(fp, cfg.field)
                             if occ_plain else None))]
    (_, _, dk, _, mk), (_, _, dp, _, mp) = marches
    both = mk & mp
    route = {"plain_route_fused_occ": occ_plain,
             "mask_agreement": (mk == mp).float().mean().item(),
             "depth_max_abs_diff": ((dk - dp).abs()[both].max().item()
                                    if both.any() else 0.0),
             "depth_median_abs_diff": ((dk - dp).abs()[both].median().item()
                                       if both.any() else 0.0)}
    tk = step_k(fk, init(fk), batch, r2.it, noise, use_outside=True)
    tp = step_p(fp, init(fp), batch, r2.it, noise, use_outside=True)
    torch.cuda.synchronize()
    lr = multistep_lr(r2.tcfg.learning_rate, r2.tcfg.milestone_iters,
                      r2.tcfg.gamma, r2.it)
    route["lr"] = lr
    route["loss_kernel"] = tk["loss"].item()
    route["loss_plain"] = tp["loss"].item()
    route["loss_abs_diff"] = abs(route["loss_kernel"] - route["loss_plain"])
    diffs = [(a - b).abs() for a, b in zip(fk.parameters(), fp.parameters())]
    route["param_max_abs_diff"] = max(d.max().item() for d in diffs)
    route["params_over_1e-6"] = int(sum((d > 1e-6).sum().item()
                                        for d in diffs))
    route["params"] = int(sum(d.numel() for d in diffs))
    log(json.dumps({f"stage1_kernel_vs_plain_route_{compute}": route}))
    check(route["mask_agreement"] >= 0.995, f"route {route}")
    if compute == "float32":
        # Adam's first step moves a param by +-lr: a flipped gradient sign
        # costs 2 lr
        check(route["loss_abs_diff"] < 1e-5, f"route {route}")
        check(route["param_max_abs_diff"] <= 2 * lr * (1 + 1e-4),
              f"route {route}")
    else:
        check(route["loss_abs_diff"] < 2e-3, f"route {route}")
        check(route["param_max_abs_diff"] < 5e-4, f"route {route}")

    e2e = {"ms_per_step_64": ms64, "ms_per_step_96": ms96,
           "ms_per_step_96_radiance_plain": ms96_off,
           "step_ms_64": times64, "step_ms_96": times96,
           "train_wall_s": train_s, "steps": [steps, steps96],
           "strip_shape": strip_shape, "march_init": hit_init,
           "march_after_training": hit_trained,
           "losses": [r["loss"] for r in recs + recs2],
           "step96_profiled": prof, "route": route}
    log(json.dumps({f"stage1_main_path_{compute}": e2e}))
    return launches, e2e, r2


def phase_stage1_export(runner):
    """Eval and the faithful export of the trained default field, with
    fused_occ's launches counted; a self-shadow check; the kernel route's
    export of one view toward 4 lights against the plain route's."""
    from psnerf_torch.data.stage1 import load_stage1_data
    from psnerf_torch.ops import fused_occ as fo
    from psnerf_torch.render.unisurf import render_shape_extract
    from psnerf_torch.runners.stage1 import _row_major_pixels, world_lights

    cfg = runner.cfg
    test = load_stage1_data(runner.scene, "test", None, None, None, False,
                            True, normal_loss=True, mask_valid=False,
                            device=DEV)
    # ---- render_view of the test view, then eval_views("test")
    fo.fused_occ_logit.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = runner.render_view(0, TILE, test)
    render_s = time.perf_counter() - t0
    view_launches = fo.fused_occ_logit.launches
    check(r["rgb"].shape == (*HW, 3) and r["mask"].shape == HW
          and all(np.isfinite(v).all() for v in r.values()),
          "render_view shapes, finite")
    coverage = float(r["mask"].mean())
    gt_mask = test["masks"][0].cpu().numpy() > 0.5
    check(0.02 < coverage < 0.9, f"render_view mask coverage {coverage}")
    t0 = time.perf_counter()
    out_eval = os.path.join(WORK, "stage1_eval")
    metrics = runner.eval_views(out_eval, "test", TILE)
    eval_s = time.perf_counter() - t0
    name = f"view_{int(test['views'][0]) + 1:02d}"
    check(len(metrics) == 1 and np.isfinite(metrics[0]["psnr"]),
          f"eval_views {metrics}")
    for sub in ("rgb", "normal", "mask", "acc", "phong"):
        check(os.path.exists(os.path.join(out_eval, sub, name + ".png")),
              f"eval_views {sub} png")
    check(os.path.exists(os.path.join(out_eval, "normal", name + ".npy")),
          "eval_views normal npy")
    ev = {"render_view_s": render_s, "render_view_k1_launches": view_launches,
          "mask_coverage": coverage,
          "mask_vs_scene_silhouette": float((r["mask"] == gt_mask).mean()),
          "eval_views_s": eval_s, "psnr": metrics[0]["psnr"]}
    log(json.dumps({"stage1_eval": ev}))

    # ---- the faithful shape export of all views, 96 lights + 32 vis_plus
    out = os.path.join(WORK, "stage1_export")
    fo.fused_occ_logit.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timings = runner.shape_extract(out, visibility=True, vis_plus=True,
                                   vis_plus_num=32, tile=TILE)
    export_s = time.perf_counter() - t0
    k1 = fo.fused_occ_logit.launches
    views = load_stage1_data(runner.scene, "all", None, None, None, False,
                             True, normal_loss=False, mask_valid=False,
                             device="cpu")["views"]
    lights = world_lights(runner.scene, cfg, views)
    n_tiles = (HW[0] * HW[1] + TILE - 1) // TILE
    surf_tiles, pairs = 0, {"lit": [], "shadow": []}
    for i, vi in enumerate(views):
        nm = f"view_{vi + 1:02d}"
        load = lambda sub: np.load(os.path.join(out, sub, nm + ".npy"))
        mask, normal, vis, vp = (load("mask"), load("normal"),
                                 load("visibility"), load("vis_plus"))
        check(mask.shape == HW and normal.shape == (*HW, 3)
              and vis.shape == (N_LIGHTS, *HW) and vp.shape == (32, *HW),
              f"export shapes {nm}")
        check(all(np.isfinite(a).all() for a in (normal, vis, vp)),
              f"export finite {nm}")
        check((vis[:, ~mask] == 1.0).all() and (vp[:, ~mask] == 1.0).all(),
              f"visibility 1 off the surface {nm}")
        n_surf = int(mask.sum())
        check(n_surf > 0, f"surface pixels {nm}")
        surf_tiles += -(-n_surf // TILE)
        nl = lights[i] @ normal[mask].T                          # [L, S]
        vs = vis[:, mask]
        pairs["lit"].append(vs[nl > 0.2])
        pairs["shadow"].append(vs[nl < -0.2])
    with open(os.path.join(out, "vis_plus", "light_dir.json")) as fh:
        check(len(json.load(fh)) == len(views), "vis_plus light_dir.json")
    # a march tile is one proposal pass and 8 secant passes; each light
    # of each surface tile is one pass; the warm-up is one tile and one
    # light
    march_launches = len(views) * n_tiles * 9
    vis_launches = (N_LIGHTS + 32) * surf_tiles
    lit, shadow = (np.concatenate(pairs[k]) for k in ("lit", "shadow"))
    # The field after 30 steps is close to its geometric-init sphere, whose
    # occupancy falls off over ~0.3 units (alpha 0.29 at 0.1 outside its
    # surface), so a lit point's light ray still composites much of that
    # occupancy and a quarter of the lit pairs stay below 0.5. So 95% of
    # the shadowed pairs must lie below 0.5, and for the lit side the check
    # is the ordering (95% of the lit pairs above the shadowed median, 95%
    # of the shadowed pairs below the lit median); the lit share above 0.5
    # is reported beside it.
    shadow_check = {
        "lit_pairs": int(lit.size), "shadow_pairs": int(shadow.size),
        "lit_q05": float(np.quantile(lit, 0.05)),
        "lit_median": float(np.median(lit)),
        "shadow_median": float(np.median(shadow)),
        "shadow_q95": float(np.quantile(shadow, 0.95)),
        "lit_share_above_half": float((lit > 0.5).mean()),
        "shadow_share_below_half": float((shadow < 0.5).mean())}
    export = {"wall_s": export_s, "timings": timings, "k1_launches": k1,
              "k1_launches_expected": march_launches + vis_launches + 10,
              "k1_launches_march": march_launches,
              "k1_launches_visibility": vis_launches,
              "surface_tiles": surf_tiles, "views": len(views),
              "self_shadow": shadow_check}
    log(json.dumps({"stage1_export": export}))
    check(k1 >= N_LIGHTS * surf_tiles + march_launches,
          f"K1 launches of the export {k1}, surface tiles {surf_tiles}")
    check(lit.size > 1000 and shadow.size > 1000, f"pairs {shadow_check}")
    check(shadow_check["shadow_share_below_half"] >= 0.95
          and shadow_check["shadow_q95"] < shadow_check["lit_median"]
          and shadow_check["lit_q05"] > shadow_check["shadow_median"],
          f"self-shadow {shadow_check}")

    # ---- one view toward 4 lights: the kernel route against the plain
    with torch.no_grad():
        pix = _row_major_pixels(*HW, runner.device)
        data = load_stage1_data(runner.scene, "all", None, None, None, False,
                                True, normal_loss=False, mask_valid=False,
                                device=DEV)
        ldir = torch.as_tensor(lights[0][:4], device=DEV)
        occ_fn = fo.make_fused_occ_fn(runner.field, cfg.field)
        got = {}
        for name_, fn in (("kernel", occ_fn), ("plain", None)):
            outs = [render_shape_extract(
                runner.field, cfg.field, cfg.render, pix[s:s + TILE],
                data["K"], data["poses"][0], light_dir=ldir, occ_fn=fn)
                for s in range(0, pix.shape[0], TILE)]
            got[name_] = (torch.cat([o["mask"] for o in outs]),
                          torch.cat([o["visibility"] for o in outs], 1))
        (mk, vk), (mp, vp_) = got["kernel"], got["plain"]
        common = mk & mp
        rc = {"mask_agreement": (mk == mp).float().mean().item(),
              "vis_mean_abs_diff_common": (vk - vp_).abs()[:, common].mean()
              .item(),
              "vis_max_abs_diff_common": (vk - vp_).abs()[:, common].max()
              .item()}
    log(json.dumps({"stage1_export_kernel_vs_plain_route": rc}))
    check(rc["mask_agreement"] >= 0.995
          and rc["vis_mean_abs_diff_common"] <= 1e-2, f"export route {rc}")
    export["route"] = rc
    return {"eval": ev, "export": export}


def k1_at_points(runner, pts, n_valid, card, sass):
    """K1 on the points `pts` [N, 3] (the first n_valid of them real, the
    rest padding) of the runner's field, held against its plain version at
    K1's bars (logits < OCC_MAX abs, corr > OCC_CORR over the real points)
    and timed in turns with it and the bf16 matmul chain, against its bound
    (the larger of the tensor-core FLOPs or bytes and the softplus
    epilogue's MUFU and FP32 SASS counts)."""
    from psnerf_torch.ops import fused_occ as fo

    cfg = runner.cfg
    n = pts.shape[0]
    with torch.no_grad():
        ops = fo.pack_occ_operands(runner.field, cfg.field)
        ops["slabs"] = fo.occ_slabs(ops)
        p = torch.from_numpy(pts).to(DEV)
        em = fo.occ_embed(p, ops)
        got = fo.fused_occ_logit(runner.field, p, cfg.field)
        torch.cuda.synchronize()
        ref = fo._logit_plain(ops, em)
        err = (got - ref).abs()
        m1 = {"n": n, "max_abs_err": err.max().item(),
              "mean_abs_err": err.mean().item(),
              "corr": float(np.corrcoef(got[:n_valid].cpu().numpy(),
                                        ref[:n_valid].cpu().numpy())[0, 1])}
        check(torch.isfinite(got).all()
              and m1["max_abs_err"] < OCC_MAX and m1["corr"] > OCC_CORR,
              f"K1 at {n} points {m1}")
        buf = torch.empty((n,), dtype=torch.float32, device=DEV)
        t = in_turns({"plain": lambda: fo._logit_plain(ops, em),
                      "kernel": lambda: fo._launch(ops, em, buf),
                      "library": lambda: library_occ(ops, em)},
                     {"plain": 2, "kernel": 10, "library": 3},
                     ["plain", "kernel", "library", "library", "kernel",
                      "plain"])
        flops = occ_flops(n, ops)
        b_tc, by = bound_ms(flops, nbytes(em, ops["slabs"], *(ops[k] for k in (
            "b0", "trunk_b", "w8", "b8"))) + n * 4)
        epi = occ_epilogue_ms(n, ops, sass, card)
        b = max(b_tc, epi["fp32_ms"], epi["mufu_ms"])
        return dict(m1, ms=t["kernel"], plain_ms=t["plain"],
                    library_ms=t["library"], bound_ms=b,
                    bound_by=by if b == b_tc else "operations", flops=flops,
                    bound_parts={"tensor_or_bytes_ms": b_tc,
                                 "tensor_or_bytes_by": by, **epi})


def phase_mesh(runner, card, sass):
    """Mesh extraction of the trained default field (phase 9's runner),
    with fused_occ's launches set to 0 just before and read just after:
    extract_mesh_both at the config's resolution (64, 3 upsampling steps:
    a 513^3 grid) with silhouette carving, both PLYs reloaded; one MISE
    round's K1 batch (2^20 points, padded as the extraction pads it) held
    against the plain version and timed against its bound; the K1 route's
    mesh against the plain route's at 32 / 2 by Chamfer; one refine_mesh
    of REFINE_STEPS steps."""
    from psnerf_torch.fields.occupancy import occ_alpha
    from psnerf_torch.mesh.chamfer import chamfer_distance
    from psnerf_torch.mesh.meshio import load_ply
    from psnerf_torch.mesh.native import MISE
    from psnerf_torch.mesh.refine import refine_mesh
    from psnerf_torch.ops import fused_occ as fo

    cfg = runner.cfg
    check(runner.use_fused_occ, "the runner takes fused_occ on the card")
    out = os.path.join(WORK, "mesh")
    os.makedirs(out)
    paths = [os.path.join(out, f) for f in ("raw.ply", "exterior.ply")]
    box = 2.4                       # the extraction's box (padding 0.4)

    # ---- the main path: counts set to 0 just before, read just after
    timings = {}
    fo.fused_occ_logit.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meshes = runner.extract_mesh_both(*paths, mask_carve=True,
                                      timings=timings)
    wall = time.perf_counter() - t0
    k1 = fo.fused_occ_logit.launches
    res = cfg.extraction_resolution * 2 ** cfg.extraction_upsampling
    for (v, f), path in zip(meshes, paths):
        check(len(f) > 1000 and np.isfinite(v).all()
              and np.abs(v).max() <= box / 2, f"mesh {path}: {v.shape}")
        lv, lf = load_ply(path)
        check(np.array_equal(lf, f) and np.array_equal(lv, v.astype(
            np.float64)), f"{path} reloads as written")
    mesh = {"wall_s": wall, "k1_launches": k1, "grid": res + 1,
            "timings": timings,
            "faces": [len(f) for _, f in meshes],
            "vertices": [len(v) for v, _ in meshes]}
    log(json.dumps({"mesh_extract": mesh}))
    check(k1 >= -(-timings["points"] // N_MISE) and k1 > 0,
          f"K1 launches of the extraction {k1}, points {timings['points']}")

    # ---- one MISE round's batch: K1 against its plain version, timed
    mise = MISE(cfg.extraction_resolution, cfg.extraction_upsampling, 0.0)
    q = mise.query()
    pts = np.zeros((N_MISE, 3), np.float32)
    pts[:len(q)] = box * (q.astype(np.float32) / res - 0.5)
    k1_row = dict(k1_at_points(runner, pts, len(q), card, sass),
                  queries=len(q))
    log(json.dumps({"fused_occ_logit_mise_batch": k1_row}))

    # ---- the K1 route's mesh against the plain route's, by Chamfer
    r0, up = MESH_ROUTE_RES
    route = {}
    for name in ("kernel", "plain"):
        runner.use_fused_occ = name == "kernel"
        try:
            route[name] = runner.extract_mesh_to(
                os.path.join(out, f"route_{name}.ply"), resolution0=r0,
                upsampling=up)
        finally:
            runner.use_fused_occ = True
    voxel = box / (r0 * 2 ** up)
    cd = chamfer_distance(*route["kernel"], *route["plain"])
    mesh["route"] = {"chamfer": cd, "voxel": voxel,
                     "faces": [len(f) for _, f in route.values()]}
    check(cd <= voxel, f"K1 route's mesh against the plain route's "
          f"{mesh['route']}")

    # ---- vertex refinement against the field
    v, f = meshes[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vr = refine_mesh(lambda q_: occ_alpha(runner.field, q_, cfg.field), v, f,
                     steps=REFINE_STEPS, device=DEV)
    torch.cuda.synchronize()
    moved = float(np.abs(vr - v).max())
    mesh["refine"] = {"steps": REFINE_STEPS, "s": time.perf_counter() - t0,
                      "max_move": moved}
    # RMSprop moves a vertex by at most 10 lr a step
    check(np.isfinite(vr).all() and 0 < moved <= REFINE_STEPS * 1e-4 * 1.001,
          f"refine {mesh['refine']}")
    log(json.dumps({"mesh": mesh}))
    return k1, mesh, k1_row


def export_arrays(out, views):
    """{view name: {mask, visibility, vis_plus}} of a shape_extract tree."""
    load = lambda sub, nm: np.load(os.path.join(out, sub, nm + ".npy"))
    return {nm: {sub: load(sub, nm) for sub in ("mask", "visibility",
                                                "vis_plus")}
            for nm in (f"view_{vi + 1:02d}" for vi in views)}


def run_export(runner, name, views, **kw):
    """shape_extract of every view toward the 96 lights and 32 vis_plus
    directions with fused_occ's launches set to 0 just before and read just
    after: ({wall_s, timings, k1_launches}, export_arrays)."""
    from psnerf_torch.ops import fused_occ as fo

    d = os.path.join(WORK, f"export_{name}")
    fo.fused_occ_logit.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timings = runner.shape_extract(d, visibility=True, vis_plus=True,
                                   vis_plus_num=32, tile=TILE, **kw)
    rec = {"wall_s": time.perf_counter() - t0, "timings": timings,
           "k1_launches": fo.fused_occ_logit.launches}
    arrays = export_arrays(d, views)
    shutil.rmtree(d)
    return rec, arrays


def compare_exports(got, base):
    """Per view: the largest |difference| of the visibility and vis_plus
    arrays, and the binary (> 0.5) vis_plus agreement on the surface
    pixels; the march's masks must be equal."""
    out = {"max_abs_dev": {}, "vis_plus_agreement": {}}
    for nm, a in got.items():
        b = base[nm]
        check(np.array_equal(a["mask"], b["mask"]),
              f"{nm}: the march's mask is the faithful one's")
        m = b["mask"]
        out["max_abs_dev"][nm] = {sub: float(np.abs(a[sub] - b[sub]).max())
                                  for sub in ("visibility", "vis_plus")}
        out["vis_plus_agreement"][nm] = float(
            ((a["vis_plus"][:, m] > 0.5) == (b["vis_plus"][:, m] > 0.5))
            .mean())
    return out


def phase_export_protocols(runner, faithful, card, sass):
    """The rescaled, mixed and guided export protocols and light chunks of
    4 and 8 on phase 9's trained default field (3 views, 96 lights, 32
    vis_plus directions), each with fused_occ's launches counted, against
    phase 10's faithful export: its legs and launches; the mixed and
    guided train-light visibility bit for bit the faithful one's; the
    chunked exports equal to chunk 1; the binary vis_plus agreement of
    every protocol with the faithful one, the guided one's above VIS_AGREE
    (tests/test_pipeline.py's bar). The rescaled protocol's bar is held on
    the same field with its occupancy logit SHARPEN times steeper
    (faithful, rescaled and guided exports again): after 30 steps the
    field is close to its geometric-init sphere, whose occupancy ramps
    over ~0.3 units, and each sample composites its own alpha, so the
    rescaled protocol, which packs its 64 samples into [0.1, the box exit]
    (up to 5x denser than the faithful grid on a short lit ray), darkens
    the lit pairs near 0.5 (0.886-0.921 agreement as trained, NVIDIA H100
    80GB HBM3, 700 W; > 0.99 sharpened).
    Then K1 at the guide grid's GUIDE_RES^3 points against its plain
    version and its bound."""
    from psnerf_torch.data.stage1 import load_stage1_data

    views = load_stage1_data(runner.scene, "all", None, None, None, False,
                             True, normal_loss=False, mask_valid=False,
                             device="cpu")["views"]
    base = export_arrays(faithful["dir"], views)
    n_tiles = -(-HW[0] * HW[1] // TILE)
    surf_tiles = sum(-(-int(a["mask"].sum()) // TILE) for a in base.values())
    march = len(views) * n_tiles * 9 + 9       # and the warm-up's tile
    out = {"faithful": {k: faithful[k] for k in ("wall_s", "timings",
                                                 "k1_launches")}}
    for name, kw in PROTOCOLS.items():
        rec, got = run_export(runner, name, views, **kw)
        chunk = kw.get("light_chunk", 1)
        rec["k1_launches_expected"] = march + 1 + surf_tiles * (
            -(-N_LIGHTS // chunk) + -(-32 // chunk)) + (name == "guided")
        rec.update(compare_exports(got, base))
        if name.startswith("chunk"):
            rec["bit_for_bit"] = all(max(v.values()) == 0.0
                                     for v in rec["max_abs_dev"].values())
        out[name] = rec
        log(json.dumps({f"export_protocol_{name}": rec}))
        check(rec["k1_launches"] >= surf_tiles * -(-N_LIGHTS // chunk),
              f"{name}: K1 launches {rec['k1_launches']}, expected "
              f"{rec['k1_launches_expected']}")
        if name == "guided":      # tests/test_pipeline.py's own bar
            for nm, agree in rec["vis_plus_agreement"].items():
                check(agree > VIS_AGREE, f"guided {nm}: vis_plus agreement "
                      f"{agree} with the faithful export")
        for nm, dev in rec["max_abs_dev"].items():
            if name in ("mixed", "guided"):
                check(dev["visibility"] == 0.0, f"{name} {nm}: train-light "
                      f"visibility bit for bit the faithful export's {dev}")
            if name.startswith("chunk"):
                check(max(dev.values()) <= CHUNK_DEV,
                      f"{name} {nm}: against chunk 1 {dev}")

    # ---- the agreement bar on the same surface, SHARPEN x steeper
    last = runner.field.geo[-1]
    saved = (last.g.detach().clone(), last.b.detach().clone())
    with torch.no_grad():
        last.g[0] *= SHARPEN
        last.b[0] *= SHARPEN
    try:
        sharp_base = run_export(runner, "sharp_faithful", views)
        sharp = {"faithful": sharp_base[0]}
        for name in ("rescaled", "guided"):
            rec, got = run_export(runner, f"sharp_{name}", views,
                                  **PROTOCOLS[name])
            rec.update(compare_exports(got, sharp_base[1]))
            sharp[name] = rec
        log(json.dumps({"export_protocols_sharpened": sharp}))
    finally:
        with torch.no_grad():
            last.g.copy_(saved[0])
            last.b.copy_(saved[1])
    for name in ("rescaled", "guided"):
        for nm, agree in sharp[name]["vis_plus_agreement"].items():
            check(agree > VIS_AGREE, f"{name} {nm}: vis_plus agreement "
                  f"{agree} with the faithful export (logit x{SHARPEN})")
        if name == "guided":
            for nm, dev in sharp[name]["max_abs_dev"].items():
                check(dev["visibility"] == 0.0,
                      f"sharpened guided {nm}: train lights bit for bit")
    out["sharpened"] = sharp

    # ---- K1 at the guide grid's points (occupancy_guide_grid's cell
    # centres), against its plain version and its bound
    half = GUIDE_BOX / GUIDE_RES
    xs = torch.linspace(-GUIDE_BOX + half, GUIDE_BOX - half, GUIDE_RES)
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), dim=-1)
    pts = grid.reshape(-1, 3).numpy()
    at_guide = k1_at_points(runner, pts, len(pts), card, sass)
    log(json.dumps({"fused_occ_logit_guide_grid": at_guide}))
    return {"protocols": out, "at_guide_grid": at_guide,
            "launches": {k: v["k1_launches"] for k, v in out.items()
                         if k != "sharpened"}}


def kernel_counts(zero=False):
    """The launch counts of K1, K2/K3 in the f32 form, K4 and K5 (set to 0
    first with zero=True)."""
    from psnerf_torch.ops import fused_occ as fo
    from psnerf_torch.ops import fused_radiance as fr
    from psnerf_torch.ops import fused_vis as fv

    if zero:
        fo.fused_occ_logit.launches = 0
        fr.reset_launches()
        fv.fused_visibility.launches = 0
        fv.fused_vis_shade.launches = 0
    return {"fused_occ_logit": fo.fused_occ_logit.launches,
            "fused_radiance_fwd_f32": fr.radiance_forward.launches["float32"],
            "fused_radiance_bwd_f32": fr.radiance_backward.launches["float32"],
            "fused_visibility": fv.fused_visibility.launches,
            "fused_vis_shade": fv.fused_vis_shade.launches}


def stage1_yaml(path, scene, out_dir, inten_normalize="null",
                print_every=10):
    """A stage-1 YAML that inherits configs/stage1/default.yaml by absolute
    path with the synthetic scene's distances and data; returns path."""
    with open(path, "w") as fh:
        fh.write(f"""inherit_from: {os.path.join(ROOT, "configs", "stage1",
                                                "default.yaml")}
rendering:
  near: 1.2
  far: 5.0
  radius: 1.2
  interval_start: 0.6
  interval_end: 0.05
dataloading:
  obj_name: synthetic
  data_dir: {scene}
  inten_normalize: {inten_normalize}
training:
  out_dir: {out_dir}
  print_every: {print_every}
""")
    return path


def cli_configs(scene, s1_dir, s2_dir):
    """A stage-1 YAML that inherits configs/stage1/default.yaml by absolute
    path (the full field, 2048 rays, 256 march steps, 64 + 32 samples) with
    the scene's distances and data, logging every 10 steps; and a stage-2
    conf of configs/stage2/bear.conf's blocks with the scene's data, no
    intensity normalization, the stage-1 export as its shape and
    bench.py's batch (train_all_pixels off). Returns their paths."""
    import re

    from psnerf_torch.config import stage2_config_from_conf

    s1 = stage1_yaml(os.path.join(WORK, "cli_s1.yaml"), scene, s1_dir)
    with open(os.path.join(ROOT, "configs", "stage2", "bear.conf")) as fh:
        conf = fh.read()
    for pat, new in ((r"data_dir = .*", f"data_dir = {scene}"),
                     (r"\n\s*inten_normalize = .*", ""),
                     (r"stage1_shape_path = .*",
                      f"stage1_shape_path = {s1_dir}/shape_out"),
                     (r"train_all_pixels = .*", "train_all_pixels = False")):
        conf, n = re.subn(pat, new, conf)
        check(n == 1, f"bear.conf: {pat} replaced {n} times")
    s2 = os.path.join(WORK, "cli_s2.conf")
    with open(s2, "w") as fh:
        fh.write(conf)
    bear = stage2_config_from_conf(os.path.join(ROOT, "configs", "stage2",
                                                "bear.conf"))
    got = stage2_config_from_conf(s2)
    check(got.net == bear.net and got.train == bear.train
          and got.light_bs == bear.light_bs and got.inten_normalize is None
          and not got.train_all_pixels, "the CLI's stage-2 conf is bear's")
    return s1, s2


def phase_cli(scene):
    """The user's workflow through psnerf_torch.cli.main, in process, at
    the full width of configs/stage1/default.yaml and configs/stage2/
    bear.conf on the 512x512, 96-light scene: stage1-train (20 steps),
    stage1-eval, shape-extract --vis_plus (32 directions), extract-mesh
    (32 / 2), stage2-train (S2_CLI_ITERS steps), stage2-eval (evaluate,
    --render_envmap of a sky .hdr, --edit_albedo --edit_specular) and
    evaluation; one more stage2-eval as `python -m psnerf_torch.cli.main`
    in a fresh process. Each in-process command with the kernels' counts
    set to 0 just before and read just after; each must launch the
    kernels its path needs. Checks tests/test_cli.py's output tree and
    finite losses and PSNR."""
    import contextlib
    import io

    from psnerf_torch.cli.main import main as cli

    s1_dir, s2_dir = (os.path.join(WORK, "cli", k) for k in ("s1", "s2"))
    s1, s2 = cli_configs(scene, s1_dir, s2_dir)
    hdr = os.path.join(WORK, "cli_sky.hdr")
    write_hdr(hdr, sky_envmap())
    cmds = [
        ("stage1-train", ["stage1-train", s1, "--workdir", s1_dir,
                          "--max-iters", "20"]),
        ("stage1-eval", ["stage1-eval", s1, "--workdir", s1_dir]),
        ("shape-extract", ["shape-extract", s1, "--workdir", s1_dir,
                           "--vis_plus", "--vis_plus_num", "32"]),
        ("extract-mesh", ["extract-mesh", s1, "--workdir", s1_dir,
                          "--resolution0", "32", "--upsampling", "2"]),
        ("stage2-train", ["stage2-train", "--conf", s2, "--workdir", s2_dir,
                          "--max-iters", str(S2_CLI_ITERS)]),
        ("stage2-eval", ["stage2-eval", "--conf", s2, "--workdir", s2_dir,
                         "--out", f"{s2_dir}/test_out"]),
        ("stage2-eval-envmap", ["stage2-eval", "--conf", s2, "--workdir",
                                s2_dir, "--out", f"{s2_dir}/relight",
                                "--render_envmap", "--envmap_path", hdr]),
        ("stage2-eval-edit", ["stage2-eval", "--conf", s2, "--workdir",
                              s2_dir, "--out", f"{s2_dir}/edit",
                              "--edit_albedo", "--color", "#cc2010",
                              "--edit_specular", "--basis", "3"]),
        ("evaluation", ["evaluation", "--data_path", scene,
                        "--test_out_path", f"{s2_dir}/test_out"]),
    ]
    # the kernels each command's path must launch
    needs = {"stage1-train": ("fused_occ_logit", "fused_radiance_fwd_f32",
                              "fused_radiance_bwd_f32"),
             "stage1-eval": ("fused_occ_logit",),
             "shape-extract": ("fused_occ_logit",),
             "extract-mesh": ("fused_occ_logit",),
             "stage2-eval": ("fused_visibility",),
             "stage2-eval-envmap": ("fused_vis_shade",),
             "stage2-eval-edit": ("fused_visibility",)}
    rec = {}
    for name, argv in cmds:
        kernel_counts(zero=True)
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli(argv)
        torch.cuda.synchronize()
        rec[name] = {"wall_s": time.perf_counter() - t0,
                     "launches": kernel_counts()}
        log(json.dumps({f"cli_{name}": rec[name]}))
        for k in needs.get(name, ()):
            check(rec[name]["launches"][k] > 0,
                  f"cli {name} launched no {k}: {rec[name]}")
        if name == "evaluation":
            res = json.loads("{" + out.getvalue().rsplit("{", 1)[1])
            rec[name]["result"] = {k: res.get(k) for k in
                                   ("psnr", "ssim", "normal_mae")}
            check(np.isfinite(res["psnr"]), f"evaluation {res}")

    # a fresh process finds the built kernels
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "psnerf_torch.cli.main", "stage2-eval",
         "--conf", s2, "--workdir", s2_dir, "--out", f"{s2_dir}/test_sub"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    rec["subprocess_stage2_eval"] = {"wall_s": time.perf_counter() - t0,
                                     "rc": sub.returncode,
                                     "stdout_tail": sub.stdout[-300:]}
    log(json.dumps({"cli_subprocess": rec["subprocess_stage2_eval"]}))
    check(sub.returncode == 0, f"python -m psnerf_torch.cli.main stage2-eval:"
          f" {sub.stderr[-2000:]}")

    # ---- tests/test_cli.py's output tree, finite losses
    for path in ("s1/checkpoints/model.npz", "s1/shape_out/points/view_01.npy",
                 "s1/shape_out/vis_plus/light_dir.json", "s1/mesh.ply",
                 "s1/eval/metrics.json", "s2/checkpoints/model.npz",
                 "s2/test_out/rgb/img/view_03/001.png",
                 "s2/test_sub/rgb/img/view_03/001.png",
                 "s2/relight/rgb/img/view_03.png",
                 "s2/relight/light_probe.png",
                 "s2/edit/rgb/img/view_03/001.png"):
        check(os.path.exists(os.path.join(WORK, "cli", path)),
              f"cli output {path}")
    losses = {k: [r["loss"] for r in read_losses(os.path.join(WORK, "cli", k))]
              for k in ("s1", "s2")}
    check(len(losses["s1"]) == 2 and len(losses["s2"]) == 1
          and np.isfinite(losses["s1"] + losses["s2"]).all(),
          f"cli losses {losses}")
    with open(os.path.join(s1_dir, "eval", "metrics.json")) as fh:
        s1_psnr = [m["psnr"] for m in json.load(fh)]
    check(np.isfinite(s1_psnr).all(), f"stage1-eval psnr {s1_psnr}")
    rec["losses"], rec["stage1_eval_psnr"] = losses, s1_psnr
    return rec


def sdps_reference_state_dict(net, kind):
    """The released SDPS-Net checkpoints' layout (LCNet_CVPR2019 /
    NENet_CVPR2019 .pth.tar) of an LCNet ("lcnet") or NENet ("nenet"):
    the inverse of preprocess.sdps.load_{lcnet,nenet}_torch."""
    from psnerf_torch.train.checkpoints import flatten_tree

    conv = lambda ref, path: {f"{ref}.weight": f"{path}/w",
                              f"{ref}.bias": f"{path}/b"}
    keys = {}
    if kind == "lcnet":
        for i in range(7):
            keys.update(conv(f"featExtractor.conv{i + 1}.0", f"feat/{i}"))
        for i in range(4):
            keys.update(conv(f"classifier.conv{i + 1}.0", f"cls/{i}"))
        for name, ref in (("dir_x", "dir_x_est"), ("dir_y", "dir_y_est"),
                          ("ints", "int_est")):
            for k in range(2):
                keys.update(conv(f"classifier.{ref}.{k}.0",
                                 f"heads/{name}/{k}"))
    else:
        for i in range(5):
            keys.update(conv(f"extractor.conv{i + 1}.0", f"feat/{i}"))
        keys["extractor.conv6.0.weight"] = "feat_deconv/w"
        keys.update(conv("extractor.conv7.0", "feat_out"))
        keys.update(conv("regressor.deconv1.0", "reg/0"))
        keys.update(conv("regressor.deconv2.0", "reg/1"))
        keys["regressor.deconv3.0.weight"] = "reg_deconv/w"
        keys["regressor.est_normal.0.weight"] = "est_normal/w"
    flat = flatten_tree(net)
    check(sorted(flat) == sorted(keys.values()), f"{kind} reference keys")
    return {ref: torch.as_tensor(flat[path]) for ref, path in keys.items()}


def stage1_reference_state_dict(field):
    """The reference NeuralNetwork layout of a stage-1 field under "model"
    (CheckpointIO's bundle): lin{l}.weight_v [dout, din], weight_g
    [dout, 1], bias; lina{l}.* for the appearance MLP."""
    sd = {}
    for name, layers in (("lin", field.geo), ("lina", field.app)):
        for l, lyr in enumerate(layers):
            sd[f"{name}{l}.weight_v"] = lyr.v.detach().t().contiguous()
            sd[f"{name}{l}.weight_g"] = lyr.g.detach()[:, None].clone()
            sd[f"{name}{l}.bias"] = lyr.b.detach().clone()
    return {"model": sd}


def stage2_reference_state_dicts(params):
    """The reference ModelParameters/*.pth ({"model_state_dict": <head>_net
    .linears.<i>.{weight [dout, din], bias}}) and LightParameters/*.pth
    layouts of init_stage2_params' tree."""
    sd = {}
    for head, mlp in params["model"].items():
        for i, lyr in enumerate(mlp):
            sd[f"{head}_net.linears.{i}.weight"] = \
                lyr.w.detach().t().contiguous()
            sd[f"{head}_net.linears.{i}.bias"] = lyr.b.detach().clone()
    return ({"model_state_dict": sd},
            {"light_state_dict": {"weight": params["light_dirs"].clone()},
             "light_inten_state_dict": {"weight":
                                        params["light_ints"].clone()}})


def conv_flops(net, *args):
    """FLOPs (2 a multiply-add) of the convolutions of one forward of an
    SDPS net on args, counted from the layers' shapes by forward hooks."""
    from psnerf_torch.preprocess.sdps import Conv, Deconv

    total = [0]

    def hook(mod, inp, out):
        w = mod.w
        if isinstance(mod, Deconv):   # each input pixel meets the kernel
            total[0] += 2 * inp[0].numel() * w.shape[1] * w[0, 0].numel()
        else:
            total[0] += 2 * out.numel() * w[0].numel()

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (Conv, Deconv))]
    try:
        net(*args)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def alex_flops(h, w):
    """FLOPs of LPIPS's AlexNet convolutions on one h x w image."""
    from psnerf_torch.eval.lpips_torch import _ALEX

    total, cin = 0, 3
    for spec in _ALEX:
        if spec == "M":
            h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
            continue
        cout, k, stride, pad = spec
        h, w = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        total += 2 * cout * h * w * cin * k * k
        cin = cout
    return total


def random_lpips_npz(path, seed=SEED):
    """Random LPIPS weights in tools/export_lpips_npz.py's layout:
    conv{0..4}_{w,b} (OIHW) and non-negative lin{0..4}_w [1, C, 1, 1]."""
    from psnerf_torch.eval.lpips_torch import _ALEX

    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(s for s in _ALEX if s != "M"):
        params[f"conv{i}_w"] = rng.normal(0, 0.05, (cout, cin, k, k)) \
            .astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.01, cout).astype(np.float32)
        params[f"lin{i}_w"] = rng.random((1, cout, 1, 1)).astype(np.float32)
        cin = cout
    np.savez(path, **params)
    return path


def phase_preprocess(scene, cli_rec):
    """Phase 14 (module docstring): conversion, SDPS on the card and
    against the CPU, the SDPS-normalized images into stage1-train, and
    LPIPS, with cuDNN's TF32 at PyTorch's default throughout."""
    import contextlib
    import io

    from psnerf_torch.cli.main import main as cli
    from psnerf_torch.data.scene import imread
    from psnerf_torch.eval.lpips_torch import LPIPS, lpips_distance
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.fields.psnet import PSNetConfig, init_psnet
    from psnerf_torch.preprocess import light_avg, runner, sdps
    from psnerf_torch.train.checkpoints import flatten_tree, load_checkpoint
    from psnerf_torch.train.stage2 import init_stage2_params

    root = os.path.join(WORK, "prep")
    os.makedirs(root)
    rec = {"cli_s": {}}

    def run(name, argv):
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli(argv)
        torch.cuda.synchronize()
        rec["cli_s"][name] = time.perf_counter() - t0
        return out.getvalue()

    prior_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # PyTorch's default
    try:
        # ---- a. reference checkpoints from seed 0 through convert-ckpt
        gen = torch.Generator().manual_seed(SEED)
        rng = np.random.default_rng(SEED)
        nets = {"lcnet": sdps.LCNet(generator=gen, device="cpu"),
                "nenet": sdps.NENet(generator=gen, device="cpu")}
        field = init_occupancy_field(OccFieldConfig(), generator=gen)
        dirs = rng.normal(size=(N_LIGHTS * 3, 3))
        s2 = init_stage2_params(
            init_psnet(PSNetConfig(), generator=gen),
            dirs / np.linalg.norm(dirs, axis=1, keepdims=True),
            rng.uniform(1.0, 3.0, (N_LIGHTS * 3, 1)))
        s2_model, s2_lights = stage2_reference_state_dicts(s2)
        lights = os.path.join(root, "lights.pth")
        torch.save(s2_lights, lights)
        blobs = {"lcnet": ({"state_dict": sdps_reference_state_dict(
                    nets["lcnet"], "lcnet")}, nets["lcnet"], []),
                 "nenet": ({"state_dict": sdps_reference_state_dict(
                     nets["nenet"], "nenet")}, nets["nenet"], []),
                 "stage1": (stage1_reference_state_dict(field), field, []),
                 "stage2": (s2_model, s2, ["--lights", lights])}
        ckpt, rec["converted_leaves"] = {}, {}
        for stage, (blob, tree, extra) in blobs.items():
            src = os.path.join(root, f"{stage}.pth.tar")
            dst = os.path.join(root, f"{stage}.npz")
            torch.save(blob, src)
            run(f"convert-ckpt {stage}", ["convert-ckpt", "--stage", stage,
                                          "--model", src, *extra,
                                          "--out", dst])
            got, want = load_checkpoint(dst)[0], flatten_tree(tree)
            check(sorted(got) == sorted(want)
                  and all(got[k].dtype == want[k].dtype
                          and np.array_equal(got[k], want[k]) for k in want),
                  f"convert-ckpt {stage}: the npz against the source leaves")
            ckpt[stage] = {"tar": src, "npz": dst}
            rec["converted_leaves"][stage] = len(got)
        log(json.dumps({"preprocess_convert": {
            "leaves": rec["converted_leaves"], "cli_s": rec["cli_s"]}}))

        # ---- b. sdps-preprocess over a copy of the scene, on the card
        copy = os.path.join(root, "scene")
        shutil.copytree(scene, copy, ignore=shutil.ignore_patterns("exports"))
        run("sdps-preprocess", ["sdps-preprocess", "--obj", copy,
                                "--lcnet", ckpt["lcnet"]["npz"],
                                "--nenet", ckpt["nenet"]["tar"]])
        with open(os.path.join(copy, "params.json")) as fh:
            n_view = json.load(fh)["n_view"]
        out_dir = os.path.join(copy, f"sdps_out_l{N_LIGHTS}")
        normals = [np.load(os.path.join(out_dir, "outnpy",
                                        f"view_{v:02d}.npy"))
                   for v in range(1, n_view + 1)]
        l_dirs = np.load(os.path.join(out_dir, "light_direction_pred.npy"))
        l_ints = np.load(os.path.join(out_dir, "light_intensity_pred.npy"))
        check(l_dirs.shape == (n_view, N_LIGHTS, 3)
              and l_ints.shape == (n_view, N_LIGHTS)
              and np.allclose(np.linalg.norm(l_dirs, axis=-1), 1, atol=1e-5)
              and l_ints.min() >= 0.2 and l_ints.max() <= 2.0,
              f"sdps light predictions {l_dirs.shape} {l_ints.shape}")
        unit = []
        for v, n in enumerate(normals, 1):
            m = np.asarray(runner.read_view(copy, f"view_{v:02d}",
                                            light_slt=[0])[1]) > 0.5
            unit.append(float(np.abs(np.linalg.norm(n[m], axis=-1) - 1)
                              .max()))
            check(n.shape == (*HW, 3) and np.isfinite(n).all()
                  and unit[-1] < 1e-5 and not n[~m].any(),
                  f"sdps normals of view {v}: unit {unit[-1]}")
        # the runner again on the same nets: its legs per view
        lc = sdps.load_sdps_net(ckpt["lcnet"]["npz"], "lcnet", DEV)
        ne = sdps.load_sdps_net(ckpt["nenet"]["tar"], "nenet", DEV)
        legs = {}
        t0 = time.perf_counter()
        again = runner.run_sdps(copy, lc, ne, timings=legs,
                                out_dir=os.path.join(root, "sdps_again"))
        again_s = time.perf_counter() - t0
        # cuDNN may pick another algorithm for the same shapes on a rerun
        # (its heuristics see another free workspace): f32 sums in another
        # order, which the normalization amplifies where a raw normal is
        # short, so a rerun is held at the card-against-CPU bar
        rerun = max(float(np.abs(np.load(os.path.join(
            again, "outnpy", f"view_{v:02d}.npy")) - normals[v - 1]).max())
            for v in range(1, n_view + 1))
        rerun_lights = all(np.array_equal(np.load(os.path.join(again, f)),
                                          np.load(os.path.join(out_dir, f)))
                           for f in ("light_direction_pred.npy",
                                     "light_intensity_pred.npy"))
        check(rerun <= SDPS_NORMAL_ABS, f"sdps rerun differs by {rerun}")
        # LCNet and NENet of view 1 (all lights) by CUDA events
        imgs, mask = runner.read_view(copy, "view_01")
        cropped, cmask, _, imgs_lc, mask_lc = runner.sdps_inputs(imgs, mask)
        t = lambda a: torch.as_tensor(a, device=DEV)
        x_lc, m_lc = t(imgs_lc.transpose(0, 3, 1, 2)), t(mask_lc[None])
        x_ne = t(cropped.transpose(0, 3, 1, 2))
        with torch.no_grad():
            pred = lc(x_lc, m_lc)
            flops = {"lcnet": conv_flops(lc, x_lc, m_lc),
                     "nenet": conv_flops(ne, x_ne, pred["dirs"],
                                         pred["intens"])}
            ms = in_turns({"lcnet": lambda: lc(x_lc, m_lc),
                           "nenet": lambda: ne(x_ne, pred["dirs"],
                                               pred["intens"])},
                          {"lcnet": 10, "nenet": 3},
                          ["lcnet", "nenet", "nenet", "lcnet"])
        nets_rec = {k: {"ms": ms[k], "gflop": flops[k] / 1e9,
                        "f32_bound_ms": flops[k] / PEAK_F32_FLOPS * 1e3,
                        "tflop_s": flops[k] / ms[k] / 1e9}
                    for k in ms}
        rec["sdps"] = {
            "views": n_view, "lights": N_LIGHTS,
            "cli_s": rec["cli_s"]["sdps-preprocess"],
            "cli_s_per_view": rec["cli_s"]["sdps-preprocess"] / n_view,
            "runner_s": again_s, "legs_s_per_view": {
                k: v for k, v in legs.items() if k != "crop_hw"},
            "crop_hw": legs["crop_hw"], "view1": nets_rec,
            "normals_unit_err": max(unit), "rerun_max_abs": rerun,
            "rerun_light_preds_equal": rerun_lights}
        log(json.dumps({"preprocess_sdps": rec["sdps"]}))

        # ---- c. view 1's first lights on the card and on the CPU
        k = SDPS_CMP_LIGHTS
        sub, smask, _, sub_lc, sub_mlc = runner.sdps_inputs(imgs[:k], mask)
        cpu = {"lcnet": sdps.load_sdps_net(ckpt["lcnet"]["npz"], "lcnet",
                                           "cpu"),
               "nenet": sdps.load_sdps_net(ckpt["nenet"]["tar"], "nenet",
                                           "cpu")}
        with torch.no_grad():
            args = lambda dev: (torch.as_tensor(sub_lc.transpose(0, 3, 1, 2),
                                                device=dev),
                                torch.as_tensor(sub_mlc[None], device=dev))
            got, want = lc(*args(DEV)), cpu["lcnet"](*args("cpu"))
            # NENet on both from the CPU's light estimates
            x = sub.transpose(0, 3, 1, 2)
            n_dev = ne(t(x), want["dirs"].to(DEV),
                       want["intens"].to(DEV)).cpu().numpy()
            n_cpu = cpu["nenet"](torch.as_tensor(x), want["dirs"],
                                 want["intens"]).numpy()
        cmp = {}
        for head in ("dirs_x", "dirs_y", "ints"):
            g, w = got[head].cpu().numpy(), want[head].numpy()
            scale = float(np.abs(w).max())
            top2 = np.sort(w, axis=1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > SDPS_TIE * scale
            same = g.argmax(1) == w.argmax(1)
            cmp[head] = {"rel_err": float(np.abs(g - w).max()) / scale,
                         "near_ties": int((~clear).sum()),
                         "near_tie_flips": int((~clear & ~same).sum())}
            check(cmp[head]["rel_err"] <= SDPS_LOGIT_REL and same[clear].all(),
                  f"LCNet {head} card against CPU: {cmp[head]}")
        inside = smask > 0.5
        cmp["normals_max_abs"] = float(np.abs(n_dev - n_cpu)[:, inside].max())
        check(cmp["normals_max_abs"] <= SDPS_NORMAL_ABS,
              f"NENet card against CPU: {cmp['normals_max_abs']}")
        cmp["lights"], cmp["crop_hw"] = len(sub), list(sub.shape[1:3])
        rec["card_vs_cpu"] = cmp
        log(json.dumps({"preprocess_card_vs_cpu": cmp}))

        # ---- d. light averages, the SDPS-normalized images, stage 1
        run("light-avg", ["light-avg", "--obj", copy])
        t0 = time.perf_counter()
        norm_dir = light_avg.light_average(copy, intnorm=True, sdps=True)
        rec["light_average_sdps_s"] = time.perf_counter() - t0
        check(os.path.basename(norm_dir) == f"img_intnorm_sdps_l{N_LIGHTS}"
              and os.path.exists(os.path.join(norm_dir, "avg",
                                              "view_01.png")),
              f"light_average(sdps=True) wrote {norm_dir}")
        gen_normals = np.load(os.path.join(scene, f"sdps_out_l{N_LIGHTS}",
                                           "outnpy", "view_01.npy"))
        check(not np.array_equal(gen_normals, normals[0]),
              "the port's SDPS normals replaced the generator's")
        s1_dir = os.path.join(root, "s1")
        yaml = stage1_yaml(os.path.join(root, "s1_sdps.yaml"), copy, s1_dir,
                           inten_normalize="sdps", print_every=1)
        kernel_counts(zero=True)
        run("stage1-train", ["stage1-train", yaml, "--workdir", s1_dir,
                             "--max-iters", str(S1_SDPS_STEPS)])
        s1_launches = kernel_counts()
        losses = [r["loss"] for r in read_losses(s1_dir)]
        for kern in ("fused_occ_logit", "fused_radiance_fwd_f32",
                     "fused_radiance_bwd_f32"):
            check(s1_launches[kern] > 0,
                  f"stage1-train on the SDPS output launched no {kern}")
        check(len(losses) == S1_SDPS_STEPS and np.isfinite(losses).all(),
              f"stage1-train on the SDPS output: losses {losses}")
        rec["stage1"] = {"launches": s1_launches, "losses": losses,
                         "wall_s": rec["cli_s"]["stage1-train"]}
        log(json.dumps({"preprocess_stage1": rec["stage1"],
                        "light_avg_s": rec["cli_s"]["light-avg"],
                        "light_average_sdps_s":
                            rec["light_average_sdps_s"]}))

        # ---- e. LPIPS
        npz = random_lpips_npz(os.path.join(root, "lpips_alex.npz"))
        test_out = os.path.join(WORK, "cli", "s2", "test_out")
        res = run("evaluation --lpips_weights", [
            "evaluation", "--data_path", scene, "--test_out_path", test_out,
            "--lpips_weights", npz])
        res = json.loads("{" + res.rsplit("{", 1)[1])
        check(isinstance(res["lpips"], float) and np.isfinite(res["lpips"])
              and res["lpips_status"] == "computed"
              and res["psnr"] == cli_rec["evaluation"]["result"]["psnr"],
              f"evaluation --lpips_weights: {res}")
        a = imread(os.path.join(test_out, "rgb", "img", "view_03",
                                "001.png"))[..., :3] / np.float32(255)
        b = imread(os.path.join(scene, "img", "view_03",
                                "001.png"))[..., :3] / np.float32(255)
        metric = LPIPS(npz, device=DEV)
        d_dev, d_cpu = metric(a, b), LPIPS(npz, device="cpu")(a, b)
        check(abs(d_dev - d_cpu) <= LPIPS_REL * abs(d_cpu) and d_cpu > 0,
              f"LPIPS card {d_dev} against CPU {d_cpu}")
        ta, tb = t(a.astype(np.float32)), t(b.astype(np.float32))
        with torch.no_grad():
            pair_ms = in_turns(
                {"pair": lambda: metric(a, b),
                 "device": lambda: lpips_distance(metric.params, ta, tb)},
                {"pair": 20, "device": 20},
                ["pair", "device", "device", "pair"])
        pair_flops = 2 * alex_flops(*a.shape[:2])
        rec["lpips"] = {
            "evaluation_s": rec["cli_s"]["evaluation --lpips_weights"],
            "evaluation_no_weights_s": cli_rec["evaluation"]["wall_s"],
            "lpips": res["lpips"], "pair_card": d_dev, "pair_cpu": d_cpu,
            "pair_rel_err": abs(d_dev - d_cpu) / abs(d_cpu),
            "ms_per_pair": pair_ms["pair"],
            "ms_per_pair_on_device_inputs": pair_ms["device"],
            "gflop_per_pair": pair_flops / 1e9,
            "f32_bound_ms": pair_flops / PEAK_F32_FLOPS * 1e3}
        log(json.dumps({"preprocess_lpips": rec["lpips"]}))
    finally:
        torch.backends.cudnn.allow_tf32 = prior_tf32
    return rec


# ------------------------------------------- phase 15: data-parallel runs

def mesh_counts():
    """The launch counts of K1, both forms of K2/K3, K4 and K5."""
    from psnerf_torch.ops import fused_radiance as fr

    c = kernel_counts()
    c["fused_radiance_fwd_bf16"] = fr.radiance_forward.launches["bfloat16"]
    c["fused_radiance_bwd_bf16"] = fr.radiance_backward.launches["bfloat16"]
    return c


def mesh_timed(out, name, fn):
    """fn() with every kernel count set to 0 just before and read just
    after, and its wall; both land in out under name."""
    kernel_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    out["wall_s"][name] = time.perf_counter() - t0
    out["launches"][name] = mesh_counts()
    return res


def export_errors(got_dir, want_dir):
    """shape_extract's npys in got_dir against want_dir's, every view:
    the mask agreement, points and normals on the common mask, and the
    visibility [L, H, W] on it."""
    err = {"mask_agreement": 1.0, "points_max_abs_err": 0.0,
           "normal_max_abs_err": 0.0, "vis_max_abs_err": 0.0,
           "vis_mean_abs_err": 0.0, "surface_pixels": 0, "lights": 0}
    names = sorted(os.listdir(os.path.join(want_dir, "mask")))
    check(names == sorted(os.listdir(os.path.join(got_dir, "mask")))
          and len(names) > 0, f"export views {names}")
    for name in names:
        a, b = ({sub: np.load(os.path.join(d, sub, name))
                 for sub in ("points", "normal", "mask", "visibility")}
                for d in (got_dir, want_dir))
        common = a["mask"] & b["mask"]
        diff = lambda k: np.abs(a[k] - b[k])
        err["mask_agreement"] = min(err["mask_agreement"],
                                    float((a["mask"] == b["mask"]).mean()))
        for k in ("points", "normal"):
            err[f"{k}_max_abs_err"] = max(err[f"{k}_max_abs_err"],
                                          float(diff(k)[common].max()))
        vis = diff("visibility")[:, common]
        err["vis_max_abs_err"] = max(err["vis_max_abs_err"],
                                     float(vis.max()))
        err["vis_mean_abs_err"] = max(err["vis_mean_abs_err"],
                                      float(vis.mean()))
        err["surface_pixels"] += int(b["mask"].sum())
        err["lights"] = max(err["lights"], int(b["visibility"].shape[0]))
    err["views"] = len(names)
    return err


def mesh_rank(mesh, scene, single):
    """One of MESH_RANKS gloo ranks sharing cuda:0 (phase 15), each path
    with the counts set to 0 just before and read just after:
    (a) Stage1Runner(mesh=...).train at the f32 and the bf16 field;
    (c) Stage1Runner(mesh=...).shape_extract, the faithful export, of the
    one-process runner's trained f32 field (resumed from its checkpoint)
    into WORK/mesh_export; (b) Stage2Runner(mesh=...)
    .train, then on the one-process runner's lifted checkpoint evaluate
    (K4 per rank), render_view's rgb route (K5 per rank) and, over a
    1 x MESH_RANKS rays x lights mesh, one envmap chunk's light sum and
    render_envmap (K5's light sum per rank, summed over the light axis).
    Rank 0 holds what it gathered against the one-process arrays that
    `single` names. Returns the params, the comparisons, the counts and
    the walls."""
    import torch.distributed as dist

    from psnerf_torch.parallel import make_mesh_2d
    from psnerf_torch.parallel.mesh import all_gather_cat, all_sum
    from psnerf_torch.runners.stage1 import Stage1Runner
    from psnerf_torch.runners.stage2 import Stage2Runner
    from psnerf_torch.train.stage1 import field_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend, "launches": {}, "wall_s": {}}
    # the three collectives the port uses, on CUDA tensors
    x = torch.full((4,), float(mesh.rank + 1), device=DEV)
    y = x.clone()
    dist.broadcast(y, src=1)
    out["collectives"] = {
        "all_reduce": all_sum(x, dist.group.WORLD).tolist(),
        "all_gather": all_gather_cat(x, dist.group.WORLD).tolist(),
        "broadcast": y.tolist()}
    for compute, steps in MESH_S1_STEPS.items():
        r = Stage1Runner(stage1_config(scene, compute),
                         os.path.join(WORK, f"mesh_s1_{compute}"),
                         resume=False, mesh=mesh)
        first = mesh_timed(out, f"stage1_{compute}",
                           lambda: (first_step_stage1(r),
                                    r.train(steps, log_every=10 ** 9))[0])
        out[f"stage1_{compute}"] = {"first": first, "params": {
            k: v.detach().cpu().numpy()
            for k, v in field_params(r.field).items()}}
    r = Stage1Runner(stage1_config(scene, "float32"), single["stage1_wd"],
                     resume=True, mesh=mesh)
    mesh_timed(out, "shape_extract", lambda: r.shape_extract(
        os.path.join(WORK, "mesh_export"), tile=TILE,
        n_steps=MESH_MARCH_STEPS, vis_steps=MESH_VIS_STEPS))
    del r
    cfg2 = stage2_train_config(scene)
    r2 = Stage2Runner(cfg2, os.path.join(WORK, "mesh_s2"), resume=False,
                      mesh=mesh)
    first = mesh_timed(out, "stage2_train",
                       lambda: (first_step_stage2(r2),
                                r2.train(MESH_S2_STEPS,
                                         log_every=10 ** 9))[0])
    out["stage2"] = {"first": first, "params": {
        k: v.cpu().numpy() for k, v in stage2_leaves(r2).items()}}
    del r2
    ev = Stage2Runner(cfg2, single["stage2_wd"], resume=True, mesh=mesh)
    mesh_timed(out, "evaluate",
               lambda: ev.evaluate(os.path.join(WORK, "mesh_eval"),
                                   split="test", tile=TILE))
    test = ev._eval_data("test")
    dirs, ints = ev.trained_lights_for_view(test, 0)
    rgb = mesh_timed(out, "render_view_rgb",
                     lambda: ev.render_view(test, 0, dirs, ints, TILE,
                                            outputs=("rgb",))["rgb"])
    del ev
    ev2 = Stage2Runner(cfg2, single["stage2_wd"], resume=True,
                       mesh=make_mesh_2d(1, MESH_RANKS, mesh.device))
    env_dirs, texels = single["env_chunk"]
    rgb_sum = mesh_timed(out, "envmap_chunk_2d", lambda: ev2.render_view(
        test, 0, env_dirs, texels, TILE, outputs=("rgb_sum",))["rgb_sum"])
    mesh_timed(out, "render_envmap_2d", lambda: ev2.render_envmap(
        os.path.join(WORK, "mesh_relight"), single["env"], split="test",
        light_h=LIGHT_H, tile=TILE))
    if mesh.is_main:
        mask = test["surface_mask"][0].cpu().numpy().reshape(HW)
        ref = np.load(single["rgb"])
        out["render_view_rgb_max_abs_err"] = float(np.abs(rgb - ref).max())
        out["envmap_chunk_2d"] = rgb_sum[mask]
    return out


def phase_data_parallel(scene, card):
    """Data-parallel runs through psnerf_torch.parallel.launch, after the
    kernels were built: MESH_RANKS gloo ranks sharing cuda:0 (NCCL refuses
    two ranks on one device) run mesh_rank, each path held against the
    same path in this one process; then stage1-train --mesh-devices 1
    through the command line (one NCCL rank). Returns the per-rank counts
    and the phase's numbers."""
    from psnerf_torch.cli.main import main as cli
    from psnerf_torch.core.spherical import gen_light_xyz
    from psnerf_torch.parallel.launch import launch
    from psnerf_torch.runners.stage1 import Stage1Runner
    from psnerf_torch.runners.stage2 import (ENV_CHUNK, Stage2Runner,
                                             load_envmap)
    from psnerf_torch.train.checkpoints import load_checkpoint
    from psnerf_torch.train.stage1 import field_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()       # the earlier phases' blocks: 3 processes
    walls, single = {}, {}
    # ---- the one-process runs the ranks are held against
    params1 = {}
    for compute, steps in MESH_S1_STEPS.items():
        wd = os.path.join(WORK, f"single_s1_{compute}")
        r = Stage1Runner(stage1_config(scene, compute), wd, resume=False,
                         device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = first_step_stage1(r)
        r.train(steps, log_every=10 ** 9)
        torch.cuda.synchronize()
        walls[f"stage1_{compute}"] = time.perf_counter() - t0
        params1[compute] = {"first": first, "lr": r.tcfg.learning_rate,
                            "steps": steps, "params": {
                                k: v.detach().cpu().numpy()
                                for k, v in field_params(r.field).items()}}
        if compute == "float32":
            single["stage1_wd"] = wd
            t0 = time.perf_counter()
            r.shape_extract(os.path.join(WORK, "single_export"), tile=TILE,
                            n_steps=MESH_MARCH_STEPS,
                            vis_steps=MESH_VIS_STEPS)
            torch.cuda.synchronize()
            walls["shape_extract"] = time.perf_counter() - t0
        del r
    cfg2 = stage2_train_config(scene)
    wd2 = os.path.join(WORK, "single_s2")
    r2 = Stage2Runner(cfg2, wd2, resume=False, device=DEV)
    t0 = time.perf_counter()
    first = first_step_stage2(r2)
    r2.train(MESH_S2_STEPS, log_every=10 ** 9)
    torch.cuda.synchronize()
    walls["stage2_train"] = time.perf_counter() - t0
    tc = r2.tcfg
    params2 = {"first": first, "steps": MESH_S2_STEPS, "lr": {
        k: {"light_dirs": tc.light_learning_rate,
            "light_ints": tc.light_inten_lr}.get(k, tc.sg_learning_rate)
        for k in stage2_leaves(r2)}, "params": {
        k: v.cpu().numpy() for k, v in stage2_leaves(r2).items()}}
    test = r2._eval_data("test")
    hdr = os.path.join(WORK, "mesh_sky.hdr")
    write_hdr(hdr, sky_envmap())
    env = load_envmap(hdr, LIGHT_H)
    lxyz, _ = gen_light_xyz(LIGHT_H, 2 * LIGHT_H, envmap_radius=1.0)
    env_dirs = lxyz.reshape(-1, 3)
    env_dirs = env_dirs / np.linalg.norm(env_dirs, axis=-1, keepdims=True)
    with torch.no_grad():
        lift = lift_visibility(r2, test, env_dirs)
    r2.save(r2.it)                       # the lifted params for the ranks
    single.update(stage2_wd=wd2, env=env, env_chunk=(
        env_dirs[:ENV_CHUNK], env.reshape(-1, 3)[:ENV_CHUNK]))
    t0 = time.perf_counter()
    r2.evaluate(os.path.join(WORK, "single_eval"), split="test", tile=TILE)
    walls["evaluate"] = time.perf_counter() - t0
    dirs, ints = r2.trained_lights_for_view(test, 0)
    t0 = time.perf_counter()
    rgb = r2.render_view(test, 0, dirs, ints, TILE, outputs=("rgb",))["rgb"]
    walls["render_view_rgb"] = time.perf_counter() - t0
    single["rgb"] = os.path.join(WORK, "single_rgb.npy")
    np.save(single["rgb"], rgb)
    del rgb
    t0 = time.perf_counter()
    sum1 = r2.render_view(test, 0, *single["env_chunk"], TILE,
                          outputs=("rgb_sum",))["rgb_sum"]
    walls["envmap_chunk_2d"] = time.perf_counter() - t0
    del r2
    mask = test["surface_mask"][0].cpu().numpy().reshape(HW)
    sum1 = sum1[mask]
    n_views = len(test["views"])

    # ---- MESH_RANKS gloo ranks on cuda:0
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, MESH_RANKS, scene, single, device="cuda:0",
                   timeout=MESH_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    want = [float(r + 1) for r in range(MESH_RANKS)]
    for rk in ranks:
        c = rk["collectives"]
        check(rk["backend"] == "gloo" and rk["device"] == "cuda:0",
              f"rank {rk['rank']} on {rk['device']} over {rk['backend']}")
        check(c["all_reduce"] == [sum(want)] * 4
              and c["all_gather"] == [v for v in want for _ in range(4)]
              and c["broadcast"] == [2.0] * 4,
              f"gloo collectives on CUDA tensors {c}")
    errs = {}
    for compute in MESH_S1_STEPS:
        name = f"stage1_{compute}"
        errs[name] = train_errors([rk[name] for rk in ranks],
                                  params1[compute], MESH_STEP_BARS[name])
    errs["stage2_train"] = train_errors([rk["stage2"] for rk in ranks],
                                        params2, MESH_STEP_BARS["stage2"])
    rk0 = ranks[0]
    # (c) the export rank 0 wrote: points and normals on the common mask,
    # the visibility at phase 10's K1-route bar
    ee = errs["shape_extract"] = export_errors(
        os.path.join(WORK, "mesh_export"), os.path.join(WORK, "single_export"))
    check(ee["mask_agreement"] >= 0.995 and ee["points_max_abs_err"] <= 1e-5
          and ee["normal_max_abs_err"] <= 1e-5
          and ee["vis_mean_abs_err"] <= 1e-2, f"sharded shape_extract {ee}")
    # (b) evaluate's npys, the rgb route, the 2-D envmap chunk
    ev = {}
    name = f"view_{int(test['views'][0]) + 1:02d}"
    for sub in ("rgb", "albedo", "rough", "visibility", "mask"):
        a = np.load(os.path.join(WORK, "single_eval", sub, "npy",
                                 name + ".npy"))
        b = np.load(os.path.join(WORK, "mesh_eval", sub, "npy",
                                 name + ".npy"))
        check(a.shape == b.shape, f"evaluate {sub} shapes")
        ev[sub] = float(np.abs(a.astype(np.float64) - b).max())
    errs["evaluate"] = ev
    errs["render_view_rgb"] = rk0["render_view_rgb_max_abs_err"]
    check(max(ev.values()) <= MESH_EVAL_ABS
          and errs["render_view_rgb"] <= MESH_EVAL_ABS,
          f"sharded evaluate and rgb route {ev} {errs['render_view_rgb']}")
    texels = single["env_chunk"][1]
    scale = texels.sum(0)
    err = np.abs(rk0["envmap_chunk_2d"] - sum1)
    errs["envmap_chunk_2d"] = {"max_abs_err": err.max(0).tolist(),
                               "mean_abs_err": err.mean(0).tolist(),
                               "bar_max": (RGB_MAX * scale).tolist(),
                               "bar_mean": (RGB_MEAN * scale).tolist()}
    check((err.max(0) < RGB_MAX * scale).all()
          and (err.mean(0) < RGB_MEAN * scale).all()
          and (np.ptp(sum1, 0) > SUM_SPAN * RGB_MAX * scale).all(),
          f"2-D envmap chunk light sum {errs['envmap_chunk_2d']}")
    # every path launched its kernels on every rank
    need = {"stage1_float32": ("fused_occ_logit", "fused_radiance_fwd_f32",
                               "fused_radiance_bwd_f32"),
            "stage1_bfloat16": ("fused_occ_logit", "fused_radiance_fwd_bf16",
                                "fused_radiance_bwd_bf16"),
            "shape_extract": ("fused_occ_logit",),
            "evaluate": ("fused_visibility",),
            "render_view_rgb": ("fused_vis_shade",),
            "envmap_chunk_2d": ("fused_vis_shade",),
            "render_envmap_2d": ("fused_vis_shade",)}
    for rk in ranks:
        for path, kernels in need.items():
            got = rk["launches"][path]
            check(all(got[k] > 0 for k in kernels),
                  f"rank {rk['rank']} {path} launches {got}")
        env_launches = rk["launches"]["render_envmap_2d"]["fused_vis_shade"]
        n_chunks = -(-2 * LIGHT_H * LIGHT_H // ENV_CHUNK)
        check(env_launches == n_chunks * n_views,
              f"rank {rk['rank']} envmap launches {env_launches}")

    # ---- (d) the command line: one NCCL rank
    yaml = stage1_yaml(os.path.join(WORK, "mesh_cli.yaml"), scene,
                       os.path.join(WORK, "mesh_cli"), print_every=1)
    t0 = time.perf_counter()
    cli(["stage1-train", yaml, "--max-iters", str(MESH_CLI_STEPS),
         "--mesh-devices", "1", "--no-resume"])
    cli_s = time.perf_counter() - t0
    flat, scalars = load_checkpoint(os.path.join(WORK, "mesh_cli",
                                                 "checkpoints", "model.npz"))
    losses = [r["loss"] for r in read_losses(os.path.join(WORK, "mesh_cli"))]
    check(scalars["it"] == MESH_CLI_STEPS and len(losses) == MESH_CLI_STEPS
          and np.isfinite(losses).all(),
          f"stage1-train --mesh-devices 1: it {scalars}, losses {losses}")
    e2e = {"ranks": MESH_RANKS, "backend": "gloo", "device": "cuda:0",
           "errors": errs, "visibility_lift": lift,
           "launches": [rk["launches"] for rk in ranks],
           "walls_s": {"one_process": walls,
                       "ranks": [rk["wall_s"] for rk in ranks],
                       "launch": launch_s, "cli_mesh_devices_1": cli_s,
                       "phase": time.perf_counter() - t_phase},
           "cli": {"mesh_devices": 1, "backend": "nccl", "steps":
                   MESH_CLI_STEPS, "losses": losses},
           "card": card["nvidia_smi"]}
    log(json.dumps({"data_parallel": e2e}))
    total = lambda k: [sum(p[k] for p in rk["launches"].values())
                       for rk in ranks]
    return {k: total(k) for k in ranks[0]["launches"]["evaluate"]}, e2e


def first_step_stage1(r):
    """The runner's next training step as train runs it (on the rank's
    block under its mesh): the loss terms and every leaf's gradient,
    summed over the ranks."""
    from psnerf_torch.parallel import shard_noise, shard_stage1_batch
    from psnerf_torch.train.stage1 import field_params

    use_outside = r.it > r.tcfg.outside_after
    batch, noise = r.sample(use_outside)
    batch = shard_stage1_batch(batch, r.mesh)
    noise = shard_noise(noise, r.mesh)
    terms = r.step_fn(r.field, r.opt_state, batch, r.it, noise,
                      use_outside=use_outside)
    r.it += 1
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": {k: p.grad.cpu().numpy()
                      for k, p in field_params(r.field).items()}}


def first_step_stage2(r):
    """Stage 2's next training step as train runs it: its loss terms and
    gradients (summed over the ranks under a mesh), then the update."""
    from psnerf_torch.parallel import shard_noise, shard_stage2_batch

    batch, noise = r.sample()
    batch = shard_stage2_batch(batch, r.mesh)
    noise = shard_noise(noise, r.mesh)
    terms, grads = r.step_fn.loss_and_grads(r.params, batch, r.it, noise)
    r.step_fn(r.params, r.opt_state, batch, r.it, noise)
    r.it += 1
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": {k: g.cpu().numpy() for k, g in grads.items()}}


def train_errors(per_rank, want, bars):
    """Every rank's training run against one process's. The first step's
    loss terms (relative) and every leaf's gradient (of its max) at `bars`:
    the ranks' sums compose into the one-process step. The params after
    the run within Adam's flip bound, 2 lr a step (the rule of
    tests/test_torch_gpu.py's card-against-CPU step): Adam moves a param
    by about lr whatever its gradient's size, so a near-zero gradient
    whose rounding differs between the two summation orders moves it by
    up to 2 lr the other way; and at least MESH_PARAM_SHARE of each run's
    elements inside MESH_PARAM_BARS (tests/test_parallel.py's). The ranks
    agree bit for bit."""
    loss_rel, grad_rel = bars
    rep = {"loss_rel_err": 0.0, "grad_err_over_scale": 0.0,
           "param_max_abs_err": 0.0, "param_err_over_lr_steps": 0.0,
           "share_within_param_bars": 1.0}
    for got in per_rank:
        g1, w1 = got["first"], want["first"]
        check(g1["terms"].keys() == w1["terms"].keys(), "terms")
        for k, v in w1["terms"].items():
            if k in ("lr", "sg_lr"):
                continue
            e = abs(g1["terms"][k] - v) / (abs(v) + 1e-12)
            rep["loss_rel_err"] = max(rep["loss_rel_err"], e)
            check(e <= loss_rel, f"first step {k}: {e} relative")
        for k, v in w1["grads"].items():
            e = float(np.abs(g1["grads"][k] - v).max()
                      / (np.abs(v).max() + 1e-12))
            rep["grad_err_over_scale"] = max(rep["grad_err_over_scale"], e)
            check(e <= grad_rel, f"first step grad {k}: {e} of its max")
        n_in = n_all = 0
        for k, v in want["params"].items():
            lr = (want["lr"][k] if isinstance(want["lr"], dict)
                  else want["lr"])
            d = np.abs(got["params"][k] - v)
            bound = 2 * lr * want["steps"] * (1 + 1e-3)
            rep["param_max_abs_err"] = max(rep["param_max_abs_err"],
                                           float(d.max()))
            rep["param_err_over_lr_steps"] = max(
                rep["param_err_over_lr_steps"],
                float(d.max() / (lr * want["steps"])))
            check(d.max() <= bound, f"param {k}: {d.max()} > {bound}")
            n_in += int(np.isclose(got["params"][k], v,
                                   **MESH_PARAM_BARS).sum())
            n_all += d.size
        rep["share_within_param_bars"] = min(rep["share_within_param_bars"],
                                             n_in / n_all)
        check(n_in / n_all >= MESH_PARAM_SHARE,
              f"{n_in} of {n_all} param elements inside {MESH_PARAM_BARS}")
    rep["ranks_bitwise_equal"] = all(
        np.array_equal(per_rank[0]["params"][k], r["params"][k])
        for r in per_rank[1:] for k in want["params"])
    check(rep["ranks_bitwise_equal"], "ranks' params differ")
    return rep


# ---------------------------------------------- phase 16: multi-tensor Adam

def adam_sets():
    """One training step's adam_update calls on the card, at the default
    widths: {name: (params, [(lr, gate or None, leaf names) a call])}.
    Stage 1's field: 42 leaves, one call. Stage 2: the PSNet's 44 leaves
    (every head live) in one call, then each light table in its own under
    a row mask (train/stage2.py's calls), over the phase-6 scene's 2 train
    views x 96 lights with S2_LIGHTS lights of each view on."""
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.fields.psnet import PSNetConfig, init_psnet
    from psnerf_torch.train.optim import row_mask_from_indices
    from psnerf_torch.train.stage1 import field_params
    from psnerf_torch.train.stage2 import model_params

    gen = torch.Generator().manual_seed(SEED)
    copy = lambda d: {k: v.detach().clone() for k, v in d.items()}
    field = copy(field_params(init_occupancy_field(
        OccFieldConfig(), generator=gen, device=DEV)))
    psnet = copy(model_params(init_psnet(PSNetConfig(), generator=gen,
                                         device=DEV)))
    heads = list(psnet)
    rows = 2 * N_LIGHTS
    psnet["light_dirs"] = torch.randn(rows, 3, generator=gen).to(DEV)
    psnet["light_ints"] = (torch.rand(rows, 1, generator=gen) + 1.5).to(DEV)
    on = torch.cat([v * N_LIGHTS + torch.randperm(N_LIGHTS, generator=gen)[
        :S2_LIGHTS] for v in range(2)]).to(DEV)
    row = row_mask_from_indices(rows, on)
    return {"stage1": (field, [(5e-4, None, list(field))]),
            "stage2": (psnet, [(5e-4, None, heads),
                               (5e-3, {"light_dirs": row}, ["light_dirs"]),
                               (1e-3, {"light_ints": row}, ["light_ints"])])}


def phase_adam():
    """The multi-tensor Adam (ops/csrc/adam.cu, through adam_update)
    against adam_update_plain on the same params and gradients: p, m, v and
    step bit for bit over ADAM_STEPS steps of each set of adam_sets, two
    launches a call counted, no leaf on the plain loop; then a step of each
    route timed in turns: CUDA events, the profiler's device time, the host
    clock. Returns {set: numbers}."""
    from psnerf_torch.ops import adam
    from psnerf_torch.train.optim import (adam_init, adam_update,
                                          adam_update_plain)
    from psnerf_torch.utils import profiling

    out = {}
    for name, (params, calls) in adam_sets().items():
        gen = torch.Generator().manual_seed(SEED + 1)
        grads = [{k: torch.randn(p.shape, generator=gen).to(DEV)
                  for k, p in params.items()} for _ in range(ADAM_STEPS)]
        routes = {}
        for r, fn in (("kernel", adam_update), ("plain", adam_update_plain)):
            p = {k: v.clone() for k, v in params.items()}
            st = adam_init(p)
            sub = [({k: p[k] for k in names},
                    {part: {k: st[part][k] for k in names} for part in st},
                    lr, gate) for lr, gate, names in calls]
            routes[r] = (p, st, sub, fn)

        def step(r, g):
            _, _, sub, fn = routes[r]
            for p, st, lr, gate in sub:
                fn(p, g, st, lr, gate=gate)

        adam.fused_adam.launches = 0
        profiling.count("optim.fused_leaves", 0)    # off: a new session
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for g in grads:
                step("kernel", g)
            counted = profiling.counters()
        for g in grads:
            step("plain", g)
        torch.cuda.synchronize()
        launches = adam.fused_adam.launches
        (pk, sk, _, _), (pp, sp, _, _) = routes["kernel"], routes["plain"]
        differ = [k for k in pk if not torch.equal(pk[k], pp[k])] + [
            f"{part}/{k}" for part in ("m", "v", "step") for k in sk[part]
            if not torch.equal(sk[part][k], sp[part][k])]
        err = max((pk[k] - pp[k]).abs().max().item() for k in pk)
        steps = {k: int(sk["step"][k]) for k in ("light_dirs", "light_ints")
                 if k in sk["step"]}
        values = sum(p.numel() for p in params.values())
        res = {"leaves": len(params), "values": values,
               "calls_a_step": len(calls), "launches": launches,
               "fused_leaves": counted.get("optim.fused_leaves"),
               "plain_leaves": counted.get("optim.plain_leaves"),
               "bit_for_bit": not differ, "differ": differ[:8],
               "max_abs_err": err, "light_steps": steps,
               "bound_ms": values * ADAM_BYTES / PEAK_BYTES * 1e3,
               "bound_by": "bytes"}
        log(json.dumps({f"adam_{name}": res}))
        check(not differ, f"Adam {name}: kernel against plain {res}")
        check(launches == 2 * len(calls) * ADAM_STEPS,
              f"Adam {name}: two launches a call {res}")
        check(res["fused_leaves"] == len(params) * ADAM_STEPS
              and res["plain_leaves"] == 0, f"Adam {name}: routes {res}")

        # a step of each route, in turns
        fns = {r: (lambda r=r: step(r, grads[0])) for r in routes}
        order = ["plain", "kernel", "kernel", "plain"]
        ev = in_turns(fns, {"kernel": 20, "plain": 20}, order)
        dev = in_turns(fns, {"kernel": 20, "plain": 20}, order,
                       timer=device_ms)
        host = in_turns(fns, {"kernel": 200, "plain": 100}, order,
                        timer=host_us)
        res.update(ms=ev["kernel"], device_ms=dev["kernel"],
                   host_us=host["kernel"], plain_ms=ev["plain"],
                   plain_device_ms=dev["plain"], plain_host_us=host["plain"])
        log(json.dumps({f"adam_{name}": res}))
        out[name] = res
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
            regs = phase_build()
            k4, k5 = phase_kernels()
        k1, k2, k3, bstages = phase_stage1_kernels(card)
        k2f, k3f, stages = phase_radiance_f32()
        scene = make_scene()
        with torch.no_grad():
            launches, e2e, runner2 = phase_main_path(scene)
            launches_re, e2e_re, k5_env = phase_relight_edit(
                runner2, runner2._eval_data("test"))
        del runner2
        launches_s2, e2e_s2 = phase_stage2_train(scene)
        launches_bf, e2e_bf, _ = phase_stage1_main(scene, "bfloat16", 10, 5)
        launches1, e2e1, trained = phase_stage1_main(scene, "float32", 20, 10,
                                                     vis_every=10)
        e2e_export = phase_stage1_export(trained)
        e2e_protocols = phase_export_protocols(
            trained, dict(e2e_export["export"],
                          dir=os.path.join(WORK, "stage1_export")),
            card, k1["sass"])
        k1_mesh, e2e_mesh, k1_mise = phase_mesh(trained, card, k1["sass"])
        del trained
        e2e_cli = phase_cli(scene)
        e2e_pre = phase_preprocess(scene, e2e_cli)
        dp, e2e_dp = phase_data_parallel(scene, card)
        adam_rows = phase_adam()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    def entry(name, source, replaces, k, launches_n):
        return {"name": name, "route": "cuda",
                "source": f"psnerf_torch/ops/csrc/{source}",
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                "status": "ported", "flops": k["flops"],
                **{x: k[x] for x in ("modes", "n", "max_rel_err",
                                     "bound_peak", "bound_ffma_ms",
                                     "bound_tf32_single_ms", "random_sign",
                                     "rerun_bitwise_equal", "stages_ms",
                                     "err_is", "library_note",
                                     "at_64_samples", "at_secant_pass",
                                     "bound_parts", "sass", "rerun_bitwise",
                                     "slots", "slot_floats",
                                     "single_launch_ms",
                                     "launches_stage2_train", "device_ms",
                                     "host_us", "library_device_ms",
                                     "library_host_us", "meets_target",
                                     "corr_min", "colsum_rel_err",
                                     "bound_ops_ms", "bound_bytes_ms",
                                     "launches_mesh", "at_mise_batch",
                                     "launches_relight", "at_envmap_chunk",
                                     "launches_edit", "launches_cli",
                                     "at_guide_grid",
                                     "launches_export_protocols",
                                     "launches_data_parallel")
                   if x in k}}

    log(json.dumps({"card": card["nvidia_smi"], "main_path": e2e,
                    "stage2_train_main_path": e2e_s2,
                    "stage1_main_path_bfloat16": e2e_bf,
                    "stage1_main_path_float32": e2e1,
                    "stage1_eval_export": e2e_export,
                    "relight_edit": e2e_re, "mesh": e2e_mesh,
                    "export_protocols": e2e_protocols["protocols"],
                    "cli": e2e_cli, "preprocess": e2e_pre,
                    "data_parallel": e2e_dp,
                    "f32_workspace": stages["workspace"],
                    "bf16_workspace": bstages["workspace"], "ptxas": regs}))
    log(card["nvidia_smi"])
    cli_launches = lambda k: {c: r["launches"][k] for c, r in e2e_cli.items()
                              if "launches" in r}
    # K1 counts the default-field train path, K2/K3 each form's own path
    log(json.dumps({"kernels": [
        entry("fused_occ_logit", "fused_occ.cu",
              "psnerf_tpu/ops/fused_occ.py:113",
              dict(k1, launches_mesh=k1_mesh, at_mise_batch=k1_mise,
                   launches_cli=cli_launches("fused_occ_logit"),
                   at_guide_grid=e2e_protocols["at_guide_grid"],
                   launches_export_protocols=e2e_protocols["launches"],
                   launches_data_parallel=dp["fused_occ_logit"]),
              launches1["fused_occ_logit"]),
        entry("fused_radiance_and_alpha (forward)", "fused_radiance.cu",
              "psnerf_tpu/ops/fused_radiance.py:390",
              dict(k2, launches_data_parallel=dp["fused_radiance_fwd_bf16"]),
              launches_bf["fused_radiance_fwd"]["bfloat16"]),
        entry("fused_radiance_and_alpha (backward)", "fused_radiance.cu",
              "psnerf_tpu/ops/fused_radiance.py:410",
              dict(k3, launches_data_parallel=dp["fused_radiance_bwd_bf16"]),
              launches_bf["fused_radiance_bwd"]["bfloat16"]),
        *[entry(f"fused_radiance_and_alpha bf16 {name}",
                "slot_reduce.cuh" if kern == "reduce"
                else "fused_radiance.cu",
                "psnerf_tpu/ops/fused_radiance.py:410", bstages[kern],
                launches_bf["fused_radiance_slot_sum"] if kern == "reduce"
                else launches_bf["fused_radiance_bf16"][kern])
            for kern, name in (
              ("sweep", "backward sweep (writes the workspace and the "
               "column sums)"),
              ("wgrad", "weight-gradient products (split-K; folds the "
               "column sums)"),
              ("reduce", "reduce (the split-K slots in fixed order)"))],
        entry("fused_radiance_and_alpha (forward, f32 operands: prologue "
              "and forward kernel)", "fused_radiance_f32.cu",
              "psnerf_tpu/ops/fused_radiance.py:390",
              dict(k2f, launches_cli=cli_launches("fused_radiance_fwd_f32"),
                   launches_data_parallel=dp["fused_radiance_fwd_f32"]),
              launches1["fused_radiance_fwd"]["float32"]),
        entry("fused_radiance_and_alpha (backward, f32 operands: prologue, "
              "sweeps, weight-gradient passes, reduce)",
              "fused_radiance_f32.cu", "psnerf_tpu/ops/fused_radiance.py:410",
              dict(k3f, launches_cli=cli_launches("fused_radiance_bwd_f32"),
                   launches_data_parallel=dp["fused_radiance_bwd_f32"]),
              launches1["fused_radiance_bwd"]["float32"]),
        *[entry(f"fused_radiance_and_alpha f32 {name}",
                "slot_reduce.cuh" if kern == "reduce"
                else "fused_radiance_f32.cu",
                "psnerf_tpu/ops/fused_radiance.py:390 and :410" if kern ==
                "split" else "psnerf_tpu/ops/fused_radiance.py:410",
                stages[kern], launches1["fused_radiance_f32"][kern])
          for kern, name in (
              ("split", "weight split (prologue of forward and backward)"),
              ("sweep", "backward sweep (writes the workspace)"),
              ("wgrad", "weight-gradient products (split-K)"),
              ("reduce", "weight-gradient reduce (fixed order)"))],
        entry("fused_visibility", "fused_vis.cu",
              "psnerf_tpu/ops/fused_vis.py:219",
              dict(k4, launches_edit=launches_re["edit"]["fused_visibility"],
                   launches_cli=cli_launches("fused_visibility"),
                   launches_data_parallel=dp["fused_visibility"]),
              launches["fused_visibility"]),
        entry("fused_vis_shade", "fused_vis.cu",
              "psnerf_tpu/ops/fused_vis.py:387",
              dict(k5, launches_stage2_train=launches_s2["fused_vis_shade"],
                   launches_relight=launches_re["relight"]["fused_vis_shade"],
                   at_envmap_chunk=k5_env,
                   launches_cli=cli_launches("fused_vis_shade"),
                   launches_data_parallel=dp["fused_vis_shade"]),
              launches["fused_vis_shade"]),
        # replaces no TPU kernel: XLA fuses the JAX package's Adam into its
        # train step; the port's plain route is adam_update_plain
        {"name": "adam (multi-tensor: step bump, update)", "route": "cuda",
         "source": "psnerf_torch/ops/csrc/adam.cu", "replaces": None,
         "status": "port_only", "launches": launches1["fused_adam"],
         "launches_stage2_train": launches_s2["fused_adam"],
         "max_abs_err": adam_rows["stage1"]["max_abs_err"],
         **{k: adam_rows["stage1"][k] for k in (
             "ms", "device_ms", "host_us", "plain_ms", "plain_device_ms",
             "plain_host_us", "bound_ms", "bound_by", "values")},
         "at_stage2": adam_rows["stage2"]}], "not_ported": []}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
