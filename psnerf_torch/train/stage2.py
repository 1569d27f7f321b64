"""Stage-2 training (counterpart of psnerf_tpu/train/stage2.py): joint
SVBRDF, normal, visibility and light optimisation, one step at a time.

  * The light directions and intensities are tables [Ltot, 3] / [Ltot, 1]
    beside the PSNet; SparseAdam's behaviour (only the rows gathered this
    step update) is a row gate on the Adam update.
  * The train_fix warm-up (it < warmup_iters: rgb and smoothness weights
    0, visibility weight warmup_vis_weight, albedo, rough and lights
    frozen) is decided on the host from the iteration counter, which the
    runner keeps there; frozen leaves are gates of 0.
  * The MultiStepLR milestones are iterations (the runner converts the
    configured epochs).

The step updates the parameters and the optimizer state in place and
returns the loss terms as device tensors: nothing on its path reads a
device value back to the host. Its phases are the spans stage2.forward,
stage2.backward (both in loss_and_grads) and stage2.optim.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from psnerf_torch.core.rays import get_camera_params
from psnerf_torch.fields.psnet import PSNet, PSNetConfig
from psnerf_torch.parallel.mesh import (LIGHT_AXIS, all_reduce_grads, all_sum,
                                        world_sum)
from psnerf_torch.render.shading import render_psnet
from psnerf_torch.train.losses import Stage2LossWeights, stage2_loss
from psnerf_torch.train.optim import (adam_init, adam_update, multistep_lr,
                                      row_mask_from_indices)
from psnerf_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class Stage2TrainConfig:
    sg_learning_rate: float = 5e-4
    light_learning_rate: float = 5e-4
    light_inten_lr: float = 1e-3
    milestone_iters: Sequence[int] = ()
    gamma: float = 0.5
    light_train: bool = True
    light_inten_train: bool = True
    light_decay: bool = True
    train_order: bool = True
    warmup_iters: int = 5000
    warmup_vis_weight: float = 10.0
    ana_fixlight: bool = False
    weights: Stage2LossWeights = Stage2LossWeights()


def init_stage2_params(model: PSNet, light_dirs_init, light_ints_init,
                       device: str | torch.device = "cpu") -> dict:
    """{model, light_dirs [Ltot, 3], light_ints [Ltot, 1]}: the tree whose
    leaves are the checkpoint's `params/...` keys. The light tables are
    copies of the inputs: the train step updates them in place."""
    f32 = torch.float32
    return {
        "model": model,
        "light_dirs": torch.tensor(np.asarray(light_dirs_init), dtype=f32,
                                   device=device),
        "light_ints": torch.tensor(np.asarray(light_ints_init), dtype=f32,
                                   device=device).reshape(-1, 1),
    }


def model_params(model: PSNet) -> dict:
    """{`/`-joined name: parameter} of a PSNet, the optimizer's keys."""
    return {k.replace(".", "/"): p for k, p in model.named_parameters()}


def _light_state(state: dict, name: str) -> dict:
    """A light table's {m, v, step} (tensors) as adam_update's keyed state."""
    return {k: {name: v} for k, v in state.items()}


def make_stage2_train_step(cfg: PSNetConfig, tcfg: Stage2TrainConfig,
                           mesh=None):
    """Returns (init_opt_state, step) with

      step(params, opt_state, batch, it, noise) -> terms

    which updates params ({model, light_dirs, light_ints}) and opt_state
    ({model: {m, v, step}, light_dirs: {m, v, step}, light_ints: ...}, the
    JAX package's tree) in place and returns the loss terms as device
    tensors and sg_lr. batch: uv [N, 2], pose [4, 4], intrinsics, object_mask
    [N] bool, points / normal [N, 3], surface_mask [N] bool, rgb_gt
    [L, N, 3], l_slt [L] (rows of the light tables), visibility [L, N] or
    absent, light_vis_train [Lv, 3] (+ vis_train_gt [Lv, N]) or absent.
    it: the host iteration counter. noise: render_psnet's jitter draws
    (draw_psnet_noise). step.loss_and_grads(params, batch, it, noise) gives
    the terms and the gradients of the same batch without the update.

    mesh (psnerf_torch.parallel): the batch and noise are this rank's block
    (shard_stage2_batch, shard_noise) and params and opt_state are replicated. The losses divide
    by global counts; loss_and_grads sums the gradients over the ranks by
    one all-reduce and the terms likewise (the single-device values), and
    the light tables' row gate is the union of the ranks' rows, so Adam
    runs identically on every rank."""
    w = tcfg.weights
    in_warmup = lambda it: it < tcfg.warmup_iters and tcfg.train_order

    def init_opt_state(params: dict) -> dict:
        light = lambda t: {k: v[""] for k, v in adam_init({"": t}).items()}
        return {"model": adam_init(model_params(params["model"])),
                "light_dirs": light(params["light_dirs"]),
                "light_ints": light(params["light_ints"])}

    def loss_and_grads(params: dict, batch: dict, it, noise: dict):
        """(loss terms, {model leaf name or light table: gradient}) of one
        batch; params are not changed."""
        warm = in_warmup(it)
        live = 0.0 if warm else 1.0
        mp = model_params(params["model"])
        tables = {k: params[k].detach().requires_grad_(True)
                  for k in ("light_dirs", "light_ints")}
        with torch.enable_grad():
            with profiling.span("stage2.forward"):
                l_slt = batch["l_slt"]
                ldirs = tables["light_dirs"][l_slt]
                ldirs = ldirs / torch.clamp_min(
                    torch.linalg.norm(ldirs, dim=-1, keepdim=True), 1e-12)
                lints = tables["light_ints"][l_slt][:, 0]
                ray_dirs, _ = get_camera_params(batch["uv"], batch["pose"],
                                                batch["intrinsics"])
                out = render_psnet(
                    params["model"], cfg, batch["points"], batch["normal"],
                    batch["surface_mask"], ray_dirs, ldirs, lints,
                    noise=noise,
                    light_vis_train=batch.get("light_vis_train"))
                override = {
                    "sg_rgb_weight": live * w.sg_rgb_weight,
                    "albedo_smooth_weight": live * w.albedo_smooth_weight,
                    "rough_smooth_weight": live * w.rough_smooth_weight,
                    "vis_weight": (tcfg.warmup_vis_weight if warm
                                   else w.vis_weight)}
                terms = stage2_loss(out, batch["rgb_gt"],
                                    batch["object_mask"], w,
                                    vis_gt=batch.get("visibility"),
                                    vis_train_gt=batch.get("vis_train_gt"),
                                    weights_override=override, mesh=mesh)
            with profiling.span("stage2.backward"):
                leaves = {**mp, **tables}
                grads = torch.autograd.grad(terms["loss"],
                                            list(leaves.values()),
                                            allow_unused=True)
                grads = {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(leaves.items(), grads)}
                if mesh is not None:
                    all_reduce_grads(list(grads.values()), mesh)
        return {k: world_sum(v.detach(), mesh) for k, v in terms.items()}, \
            grads

    def step(params: dict, opt_state: dict, batch: dict, it, noise: dict):
        terms, grads = loss_and_grads(params, batch, it, noise)
        with profiling.span("stage2.optim"):
            live = 0.0 if in_warmup(it) else 1.0
            mp = model_params(params["model"])
            # aliases of the light tables' storage, updated in place
            tables = {k: params[k].detach()
                      for k in ("light_dirs", "light_ints")}
            l_slt = batch["l_slt"]

            # gates: albedo and rough frozen in the warm-up; the normal
            # net frozen when it is not trained jointly; light rows by this
            # step's gather, the warm-up, ana_fixlight and
            # light_(inten_)train
            gate = {}
            for k in mp:
                head = k.split("/")[0]
                gate[k] = (live if head in ("albedo", "rough")
                           else 0.0 if head == "normal"
                           and not cfg.normal_joint else 1.0)
            light_live = live * float(not tcfg.ana_fixlight)
            row = row_mask_from_indices(tables["light_dirs"].shape[0],
                                        l_slt)
            if mesh is not None:             # the rows of the whole batch
                row = (all_sum(row, mesh.groups[LIGHT_AXIS]) > 0).float()
            lr_sg = multistep_lr(tcfg.sg_learning_rate,
                                 tcfg.milestone_iters, tcfg.gamma, it)
            lr_l, lr_i = tcfg.light_learning_rate, tcfg.light_inten_lr
            if tcfg.light_decay:
                lr_l = multistep_lr(lr_l, tcfg.milestone_iters, tcfg.gamma,
                                    it)
                lr_i = multistep_lr(lr_i, tcfg.milestone_iters, tcfg.gamma,
                                    it)

            adam_update(mp, grads, opt_state["model"], lr_sg, gate=gate)
            for name, lr, on in (
                    ("light_dirs", lr_l, tcfg.light_train),
                    ("light_ints", lr_i, tcfg.light_inten_train)):
                adam_update({name: tables[name]}, grads,
                            _light_state(opt_state[name], name), lr,
                            gate={name: row if light_live * on else 0.0})
        terms["sg_lr"] = torch.tensor(lr_sg, dtype=torch.float32)
        return terms

    step.loss_and_grads = loss_and_grads
    return init_opt_state, step


def light_direction_error_deg(light_dirs: torch.Tensor,
                              gt_dirs: torch.Tensor) -> torch.Tensor:
    """Mean angle between the light directions and the ground truth, in
    degrees."""
    unit = lambda d: d / torch.clamp_min(
        torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    dot = torch.clamp(torch.sum(unit(light_dirs) * unit(gt_dirs), dim=-1),
                      -1.0, 1.0)
    return torch.mean(torch.rad2deg(torch.arccos(dot)))
