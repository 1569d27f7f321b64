"""Stage-1 training step (counterpart of psnerf_tpu/train/stage1.py): render
a ray batch, compute the loss, backpropagate (second order through the
analytic normals), Adam-update. The MultiStepLR schedule and the
normal-supervision gate (`it >= normal_after`) are functions of the
iteration counter; `use_outside` (it > 5000) switches the sample grid.
Nothing on the step's path reads a device value back to the host. Its
phases are the spans stage1.forward, stage1.backward and stage1.optim."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from psnerf_torch.fields.occupancy import OccFieldConfig
from psnerf_torch.ops.fused_occ import make_fused_occ_fn
from psnerf_torch.ops.fused_radiance import fused_radiance_and_alpha
from psnerf_torch.parallel.mesh import all_reduce_grads, as_mesh, world_sum
from psnerf_torch.render.unisurf import UnisurfConfig, render_unisurf
from psnerf_torch.train.losses import Stage1LossWeights, stage1_loss
from psnerf_torch.train.optim import adam_init, adam_update, multistep_lr
from psnerf_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class Stage1TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    # through Stage1Runner these are EPOCH units (scaled by the number of
    # views); make_stage1_train_step treats them as iterations
    milestone_iters: Sequence[int] = (60000, 120000)
    gamma: float = 0.5
    n_training_points: int = 2048
    normal_after: int = 1000
    outside_after: int = 5000   # switch to steps+steps_outside grid
    weights: Stage1LossWeights = Stage1LossWeights()


def field_params(field) -> dict:
    """{`/`-joined name: parameter} of a field, the optimizer's keys."""
    return {k.replace(".", "/"): p for k, p in field.named_parameters()}


def make_stage1_train_step(field_cfg: OccFieldConfig, rcfg: UnisurfConfig,
                           tcfg: Stage1TrainConfig,
                           use_fused_occ: bool = False,
                           use_fused_radiance: bool = False, mesh=None):
    """Returns (init_opt_state, step) with

      step(field, opt_state, batch, it, noise, use_outside) -> terms

    which updates the field's parameters and opt_state in place and returns
    the loss terms and lr as device tensors. batch: pixels [N, 2], rgb_gt
    [N, 3], camera_mat [4, 4], world_mat [4, 4], normal_gt [N, 3] (world
    frame), norm_mask [N] bool, mask_gt [N], mask_valid [N] bool. noise: the
    render's U(0, 1) draws (render.unisurf.draw_unisurf_noise).
    use_fused_occ: the march's occupancy queries go through the fused_occ
    kernel; use_fused_radiance: the integration batch (forward and
    backward) goes through the fused_radiance kernels.

    mesh (psnerf_torch.parallel; None: one device, the one-rank mesh, on
    which the block is the batch and no collective runs): the batch and
    noise are this rank's block (shard_stage1_batch, shard_noise) and the
    parameters and opt_state are replicated; the losses divide by global
    counts, every leaf's gradient is summed over the ranks by one
    all-reduce before Adam, which then runs identically on every rank, and
    the returned terms are summed over the ranks (the single-device
    values). The kernels run on the rank's block, with no collective
    inside."""
    mesh = as_mesh(mesh)
    compute = ("bfloat16" if field_cfg.compute_dtype == "bfloat16"
               else "float32")

    def init(field):
        return adam_init(field_params(field))

    @torch.enable_grad()
    def step(field, opt_state, batch, it, noise, use_outside=True):
        with profiling.span("stage1.forward"):
            occ_fn = radiance_fn = None
            if use_fused_occ:
                occ_fn = make_fused_occ_fn(field, field_cfg)
            if use_fused_radiance:
                radiance_fn = lambda p, rd: fused_radiance_and_alpha(
                    field, p, rd, field_cfg, compute=compute)
            params = field_params(field)
            for p in params.values():
                p.grad = None
            out = render_unisurf(
                field, field_cfg, rcfg, batch["pixels"],
                batch["camera_mat"], batch["world_mat"], it=float(it),
                noise=noise, use_outside=use_outside, train=True,
                occ_fn=occ_fn, radiance_fn=radiance_fn)
            # SDPS-normal supervision starts at normal_after
            norm_mask = batch["norm_mask"] & (it >= tcfg.normal_after)
            terms = stage1_loss(out, batch["rgb_gt"], tcfg.weights,
                                normal_gt=batch.get("normal_gt"),
                                norm_mask=norm_mask,
                                mask_gt=batch.get("mask_gt"),
                                mask_valid=batch.get("mask_valid"),
                                mesh=mesh)
        with profiling.span("stage1.backward"):
            terms["loss"].backward()
            all_reduce_grads([p.grad for p in params.values()], mesh)
        with profiling.span("stage1.optim"):
            lr = multistep_lr(tcfg.learning_rate, tcfg.milestone_iters,
                              tcfg.gamma, it)
            adam_update(params, {k: p.grad for k, p in params.items()},
                        opt_state, lr)
        terms = {k: world_sum(v.detach(), mesh) for k, v in terms.items()}
        terms["lr"] = torch.tensor(lr, dtype=torch.float32)
        return terms

    return init, step
