"""Training losses (counterpart of psnerf_tpu/train/losses.py), as
functions of dense masked tensors: every boolean-mask reduction
`x[mask].mean()` is sum(x * m) / max(sum(m), 1), so no step reads a value
back to the host.

Under a mesh (psnerf_torch.parallel) each rank holds a block of the batch
and divides its LOCAL sum by the GLOBAL count: the counts come from masks
and shapes, are summed over every rank and detached. The sum of the ranks'
terms, and of their gradients, is then the single-device value whatever
the masks hold. (A rank's local mean would weight the blocks equally, and
an autograd-aware all-reduce of the loss would scale every gradient by the
rank count.) On a rays x lights mesh the ranks of one ray row hold the same
pixels: a per-pixel term counts them on every such rank, in its numerator
and its count alike, so the ratio holds.
"""

from __future__ import annotations

import dataclasses

import torch

from psnerf_torch.parallel.mesh import world_sum


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Mean of x over the elements where mask is set (mask broadcasts over
    x's trailing dims); 0.0 for an empty mask. mesh: this rank's share of
    the mean over every rank's elements."""
    mask = mask.to(x.dtype)
    while mask.ndim < x.ndim:
        mask = mask[..., None]
    num = torch.sum(x * mask)
    den = world_sum(torch.sum(mask.expand(x.shape)), mesh)
    return torch.where(den > 0, num / torch.clamp_min(den, 1.0), 0.0)


@dataclasses.dataclass(frozen=True)
class Stage1LossWeights:
    lambda_rgb: float = 1.0        # full_weight
    lambda_smooth: float = 0.005   # grad_weight (normal smoothness)
    lambda_normal: float = 0.05    # norm_weight (SDPS normal supervision)
    lambda_mask: float = 1.0       # mask_weight (BCE on acc)
    use_mask_loss: bool = False


def stage1_loss(out: dict, rgb_gt: torch.Tensor, w: Stage1LossWeights,
                normal_gt: torch.Tensor | None = None,
                norm_mask: torch.Tensor | None = None,
                mask_gt: torch.Tensor | None = None,
                mask_valid: torch.Tensor | None = None, mesh=None) -> dict:
    """Loss terms of a stage-1 batch of N rays; the caller gates the
    normal supervision by iteration and angle (norm_mask). mesh: this
    rank's share of the terms of every rank's rays (every rank holds as
    many)."""
    size = 1 if mesh is None else mesh.size
    n = rgb_gt.shape[0] * size
    rgb_loss = torch.sum(torch.abs(out["rgb"] - rgb_gt)) / n    # L1(sum)/N
    diff_norm = out.get("diff_norm")
    smooth_loss = (torch.sum(diff_norm) / (diff_norm.numel() * size)
                   if diff_norm is not None
                   else torch.zeros((), device=rgb_gt.device))
    loss = w.lambda_rgb * rgb_loss + w.lambda_smooth * smooth_loss
    terms = {"fullrgb_loss": rgb_loss, "grad_loss": smooth_loss}

    if normal_gt is not None and norm_mask is not None:
        m = norm_mask.to(rgb_gt.dtype)
        diff = torch.sum(torch.abs(out["normal_pred"] - normal_gt), dim=-1)
        cnt = world_sum(torch.sum(m), mesh)
        normal_loss = torch.where(cnt > 0, torch.sum(diff * m) /
                                  torch.clamp_min(cnt, 1.0), 0.0)
        loss = loss + w.lambda_normal * normal_loss
        terms["normal_loss"] = normal_loss

    if w.use_mask_loss and mask_gt is not None:
        acc = torch.clamp(out["acc_map"], 1e-7, 1 - 1e-7)
        bce = -(mask_gt * torch.log(acc) + (1 - mask_gt) * torch.log(1 - acc))
        mv = (mask_valid.to(acc.dtype) if mask_valid is not None
              else torch.ones_like(acc))
        mask_loss = torch.sum(bce * mv) / torch.clamp_min(
            world_sum(torch.sum(mv), mesh), 1.0)
        loss = loss + w.lambda_mask * mask_loss
        terms["mask_loss"] = mask_loss

    terms["loss"] = loss
    return terms


@dataclasses.dataclass(frozen=True)
class Stage2LossWeights:
    sg_rgb_weight: float = 1.0
    loss_type: str = "L1"          # 'L1' | 'L2'
    albedo_smooth_weight: float = 0.05
    rough_smooth_weight: float = 0.01
    vis_weight: float = 1.0
    normal_weight: float = 1.0
    normal_smooth_weight: float = 0.05


def stage2_loss(out: dict, rgb_gt: torch.Tensor, object_mask: torch.Tensor,
                w: Stage2LossWeights, vis_gt: torch.Tensor | None = None,
                vis_train_gt: torch.Tensor | None = None,
                weights_override: dict | None = None, mesh=None) -> dict:
    """Loss terms of a stage-2 batch: rgb [L, N, 3] against rgb_gt, the
    albedo and SG-weight smoothness of the jittered heads, the visibility
    supervision (vis_train against the vis_plus ground truth, else
    vis_train against the stage-1 visibility vis_gt [L, N], else the
    rendering lights' visibility against vis_gt) and the normal terms.
    weights_override may replace sg_rgb_weight, albedo_smooth_weight,
    rough_smooth_weight and vis_weight (the warm-up's values). mesh: this
    rank's share of the terms of every rank's block."""
    ww = {"sg_rgb_weight": w.sg_rgb_weight,
          "albedo_smooth_weight": w.albedo_smooth_weight,
          "rough_smooth_weight": w.rough_smooth_weight,
          "vis_weight": w.vis_weight}
    if weights_override:
        ww.update(weights_override)

    mask = out["network_object_mask"] & object_mask                # [N]
    err = out["rgb"] - rgb_gt
    per_elem = torch.abs(err) if w.loss_type == "L1" else err ** 2
    rgb_loss = masked_mean(per_elem, mask[None, :], mesh)
    loss = ww["sg_rgb_weight"] * rgb_loss
    terms = {"sg_rgb_loss": rgb_loss}

    if "albedo_jitter" in out:
        al = masked_mean(torch.abs(out["albedo"] - out["albedo_jitter"]),
                         mask, mesh)
        loss = loss + ww["albedo_smooth_weight"] * al
        terms["albedo_smooth_loss"] = al
    if "rough_jitter" in out:
        rl = masked_mean(torch.abs(out["sg_weight"] - out["rough_jitter"]),
                         mask, mesh)
        loss = loss + ww["rough_smooth_weight"] * rl
        terms["rough_smooth_loss"] = rl

    vis_pred = vis_ref = None
    if "vis_train" in out and vis_train_gt is not None:
        vis_pred, vis_ref = out["vis_train"], vis_train_gt
    elif "vis_train" in out and vis_gt is not None:
        vis_pred, vis_ref = out["vis_train"], vis_gt
    elif vis_gt is not None:
        vis_pred, vis_ref = out["visibility"][..., 0], vis_gt
    if vis_pred is not None:
        vl = masked_mean(torch.abs(vis_pred - vis_ref), mask[None, :], mesh)
        loss = loss + ww["vis_weight"] * vl
        terms["vis_loss"] = vl

    if "normal_pred" in out:
        ngt = out["normal_values"]
        ngt = ngt / torch.clamp_min(
            torch.linalg.norm(ngt, dim=-1, keepdim=True), 1e-12)
        nl = masked_mean((out["normal_pred"] - ngt) ** 2, mask, mesh)
        loss = loss + w.normal_weight * nl
        terms["normal_loss"] = nl
        if "normal_jitter" in out:
            ns = masked_mean(
                torch.abs(out["normal_pred"] - out["normal_jitter"]), mask,
                mesh)
            loss = loss + w.normal_smooth_weight * ns
            terms["normal_smooth_loss"] = ns

    terms["loss"] = loss
    return terms
