"""Full-frame stage-2 rendering (counterpart of psnerf_tpu/eval/frame.py).

Every pixel under every light. Per-point heads run once per pixel; only the
per-(light, pixel) shading and visibility MLP scale with L.

Routing, as in the JAX package: with use_fused_vis and outputs that the
shading kernel can serve (rgb, rgb_cnl, rgb_sum and per-point heads), the
whole frame is one fused_vis_shade launch. Otherwise, with use_fused_vis,
fused_visibility computes the raw [L, N] visibility in one launch and the
shading runs in plain PyTorch over pixel tiles; without it the visibility
MLP runs in plain PyTorch too. Material edits (albedo_new, basis_new)
never take the shading kernel: with use_fused_vis they keep
fused_visibility's precompute and shade in plain PyTorch.
"""

from __future__ import annotations

from functools import partial

import torch

from psnerf_torch.core.encoding import nerf_embed
from psnerf_torch.core.rays import get_camera_params
from psnerf_torch.fields.psnet import PSNet, PSNetConfig
from psnerf_torch.ops.fused_vis import fused_vis_shade, fused_visibility
from psnerf_torch.render.shading import psnet_point_heads, render_psnet

# outputs the single-kernel vis+shade path can serve
_FUSED_SHADE_OUTPUTS = frozenset(
    {"rgb", "rgb_cnl", "rgb_sum", "albedo", "sg_weight", "normal_pred"})
# outputs of render_psnet that carry a leading light axis
_PER_LIGHT = frozenset({"rgb", "visibility"})


def _render_frame_fused_shade(model, cfg, ray_dirs, points, normals,
                              surface_mask, light_dirs, light_ints,
                              outputs) -> dict:
    heads = psnet_point_heads(model, cfg, points, normals)
    light_emb = nerf_embed(light_dirs, cfg.n_freqs_xyz)
    mask1 = surface_mask[:, None]
    one = torch.ones((), dtype=points.dtype, device=points.device)

    res = {}
    want_rgb = "rgb" in outputs
    want_cnl = "rgb_cnl" in outputs
    want_sum = "rgb_sum" in outputs
    if want_rgb or want_cnl or want_sum:
        sum_only = want_sum and not (want_rgb or want_cnl)
        out = fused_vis_shade(
            model["visibility"], heads["point_emb"], light_emb,
            heads["normal"], -ray_dirs, heads["albedo"], heads["weights"],
            surface_mask, light_dirs, light_ints,
            nbasis=cfg.nbasis, specular_rgb=cfg.specular_rgb,
            sum_lights=sum_only,
            layout="cnl" if want_cnl and not want_rgb else "lnc")
        if sum_only:
            res["rgb_sum"] = out
        elif want_rgb:
            res["rgb"] = out
            if want_cnl:
                res["rgb_cnl"] = out.permute(2, 1, 0)
            if want_sum:
                res["rgb_sum"] = out.sum(dim=0)
        else:
            res["rgb_cnl"] = out                            # [3, N, L]
            if want_sum:
                res["rgb_sum"] = out.sum(dim=2).T
    if "albedo" in outputs:
        res["albedo"] = torch.where(mask1, heads["albedo"], one)
    if "sg_weight" in outputs:
        res["sg_weight"] = torch.where(mask1, heads["weights"], 0.0 * one)
    if "normal_pred" in outputs and cfg.normal_mlp:
        res["normal_pred"] = torch.where(mask1, heads["normal_pred"], one)
    return {k: res[k] for k in outputs if k in res}


@torch.no_grad()
def render_frame_stage2(
    model: PSNet,
    cfg: PSNetConfig,
    uv: torch.Tensor,            # [N, 2] all frame pixels
    pose: torch.Tensor,
    intrinsics: torch.Tensor,
    points: torch.Tensor,        # [N, 3]
    normals: torch.Tensor,       # [N, 3]
    surface_mask: torch.Tensor,  # [N] bool
    light_dirs: torch.Tensor,    # [L, 3]
    light_ints: torch.Tensor,    # [L] (or [L, 3])
    tile: int = 4096,
    outputs: tuple = ("rgb",),
    use_fused_vis: bool = False,
    albedo_new=None,
    basis_new: int | None = None,
) -> dict:
    """Render every pixel under every light. N must be divisible by `tile`
    (callers pad the frame). Returns {name: [L, N, ...] or [N, ...]};
    rgb_cnl is rgb as [3, N, L] and rgb_sum its light sum [N, 3].
    albedo_new / basis_new: material edits (stage2/eval.py:233-312)."""
    n = uv.shape[0]
    if n % tile:
        raise ValueError(f"pixel count {n} not divisible by tile {tile}")
    ray_dirs, _ = get_camera_params(uv, pose, intrinsics)

    if (use_fused_vis and cfg.visibility and cfg.render_model == "sgbasis"
            and set(outputs) <= _FUSED_SHADE_OUTPUTS
            and albedo_new is None and basis_new is None):
        return _render_frame_fused_shade(
            model, cfg, ray_dirs, points, normals, surface_mask,
            light_dirs, light_ints, outputs)

    vis_pre = None
    if use_fused_vis and cfg.visibility:
        vis_pre = fused_visibility(
            model["visibility"], nerf_embed(points, cfg.n_freqs_xyz),
            nerf_embed(light_dirs, cfg.n_freqs_xyz))[..., None]  # [L, N, 1]

    per_light = set(_PER_LIGHT)
    if cfg.render_model == "sgbasis":
        per_light.add("rough")
    keys = [k for k in outputs if k not in ("rgb_sum", "rgb_cnl")]
    if ("rgb_sum" in outputs or "rgb_cnl" in outputs) and "rgb" not in keys:
        keys.append("rgb")
    parts = {k: [] for k in keys}
    for s in range(0, n, tile):
        sl = slice(s, s + tile)
        out = render_psnet(
            model, cfg, points[sl], normals[sl], surface_mask[sl],
            ray_dirs[sl], light_dirs, light_ints,
            vis_precomputed=None if vis_pre is None else vis_pre[:, sl],
            albedo_new=albedo_new, basis_new=basis_new)
        for k in keys:
            parts[k].append(out[k])
    merged = {k: torch.cat(v, dim=1 if k in per_light else 0)
              for k, v in parts.items()}
    if "rgb_sum" in outputs:
        merged["rgb_sum"] = merged["rgb"].sum(dim=0)
    if "rgb_cnl" in outputs:
        merged["rgb_cnl"] = merged["rgb"].permute(2, 1, 0)
    return {k: merged[k] for k in outputs if k in merged}


def make_frame_renderer(cfg: PSNetConfig, tile: int = 4096,
                        outputs: tuple = ("rgb",),
                        use_fused_vis: bool = False):
    """Closure over the static config:
    fn(model, uv, pose, K, pts, nrm, msk, light_dirs, light_ints)."""
    fn = partial(render_frame_stage2, tile=tile, outputs=outputs,
                 use_fused_vis=use_fused_vis)
    return lambda model, uv, pose, K, pts, nrm, msk, ld, li: fn(
        model, cfg, uv, pose, K, pts, nrm, msk, ld, li)
