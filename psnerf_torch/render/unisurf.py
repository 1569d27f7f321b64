"""UNISURF-style surface+volume hybrid renderer for stage 1 (counterpart of
psnerf_tpu/render/unisurf.py `render_unisurf` and `render_shape_extract`).

  * one dense batch: every ray evaluates the same sample grid; hit and miss
    rays select their depth schedule with torch.where;
  * `use_outside` (the caller's `it > 5000` switch) adds steps between
    near and the surface interval;
  * normals and their jittered duplicates for the smoothness loss are
    computed for all rays; the loss masks them.

Randomness is explicit: `noise` is None for the deterministic eval path, or
a dict of U(0, 1) draws (see `draw_unisurf_noise`).
"""

from __future__ import annotations

import dataclasses

import torch

from psnerf_torch.core.compositing import alpha_composite
from psnerf_torch.core.rays import (get_sphere_intersection,
                                    image_points_to_ray, origin_to_world)
from psnerf_torch.core.sampling import linspace_between, stratified_noise
from psnerf_torch.fields.occupancy import (OccFieldConfig, occ_alpha,
                                           occ_gradient, radiance_and_alpha)
from psnerf_torch.render.marching import light_visibility, ray_marching


@dataclasses.dataclass(frozen=True)
class UnisurfConfig:
    near: float = 28.0
    far: float = 35.0
    radius: float = 2.0
    interval_start: float = 2.0
    interval_end: float = 0.1
    interval_decay: float = 1.5e-5
    num_points_in: int = 64       # steps inside the adaptive interval
    num_points_out: int = 32      # extra steps between near and the interval
    ray_marching_steps: int = 256
    white_background: bool = True


def draw_unisurf_noise(n_rays: int, n_samples: int,
                       generator: torch.Generator,
                       device: str | torch.device) -> dict:
    """The draws of one training render, all U(0, 1): the march's phase
    shift (scalar), the hit and miss stratified noise [N, S] and the normal
    jitter [N, 3] (used as (u - 0.5) * 0.01). `generator` lives on
    `device`."""
    u = lambda *shape: torch.rand(shape, generator=generator, device=device)
    return {"phase": u(), "hit": u(n_rays, n_samples),
            "miss": u(n_rays, n_samples), "jitter": u(n_rays, 3)}


def _march_and_surface(field, field_cfg, rcfg, pixels, camera_mat, world_mat,
                       n_steps, phase=None, occ_fn=None):
    """Rays, the root-finding march, surface points and masks."""
    n = pixels.shape[0]
    cam = origin_to_world(n, world_mat)
    ray = image_points_to_ray(pixels, camera_mat, world_mat)
    ray = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    if occ_fn is None:
        occ_fn = lambda p: occ_alpha(field, p, field_cfg)
    d_i = ray_marching(occ_fn, cam, ray, n_steps=n_steps, near=rcfg.near,
                       rad=rcfg.radius, phase=phase)
    mask_zero_occupied = d_i == 0
    mask_pred = torch.isfinite(d_i)
    surface_mask = mask_pred & ~mask_zero_occupied
    dists = torch.where(mask_pred, d_i, 1.0)
    dists = torch.where(mask_zero_occupied, 0.0, dists)
    points = cam + ray * dists[..., None]
    return cam, ray, dists, points, surface_mask


def render_unisurf(field, field_cfg: OccFieldConfig, rcfg: UnisurfConfig,
                   pixels: torch.Tensor, camera_mat: torch.Tensor,
                   world_mat: torch.Tensor, it: float = 1e5,
                   noise: dict | None = None, use_outside: bool = True,
                   train: bool = True, occ_fn=None,
                   radiance_fn=None) -> dict:
    """Volumetric render with surface-adaptive sampling of pixels [N, 2].

    occ_fn: optional occupancy closure for the no-grad march (the fused
    kernel of psnerf_torch.ops.fused_occ). radiance_fn: optional
    (p, ray_d) -> (rgb, alpha) for the grad-tracked integration batch (the
    fused kernel pair of psnerf_torch.ops.fused_radiance).
    Returns rgb [N, 3], mask_pred [N] bool, normal_pred [N, 3], diff_norm
    [N] (train, else None), acc_map [N], points [N, 3]."""
    if train and noise is None:
        raise ValueError("a training render needs its noise draws")
    steps, steps_out = rcfg.num_points_in, rcfg.num_points_out
    full_steps = steps + steps_out if use_outside else steps
    noise = noise or {}

    cam, ray, dists, points, surface_mask = _march_and_surface(
        field, field_cfg, rcfg, pixels, camera_mat, world_mat,
        rcfg.ray_marching_steps, phase=noise.get("phase"), occ_fn=occ_fn)
    n = pixels.shape[0]

    depth_intersect, _ = get_sphere_intersection(cam[0], ray, r=rcfg.radius)
    d_sphere_far = depth_intersect[..., 1]

    # adaptive interval width, decaying over training
    it = torch.as_tensor(it, dtype=torch.float32, device=pixels.device)
    delta = torch.clamp_min(
        rcfg.interval_start * torch.exp(-rcfg.interval_decay * it),
        rcfg.interval_end)

    # hit rays: steps in [dnp, dfp] (+ steps_out in [near, dnp])
    dnp = torch.clamp_min(dists - delta, rcfg.near)
    dfp = torch.minimum(dists + delta, d_sphere_far)
    d_hit = linspace_between(dnp, dfp, steps)
    near = torch.full_like(dnp, rcfg.near)
    if use_outside:
        d_hit = torch.cat([linspace_between(near, dnp, steps_out), d_hit],
                          dim=-1)
    # miss rays: full_steps in [near, sphere far]
    d_miss = linspace_between(near, d_sphere_far, full_steps)
    if "hit" in noise:
        d_hit = stratified_noise(d_hit, noise["hit"])
        d_miss = stratified_noise(d_miss, noise["miss"])

    d_all = torch.where(surface_mask[:, None], d_hit, d_miss)     # [N, S]
    p_fg = cam[:, None, :] + ray[:, None, :] * d_all[..., None]
    ray_fg = (-ray[:, None, :]).expand(p_fg.shape)
    if radiance_fn is None:
        rgb, alpha = radiance_and_alpha(field, p_fg, ray_fg, field_cfg)
    else:
        rgb, alpha = radiance_fn(p_fg, ray_fg)
    weights = alpha_composite(alpha)
    rgb_values = torch.sum(weights[..., None] * rgb, dim=-2)

    # surface normals (+ a jittered pair for the smoothness loss)
    if train:
        neigh = points + (noise["jitter"] - 0.5) * 0.01
        pp = torch.cat([points, neigh], dim=0)
    else:
        pp = points
    g = occ_gradient(field, pp, field_cfg)
    normals = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-5)
    norm_pred = torch.where(surface_mask[:, None], normals[:n], 0.0)
    diff_norm = None
    if train:
        # eps inside the sqrt: a bitwise-identical jittered pair would make
        # d||x|| at x = 0 a 0/0
        d2 = torch.sum((normals[:n] - normals[n:]) ** 2, dim=-1)
        diff_norm = torch.sqrt(d2 + 1e-12)

    acc_map = torch.sum(weights, dim=-1)
    if rcfg.white_background:
        rgb_values = rgb_values + (1.0 - acc_map[..., None])
    return {"rgb": rgb_values, "mask_pred": surface_mask,
            "normal_pred": norm_pred, "diff_norm": diff_norm,
            "acc_map": acc_map, "points": points}


@torch.no_grad()
def render_shape_extract(field, field_cfg: OccFieldConfig,
                         rcfg: UnisurfConfig, pixels: torch.Tensor,
                         camera_mat: torch.Tensor, world_mat: torch.Tensor,
                         light_dir: torch.Tensor | None = None,
                         n_steps: int = 512, occ_fn=None) -> dict:
    """Per-pixel surface points [N, 3], unit normals [N, 3] (0 off the
    surface) and mask [N] of pixels [N, 2]; with light_dir [L, 3] also the
    visibility [L, N] of every pixel toward each light (1 off the surface),
    by the faithful light_visibility."""
    _, _, _, points, surface_mask = _march_and_surface(
        field, field_cfg, rcfg, pixels, camera_mat, world_mat, n_steps,
        occ_fn=occ_fn)
    g = occ_gradient(field, points, field_cfg)
    normals = g / torch.clamp_min(torch.linalg.norm(g, dim=-1, keepdim=True),
                                  1e-12)
    out = {"mask": surface_mask,
           "normal": torch.where(surface_mask[:, None], normals, 0.0),
           "points": points}
    if light_dir is not None:
        if occ_fn is None:
            occ_fn = lambda p: occ_alpha(field, p, field_cfg)
        vis = light_visibility(occ_fn, points, light_dir)
        out["visibility"] = torch.where(surface_mask[None, :], vis, 1.0)
    return out
