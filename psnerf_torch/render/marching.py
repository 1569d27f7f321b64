"""Occupancy-field ray marching (counterpart of psnerf_tpu/render/marching.py
`secant`, `ray_marching` and `light_visibility`): a dense sign scan for the
first inside crossing, refined by secant steps; and the transmittance of
surface points toward each light.

Every ray computes every step; invalid lanes are masked, not gathered. The
proposal grid has a fixed step count; training jitters its global phase by
a shared fraction of one cell, given here as a tensor. The march is a
no-grad region.

Sentinel convention of the returned depth:
  d_pred   where a valid inside-crossing was found,
  +inf     where not,
  0        where the FIRST proposal sample is already occupied.
"""

from __future__ import annotations

import torch

from psnerf_torch.core.compositing import alpha_composite
from psnerf_torch.core.rays import get_sphere_intersection
from psnerf_torch.core.sampling import linspace_between

TAU = 0.5


def _safe_div(a, b, eps=1e-12):
    small = torch.where(b < 0, -eps, eps)
    return a / torch.where(torch.abs(b) < eps, small, b)


@torch.no_grad()
def secant(occ_fn, f_low, f_high, d_low, d_high, ray0, ray_dir,
           n_steps: int = 8) -> torch.Tensor:
    """Secant refinement on [d_low, d_high]. occ_fn: points [N, 3] ->
    occupancy-minus-tau [N]; f_*/d_*: [N]. Returns refined depths [N]."""
    d_pred = -f_low * _safe_div(d_high - d_low, f_high - f_low) + d_low
    for _ in range(n_steps):
        f_mid = occ_fn(ray0 + d_pred[..., None] * ray_dir)
        ind_low = f_mid < 0
        d_low = torch.where(ind_low, d_pred, d_low)
        f_low = torch.where(ind_low, f_mid, f_low)
        d_high = torch.where(ind_low, d_high, d_pred)
        f_high = torch.where(ind_low, f_high, f_mid)
        d_pred = -f_low * _safe_div(d_high - d_low, f_high - f_low) + d_low
    return d_pred


@torch.no_grad()
def ray_marching(occ_fn, ray0: torch.Tensor, ray_dir: torch.Tensor,
                 n_steps: int = 256, n_secant_steps: int = 8,
                 near: float = 0.0, rad: float = 1.0,
                 phase: torch.Tensor | None = None) -> torch.Tensor:
    """First inside-crossing depth along each ray.

    occ_fn: [M, 3] -> occupancy probability [M]. ray0/ray_dir: [N, 3],
    ray_dir unit-norm. phase: None, or a scalar U(0, 1) draw that shifts
    the interior proposal samples by that fraction of one cell.
    Returns d [N] with the inf/0 sentinel convention."""
    n = ray0.shape[0]
    depth_intersect, _ = get_sphere_intersection(ray0[0], ray_dir, r=rad)
    d_far = depth_intersect[..., 1]

    lo = torch.full((n,), near, dtype=ray0.dtype, device=ray0.device)
    d_prop = linspace_between(lo, d_far, n_steps)              # [N, S]
    if phase is not None:
        shift = phase * ((d_far - near) / (n_steps - 1))[..., None]
        d_prop = torch.cat([d_prop[..., :1], d_prop[..., 1:-1] + shift,
                            d_prop[..., -1:]], dim=-1)

    p_prop = ray0[:, None, :] + ray_dir[:, None, :] * d_prop[..., None]
    val = occ_fn(p_prop.reshape(-1, 3)).reshape(n, n_steps) - TAU

    mask_0_not_occupied = val[:, 0] < 0
    # first sign change: cost = sign(v_i * v_{i+1}) * (S - i); the min picks
    # the earliest negative product
    sign = torch.sign(val[:, :-1] * val[:, 1:])
    sign = torch.cat([sign, torch.ones_like(sign[:, :1])], dim=-1)
    cost = sign * torch.arange(n_steps, 0, -1, dtype=val.dtype,
                               device=val.device)
    indices = torch.argmin(cost, dim=-1)       # the first minimum
    mask_sign_change = torch.amin(cost, dim=-1) < 0
    take = lambda arr, idx: torch.gather(arr, 1, idx[:, None])[:, 0]
    mask_neg_to_pos = take(val, indices) < 0
    mask = mask_sign_change & mask_neg_to_pos & mask_0_not_occupied

    d_low, f_low = take(d_prop, indices), take(val, indices)
    idx_hi = torch.clamp_max(indices + 1, n_steps - 1)
    d_high, f_high = take(d_prop, idx_hi), take(val, idx_hi)

    d_pred = secant(lambda p: occ_fn(p) - TAU, f_low, f_high, d_low, d_high,
                    ray0, ray_dir, n_secant_steps)
    d_out = torch.where(mask, d_pred, torch.inf)
    return torch.where(mask_0_not_occupied, d_out, 0.0)


@torch.no_grad()
def light_visibility(occ_fn, surf: torch.Tensor, light_dir: torch.Tensor,
                     lnear: float = 0.1, lfar: float = 3.5,
                     n_steps: int = 128, box: float = 1.1,
                     rescale: bool = False, light_chunk: int = 1,
                     guide: torch.Tensor | None = None) -> torch.Tensor:
    """Transmittance toward each light, 1 - the composited occupancy along
    the light ray: surf [N, 3], light_dir [L, 3] unit -> visibility [L, N].

    The faithful protocol only: n_steps samples uniform on [lnear, lfar],
    the ones outside the +-box clip zeroed after evaluation. Lights are
    marched one at a time, each as one occ_fn call on N * n_steps points
    (one fused_occ launch per light when occ_fn is the kernel's closure).
    The rescaled and guided protocols and light_chunk > 1 are ROADMAP queue
    1 item 5 and raise here."""
    if rescale or guide is not None or light_chunk != 1:
        raise NotImplementedError(
            "light_visibility runs the faithful protocol only (rescale=False, "
            "guide=None, light_chunk=1); the rescaled and guided protocols "
            "are ROADMAP queue 1 item 5")
    n = surf.shape[0]
    t = torch.linspace(lnear, lfar, n_steps, dtype=surf.dtype,
                       device=surf.device)
    vis = []
    for ld in light_dir:
        p = surf[:, None, :] + ld * t[:, None]                    # [N, S, 3]
        alpha = occ_fn(p.reshape(-1, 3)).reshape(n, n_steps)
        inside = torch.all((p <= box) & (p >= -box), dim=-1)
        alpha = torch.where(inside, alpha, 0.0)
        vis.append(1.0 - torch.sum(alpha_composite(alpha), dim=-1))
    return torch.stack(vis) if vis else surf.new_zeros((0, n))
