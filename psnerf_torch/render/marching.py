"""Occupancy-field ray marching (counterpart of psnerf_tpu/render/marching.py
`secant`, `ray_marching`, `occupancy_guide_grid` and `light_visibility`): a
dense sign scan for the first inside crossing, refined by secant steps; and
the transmittance of surface points toward each light, in the faithful,
rescaled and grid-guided protocols.

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
import torch.nn.functional as F

from psnerf_torch.core.compositing import alpha_composite
from psnerf_torch.core.rays import get_sphere_intersection
from psnerf_torch.core.sampling import linspace_between
from psnerf_torch.device import resolve_device

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
def occupancy_guide_grid(occ_fn, res: int = 64, box: float = 1.1,
                         thresh: float = 0.01, dilate: int = 3,
                         device: str | torch.device = "cuda"
                         ) -> torch.Tensor:
    """Conservative 'might be occupied' voxel grid over [-box, box]^3 for
    the guided visibility march: the field at every cell centre (one occ_fn
    call on res^3 points, one fused_occ launch of 262,144 points at the
    default res), thresholded low, then dilated by `dilate` rounds of a 3^3
    max-pool (stride 1, "same" padding), so that rays grazing a surface
    still see its cells. Returns a float {0, 1} grid [res, res, res] on
    `device` (the card unless the caller asks for the CPU).

    The guided march probes this grid at spacing (lfar - lnear) /
    (guide_coarse - 1) at most, and a thin occluder's dilated slab is
    (2 dilate + 1) 2 box / res thick: the probes cover every slab only when
    the spacing is the smaller (the runner checks it before it builds the
    grid)."""
    half = box / res
    device = resolve_device(device)
    xs = torch.linspace(-box + half, box - half, res, device=device)
    gx, gy, gz = torch.meshgrid(xs, xs, xs, indexing="ij")
    pts = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    occ = (occ_fn(pts).reshape(res, res, res) > thresh).float()
    for _ in range(dilate):
        occ = F.max_pool3d(occ[None, None], 3, stride=1, padding=1)[0, 0]
    return occ


@torch.no_grad()
def light_visibility(occ_fn, surf: torch.Tensor, light_dir: torch.Tensor,
                     lnear: float = 0.1, lfar: float = 3.5,
                     n_steps: int = 128, box: float = 1.1,
                     rescale: bool = False, light_chunk: int = 1,
                     guide: torch.Tensor | None = None,
                     guide_coarse: int = 16) -> torch.Tensor:
    """Transmittance toward each light, 1 - the composited occupancy along
    the light ray: surf [N, 3], light_dir [L, 3] unit -> visibility [L, N].

    Lights are marched in groups of light_chunk (the last group padded with
    copies of direction 0, sliced off after), each group as one occ_fn call
    on light_chunk * N * n_steps points: one fused_occ launch per group when
    occ_fn is the kernel's closure. Samples outside the +-box clip are
    zeroed after evaluation.

    rescale=False (faithful): n_steps samples uniform on [lnear, lfar].
    rescale=True: n_steps samples uniform on [lnear, the ray's exit from the
    box], so that every evaluation lands inside the box.
    guide (a grid from occupancy_guide_grid; implies the rescaled
    interval): each ray first probes the grid at guide_coarse points on
    [lnear, box exit] and marches [lnear, last occupied probe + one coarse
    step] instead; a ray with no occupied probe marches [lnear, lnear + one
    coarse step]."""
    n = surf.shape[0]
    dev, dt = surf.device, surf.dtype
    # a + b * c in one rounding (torch.addcmul), as XLA contracts it: a
    # rescaled ray's last sample lies on the box face, where the rounding of
    # p decides whether it is inside. lnear is filled on the device once: a
    # tensor copied from a Python float would wait for the stream each call
    fma = torch.addcmul
    near = torch.full((), lnear, dtype=dt, device=dev)
    # linspace(0, 1, k) as jnp.linspace computes it: iota / (k - 1)
    unit = lambda k: torch.arange(k, dtype=dt, device=dev) / max(k - 1, 1)
    frac = unit(n_steps)
    t_shared = torch.linspace(lnear, lfar, n_steps, dtype=dt, device=dev)
    if guide is not None:
        res = guide.shape[0]
        guide_flat = guide.reshape(-1)
        frac_c = unit(guide_coarse)

    def box_exit(ldirs):                                   # [C, 3] -> [C, N]
        # per axis the positive root of |surf_a + t ldir_a| = box, then the
        # nearest
        d = ldirs[:, None, :]
        t_axis = torch.where(d > 0, _safe_div(box - surf[None], d),
                             _safe_div(-box - surf[None], d))
        t_axis = torch.where(d.abs() < 1e-8, torch.inf, t_axis)
        return torch.clamp(torch.amin(t_axis, dim=-1), lnear + 1e-3, lfar)

    def one_group(ldirs):                                  # [C, 3] -> [C, N]
        c = ldirs.shape[0]
        if guide is not None:
            t_exit = box_exit(ldirs)
            # the coarse probe: where along the ray might occupancy lie?
            tc = fma(near, (t_exit - lnear)[..., None], frac_c)  # [C, N, Sc]
            pc = fma(surf[None, :, None, :], ldirs[:, None, None, :],
                     tc[..., None])
            ijk = torch.clamp(torch.floor(
                (pc + box) * (res / (2.0 * box))).to(torch.int64), 0, res - 1)
            flat = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
            occ_c = guide_flat[flat]                       # [C, N, Sc]
            sidx = torch.arange(1, guide_coarse + 1, device=dev)
            last = torch.amax(occ_c.to(torch.int64) * sidx, dim=-1)
            step_c = (t_exit - lnear) / (guide_coarse - 1)
            t_last = torch.gather(tc, -1, torch.clamp_min(
                last - 1, 0)[..., None])[..., 0]
            t_hi = torch.where(last > 0, torch.minimum(t_last + step_c,
                                                       t_exit),
                               lnear + step_c)
            t = fma(near, (t_hi - lnear)[..., None], frac)  # [C, N, S]
        elif rescale:
            t_exit = box_exit(ldirs)
            t = fma(near, (t_exit - lnear)[..., None], frac)
        else:
            t = t_shared.expand(c, n, n_steps)
        p = fma(surf[None, :, None, :], ldirs[:, None, None, :], t[..., None])
        alpha = occ_fn(p.reshape(-1, 3)).reshape(c, n, n_steps)
        inside = torch.all((p <= box) & (p >= -box), dim=-1)
        alpha = torch.where(inside, alpha, 0.0)
        return 1.0 - torch.sum(alpha_composite(alpha), dim=-1)

    n_l = light_dir.shape[0]
    if n_l == 0:
        return surf.new_zeros((0, n))
    chunk = max(1, min(light_chunk, n_l))
    pad = (-n_l) % chunk
    if pad:
        light_dir = torch.cat([light_dir, light_dir[:1].expand(pad, 3)])
    groups = light_dir.reshape(-1, chunk, 3)
    return torch.cat([one_group(g) for g in groups])[:n_l]
