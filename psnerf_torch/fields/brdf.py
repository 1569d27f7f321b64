"""BRDF models (counterpart of psnerf_tpu/fields/brdf.py): the
spherical-Gaussian basis and the GGX microfacet model, on broadcastable
tensors."""

from __future__ import annotations

import math

import numpy as np
import torch

# 9 fixed SG lobe sharpness values lambda_i = e^i, i in 2..10 (float32)
SG_LOBES = np.asarray([math.exp(i) for i in range(2, 11)], dtype=np.float32)
_LOBES_ON = {}      # device -> SG_LOBES there: a copy to the card waits for it


def _lobes(device) -> torch.Tensor:
    if device not in _LOBES_ON:
        _LOBES_ON[device] = torch.as_tensor(SG_LOBES, device=device)
    return _LOBES_ON[device]


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # torch.F.normalize semantics: v / max(||v||, eps)
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), eps)


def sg_basis(v, n, l, albedo, weights, specular_rgb: bool = False,
             nbasis: int = 9):
    """v/n/l [..., 3] unit view/normal/light dirs; albedo [..., 3];
    weights [..., nbasis] (or [..., 3*nbasis] when specular_rgb).
    Returns (brdf [..., 3], specular [..., 1 or 3]) with
    specular = max(sum_i w_i * exp(lambda_i * (h.n - 1)), 0)."""
    h = _normalize(l + v)
    hn = torch.sum(h * n, dim=-1, keepdim=True)
    lobes = _lobes(hn.device)[:nbasis]
    d = torch.exp(lobes * (hn - 1.0))                       # [..., nbasis]
    if specular_rgb:
        w = weights.reshape(*weights.shape[:-1], 3, nbasis)
        specular = torch.clamp_min(torch.sum(w * d[..., None, :], dim=-1), 0.0)
    else:
        specular = torch.clamp_min(
            torch.sum(weights * d, dim=-1, keepdim=True), 0.0)
    brdf = albedo + specular          # broadcasts [..., 1] over rgb
    return brdf, specular


def _divide_no_nan(x, y):
    """x / (y + 1e-6) with inf/nan -> 0."""
    a = x / (y + 1e-6)
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a))


def microfacet_brdf(l, v, n, albedo, rough, f0: float = 0.05,
                    lambert_only: bool = False):
    """GGX microfacet BRDF, single-light layout: l/v/n [..., 3],
    albedo [..., 3], rough [..., 1] -> brdf [..., 3]."""
    l = _normalize(l, 1e-6)
    v = _normalize(v, 1e-6)
    n = _normalize(n, 1e-6)
    h = _normalize(l + v, 1e-6)

    cos_lh = torch.sum(l * h, dim=-1)
    f = f0 + (1.0 - f0) * (1.0 - cos_lh) ** 5

    alpha = rough[..., 0] ** 2

    cos_hn = torch.sum(h * n, dim=-1)
    chi_d = (cos_hn > 0).to(cos_hn.dtype)
    cos_hn_sq = cos_hn**2
    tan_hn_sq = _divide_no_nan(1.0 - cos_hn_sq, cos_hn_sq)
    d = _divide_no_nan(
        alpha**2 * chi_d, math.pi * cos_hn_sq**2 * (alpha**2 + tan_hn_sq) ** 2)

    cos_vn = torch.sum(n * v, dim=-1)
    cos_vh = torch.sum(h * v, dim=-1)
    chi_g = (_divide_no_nan(cos_vh, cos_vn) > 0).to(cos_vn.dtype)
    cos_vn_sq = torch.clamp(cos_vn**2, 0.0, 1.0)
    tan_vn_sq = torch.clamp_min(_divide_no_nan(1.0 - cos_vn_sq, cos_vn_sq), 0.0)
    g = _divide_no_nan(chi_g * 2.0, 1.0 + torch.sqrt(1.0 + alpha**2 * tan_vn_sq))

    l_dot_n = torch.sum(l * n, dim=-1)
    v_dot_n = torch.sum(v * n, dim=-1)
    denom = 4.0 * torch.abs(l_dot_n) * torch.abs(v_dot_n)
    glossy = _divide_no_nan(f * g * d, denom)[..., None]

    diffuse = albedo / math.pi
    if lambert_only:
        return diffuse
    return glossy + diffuse
