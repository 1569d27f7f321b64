"""Depth sampling helpers (counterpart of psnerf_tpu/core/sampling.py): a
uniform per-ray linspace of depths, optionally jittered by stratified noise
where each sample moves uniformly within the cell between its neighbours'
midpoints. The noise is an argument (a tensor of U(0, 1) draws), so a
caller or a test decides where the randomness comes from."""

from __future__ import annotations

import torch


def linspace_between(lo: torch.Tensor, hi: torch.Tensor,
                     steps: int) -> torch.Tensor:
    """Per-ray linspace: lo/hi [...] -> [..., steps]."""
    t = torch.linspace(0.0, 1.0, steps, dtype=lo.dtype, device=lo.device)
    return lo[..., None] * (1.0 - t) + hi[..., None] * t


def stratified_noise(d: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Jitter sorted depth samples d [..., S] within mid-point cells by
    uniform noise of the same shape: low + (high - low) * noise, with
    high = [mid, d[-1]] and low = [d[0], mid]."""
    mid = 0.5 * (d[..., 1:] + d[..., :-1])
    high = torch.cat([mid, d[..., -1:]], dim=-1)
    low = torch.cat([d[..., :1], mid], dim=-1)
    return low + (high - low) * noise
