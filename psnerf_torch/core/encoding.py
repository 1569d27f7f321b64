"""Positional encoding (counterpart of psnerf_tpu/core/encoding.py).

out = [p, sin(2^0 p), cos(2^0 p), sin(2^1 p), cos(2^1 p), ...]: the input
first, then per-octave (sin, cos) pairs, each of width d.
Shapes: input [..., d] -> output [..., d * (1 + 2L)].
"""

from __future__ import annotations

import torch


def nerf_embed(p: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF positional encoding: [p, sin(2^i p), cos(2^i p) for i in 0..L-1]."""
    if n_freqs <= 0:
        return p
    freqs = 2.0 ** torch.arange(n_freqs, dtype=p.dtype, device=p.device)
    scaled = p[..., None, :] * freqs[:, None]                 # [..., L, d]
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    return torch.cat([p, enc.reshape(*p.shape[:-1], -1)], dim=-1)


def nerf_embed_dim(d: int, n_freqs: int) -> int:
    return d * (1 + 2 * n_freqs)
