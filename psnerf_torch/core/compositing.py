"""Alpha compositing (counterpart of psnerf_tpu/core/compositing.py):
weights_i = alpha_i * prod_{j<i} (1 - alpha_j + eps), with a leading
implicit 1 in the cumulative product."""

from __future__ import annotations

import torch

EPS = 1e-6


def alpha_composite(alpha: torch.Tensor) -> torch.Tensor:
    """alpha: [..., S] in [0, 1] -> compositing weights [..., S]."""
    trans = torch.cumprod(1.0 - alpha + EPS, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    return alpha * trans
