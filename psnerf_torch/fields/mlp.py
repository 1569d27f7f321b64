"""MLP building blocks (counterpart of psnerf_tpu/fields/mlp.py).

Weights keep the JAX layout w: [din, dout] (y = x @ w + b), so a parameter
set loads into either package under the same keys. A skip MLP is an
nn.ModuleList of Linear layers, so its state-dict keys are `0.w`, `0.b`, ...
which map onto the JAX leaf paths `0/w`, `0/b`, ...
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class Linear(nn.Module):
    """y = x @ w + b with w [din, dout]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def linear_init(din: int, dout: int, generator: torch.Generator | None = None,
                device: str | torch.device = "cpu") -> Linear:
    """torch nn.Linear's default distribution: U(-1/sqrt(din), 1/sqrt(din))
    for weights and bias. Draws on the CPU from `generator`, then moves, so a
    seed gives the same weights on every device."""
    bound = math.sqrt(1.0 / din)
    w = torch.rand((din, dout), generator=generator) * (2 * bound) - bound
    b = torch.rand((dout,), generator=generator) * (2 * bound) - bound
    return Linear(w.to(device), b.to(device))


class SkipMLP(nn.ModuleList):
    """The stage-2 `Network` / `Normal_Network` topology: after activating
    layer li's output, if li is in skip_at the input x is concatenated back
    on. final_activation: 'none' | 'sigmoid'."""

    def __init__(self, layers: Sequence[Linear], skip_at: Sequence[int] = (),
                 final_activation: str = "none"):
        super().__init__(layers)
        self.skip_at = tuple(s for s in skip_at if s >= 0)
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        return skip_mlp_apply(self, x, self.skip_at, self.final_activation,
                              compute_dtype)


def skip_mlp_init(din: int, dout: int, width: int, depth: int,
                  skip_at: Sequence[int] = (),
                  final_activation: str = "none",
                  generator: torch.Generator | None = None,
                  device: str | torch.device = "cpu") -> SkipMLP:
    """L0: din -> W; L_i (1..depth-1): (W+din if (i-1) in skip_at else W) -> W;
    L_depth: W -> dout."""
    skips = [s for s in skip_at if s >= 0]
    dims_in = ([din] + [width + din if i in skips else width
                        for i in range(depth - 1)] + [width])
    dims_out = [width] * depth + [dout]
    layers = [linear_init(di, do, generator, device)
              for di, do in zip(dims_in, dims_out)]
    return SkipMLP(layers, skip_at, final_activation)


def skip_mlp_apply(layers: Sequence[Linear], x: torch.Tensor,
                   skip_at: Sequence[int] = (),
                   final_activation: str = "none",
                   compute_dtype=None) -> torch.Tensor:
    """compute_dtype=torch.bfloat16 rounds weights and activations to bf16
    and accumulates in f32: activations are cast after the relu, and the
    bf16 input is concatenated at the skip. The products of two bf16 values
    are exact in f32, so an f32 matmul of bf16-rounded operands is that
    computation up to summation order. The final activation runs in f32."""
    skips = [s for s in skip_at if s >= 0]
    n = len(layers)
    if compute_dtype is None:
        y = x
        for li, lyr in enumerate(layers):
            y = y @ lyr.w + lyr.b
            if li != n - 1:
                y = torch.relu(y)
            elif final_activation == "sigmoid":
                y = torch.sigmoid(y)
            if li in skips:
                y = torch.cat([y, x], dim=-1)
        return y

    def rnd(t):
        return t.to(compute_dtype).float()

    xc = rnd(x)
    y = xc
    for li, lyr in enumerate(layers):
        y = y @ rnd(lyr.w) + lyr.b
        if li != n - 1:
            y = rnd(torch.relu(y))
        elif final_activation == "sigmoid":
            y = torch.sigmoid(y)
        if li in skips:
            y = torch.cat([y, xc], dim=-1)
    return y
