"""Adam with per-leaf update gating and the MultiStepLR schedule
(counterpart of psnerf_tpu/train/optim.py).

Parameters are a flat {name: tensor} dict (an nn.Module's named parameters
with `.` read as `/`), and the state is JAX's `{m, v, step}` tree keyed by
the same names, so an optimizer state crosses between the packages in a
checkpoint (`opt/m/geo/0/v`, `opt/step/geo/0/v`, ...). A gate (0 = frozen:
param, m, v and the per-leaf step stay untouched; or a row mask) keeps
stage-2's freezing and sparse-row updates inside one code path. Updates are
in place and read nothing back to the host.

`adam_update` sends every float32 leaf on a CUDA device to the
multi-tensor kernel (psnerf_torch/ops/adam.py: two launches for up to 48
leaves), and raises for one the kernel cannot take; CPU leaves and other
dtypes go to `adam_update_plain`, the per-leaf loop of ATen calls, which is
the CPU route and the kernel's reference: both give the same bits on the
card.
"""

from __future__ import annotations

from typing import Sequence

import torch

from psnerf_torch.ops.adam import check_leaf, fused_adam
from psnerf_torch.ops.build import route
from psnerf_torch.utils import profiling


def adam_init(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
            "step": {k: torch.zeros((), dtype=torch.int32, device=p.device)
                     for k, p in params.items()}}


@torch.no_grad()
def adam_update(params: dict, grads: dict, state: dict, lr, gate=None,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step, in place. gate: None (all update) or {name: value}
    per leaf: a tensor broadcastable against the leaf (e.g. a row mask), or
    a host 0 (the leaf is frozen: param, m, v and step stay, and nothing is
    launched) or 1 (no gate). A float32 leaf on the card takes the kernel,
    which needs host numbers for lr, b1, b2, eps, a row-mask gate and the
    operands check_leaf names: anything else there raises before any leaf
    moves. Counts the leaves it updates by each route, `optim.fused_leaves`
    and `optim.plain_leaves` (frozen ones in neither)."""
    fused, plain = {}, []
    for k, p in params.items():
        gt = None if gate is None else gate[k]
        if isinstance(gt, (int, float)):
            if not gt:
                continue
            gt = None
        if route(p) != "cuda" or p.dtype != torch.float32:
            plain.append(k)
            continue
        if gt is not None:
            gt = gt.to(dtype=p.dtype, device=p.device).contiguous()
        leaf = (p, grads[k], state["m"][k], state["v"][k], state["step"][k],
                gt)
        check_leaf(k, *leaf)
        fused.setdefault(p.device, []).append(leaf)
    if fused and not all(isinstance(x, (int, float))
                         for x in (lr, b1, b2, eps)):
        raise ValueError("the adam kernel takes lr, b1, b2 and eps as host "
                         "numbers")
    for leaves in fused.values():
        fused_adam(leaves, lr, b1, b2, eps)
    if plain:
        adam_update_plain({k: params[k] for k in plain}, grads, state, lr,
                          gate, b1, b2, eps)
    profiling.count("optim.fused_leaves", sum(map(len, fused.values())))
    profiling.count("optim.plain_leaves", len(plain))


@torch.no_grad()
def adam_update_plain(params: dict, grads: dict, state: dict, lr, gate=None,
                      b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8) -> None:
    """adam_update as a loop of ATen calls per leaf, any device and dtype:
    the CPU route and the multi-tensor kernel's reference."""
    for k, p in params.items():
        g = grads[k]
        m, v, step = state["m"][k], state["v"][k], state["step"][k]
        gt = None if gate is None else gate[k]
        if isinstance(gt, (int, float)):
            if not gt:
                continue
            gt = None
        elif gt is not None:
            gt = gt.to(dtype=p.dtype, device=p.device)
        on = gt > 0 if gt is not None else None
        new_step = step + (1 if on is None else on.any().to(torch.int32))
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        # t >= 1: a frozen leaf's step 0 would make 1 - b1**0 = 0
        t = torch.clamp_min(new_step, 1).to(p.dtype)
        upd = lr * (m_new / (1 - b1 ** t)) / (
            torch.sqrt(v_new / (1 - b2 ** t)) + eps)
        if gt is None:
            p.sub_(upd)
            m.copy_(m_new)
            v.copy_(v_new)
        else:
            p.sub_(gt * upd)
            m.copy_(torch.where(on, m_new, m))
            v.copy_(torch.where(on, v_new, v))
        step.copy_(new_step)


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                 it) -> torch.Tensor | float:
    """MultiStepLR as a function of the iteration counter."""
    n_passed = sum(int(it >= m) for m in sorted(milestones))
    return base_lr * gamma ** n_passed


def row_mask_from_indices(n_rows: int, indices: torch.Tensor) -> torch.Tensor:
    """[n_rows, 1] 0/1 mask with ones at `indices`: the SparseAdam row
    gate of the light tables."""
    mask = torch.zeros((n_rows,), dtype=torch.float32, device=indices.device)
    return mask.index_fill_(0, indices, 1.0)[:, None]
