"""Plain PyTorch pieces shared by the stage-1 and stage-2 references:
positional encoding, sampling, compositing, camera rays, weight-normed and
skip MLPs, Adam, and the bf16 rounding points of the hand-written trunks.

The references follow PS-NeRF's published equations (the UNISURF stage-1
field and renderer, the stage-2 PSNet) in float32 with TF32 off. Where the
configuration states bf16 for a trunk (the stage-1 march's occupancy
queries, the stage-2 visibility trunk at evaluation), the reference rounds
the same operands to bf16 and accumulates in float32. The control is the
reference one precision lower: float32 products in TF32, the bf16 trunks'
operands in fp8 (e4m3, saturating). Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


_LOW = {"control": False}


@contextlib.contextmanager
def precision(control: bool):
    """The reference's precisions (float32 with TF32 off, bf16 trunks), or
    the control's: each one step lower (TF32, fp8 trunks)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    low = _LOW["control"]
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    _LOW["control"] = control
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        _LOW["control"] = low


def bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the operand of a bf16 product (under the
    control, to fp8 e4m3, saturating at its largest value)."""
    if _LOW["control"]:
        return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()
    return x.to(torch.bfloat16).float()


def embed(p: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF positional encoding [p, sin(2^i p), cos(2^i p), ...], the pairs
    of each octave side by side."""
    if n_freqs <= 0:
        return p
    freqs = 2.0 ** torch.arange(n_freqs, dtype=p.dtype, device=p.device)
    x = p[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(x), torch.cos(x)], dim=-2)
    return torch.cat([p, enc.reshape(*p.shape[:-1], -1)], dim=-1)


def embed_dim(d: int, n_freqs: int) -> int:
    return d * (1 + 2 * n_freqs)


def linspace_between(lo, hi, steps: int):
    t = torch.linspace(0.0, 1.0, steps, dtype=lo.dtype, device=lo.device)
    return lo[..., None] * (1.0 - t) + hi[..., None] * t


def stratified(d, u):
    mid = 0.5 * (d[..., 1:] + d[..., :-1])
    high = torch.cat([mid, d[..., -1:]], dim=-1)
    low = torch.cat([d[..., :1], mid], dim=-1)
    return low + (high - low) * u


def composite(alpha):
    """Compositing weights alpha_i prod_{j<i} (1 - alpha_j + 1e-6)."""
    trans = torch.cumprod(1.0 - alpha + 1e-6, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def sphere_far(cam, ray, r):
    """Far depth of unit rays from cam [3] through a sphere of radius r at
    the origin (0 where they miss), and the near depth."""
    rc = ray @ cam
    under = rc ** 2 - (torch.sum(cam ** 2) - r ** 2)
    sq = torch.sqrt(torch.clamp_min(under, 0.0))
    near = torch.where(under > 0, -sq - rc, 0.0).clamp_min(0.0)
    far = torch.where(under > 0, sq - rc, 0.0).clamp_min(0.0)
    return near, far


def wn_dense(v, g):
    """The weight of a weight-normed layer: g v / ||v|| per output column."""
    return g * v / torch.linalg.norm(v, dim=0, keepdim=True)


def skip_mlp(layers, x, skips, final=None):
    """y = relu(y W + b) per layer, the input re-concatenated after the
    activation of each layer in `skips`; no activation on the last."""
    y = x
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        y = y @ w + b
        if i != n - 1:
            y = torch.relu(y)
        elif final == "sigmoid":
            y = torch.sigmoid(y)
        if i in skips:
            y = torch.cat([y, x], dim=-1)
    return y


def skip_mlp_dims(din, dout, width, depth, skips):
    ins = [din] + [width + din if i in skips else width
                   for i in range(depth - 1)] + [width]
    return list(zip(ins, [width] * depth + [dout]))


@torch.no_grad()
def adam(params: dict, grads: dict, state: dict, lr, gate=None):
    """One Adam step in place over {name: tensor}; gate[name] a row mask
    (only its rows move, and the step counts when any does)."""
    for k, p in params.items():
        g = grads[k]
        m, v, t = state["m"][k], state["v"][k], state["t"][k]
        on = None if gate is None or k not in gate else gate[k]
        t_new = t + (1 if on is None else int(bool((on > 0).any())))
        m_new = ADAM_B1 * m + (1 - ADAM_B1) * g
        v_new = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        tt = max(t_new, 1)
        upd = lr * (m_new / (1 - ADAM_B1 ** tt)) / (
            torch.sqrt(v_new / (1 - ADAM_B2 ** tt)) + ADAM_EPS)
        if on is None:
            p.sub_(upd)
            m.copy_(m_new)
            v.copy_(v_new)
        else:
            p.sub_(on * upd)
            m.copy_(torch.where(on > 0, m_new, m))
            v.copy_(torch.where(on > 0, v_new, v))
        state["t"][k] = t_new


def adam_state(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
            "t": {k: 0 for k in params}}


def multistep(base, milestones, gamma, it):
    return base * gamma ** sum(int(it >= m) for m in milestones)


def uniform_init(dims, gen, dev):
    """torch.nn.Linear's default U(-1/sqrt(din), 1/sqrt(din)) for every
    weight [din, dout] and bias of `dims`, from one draw on the device."""
    n = sum(i * o + o for i, o in dims)
    u = torch.rand((n,), generator=gen, device=dev) * 2 - 1
    out, s = [], 0
    for i, o in dims:
        bound = math.sqrt(1.0 / i)
        w = u[s:s + i * o].reshape(i, o) * bound
        s += i * o
        b = u[s:s + o] * bound
        s += o
        out.append((w.contiguous(), b.contiguous()))
    return out
