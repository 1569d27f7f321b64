"""Multi-tensor Adam, as a hand-written CUDA kernel for Hopper
(csrc/adam.cu): one call updates up to MAX_LEAVES leaves of an
`adam_update` call (psnerf_torch/train/optim.py) in two launches, a step
bump and the update, in place of adam_update_plain's ~24 ATen calls a leaf.

The leaves travel as a table in the launches' parameters, built here on the
host from the tensors' pointers and sizes (`tables`): no copy to the device
and no read-back. A leaf the kernel takes (`check_leaf`) is float32,
contiguous and not empty, with its gradient, m and v of its shape and
device, an int32 step counter there, and no gate or a row gate: a float32
tensor of the leaf's shape with its trailing dimensions cut to 1 (the light
tables' `row_mask_from_indices`).
The arithmetic is adam_update_plain's, operation for operation in the same
rounding, so both give the same bits on the card.

This module has no plain version of its own: adam_update_plain is the
plain version, and optim.adam_update routes each leaf. It counts its
kernel launches in `fused_adam.launches`.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from psnerf_torch.ops.build import check_operand, launch, load_library

MAX_LEAVES = 48          # csrc/adam.cu's table
_lib_handle = []


def f32_bits(x: float) -> int:
    """The bits of float32(x) as a signed 32-bit int (a C cast of the
    double x, as ATen casts a Python scalar for an f32 tensor)."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


def gate_cols(gate: torch.Tensor, p: torch.Tensor) -> int | None:
    """The values of p per value of a row gate: the gate has p's shape with
    its trailing dimensions cut to 1. None when the gate is not of that
    form."""
    gs, ps = tuple(gate.shape), tuple(p.shape)
    if len(gs) != len(ps):
        return None
    k = len(ps)
    while k and gs[k - 1] == 1:
        k -= 1
    return math.prod(ps[k:]) if gs[:k] == ps[:k] else None


def check_leaf(name, p, g, m, v, step, gate) -> None:
    """Raise unless the kernel takes the leaf: p, g, m, v float32,
    contiguous, of one shape, on one device, p not empty; step an int32
    scalar there; gate None or a contiguous float32 row gate (gate_cols)
    there."""
    f32 = torch.float32
    for part, t in (("param", p), ("grad", g), ("m", m), ("v", v)):
        check_operand(f"{name} {part}", t, f32, p.shape, p.device)
    if p.numel() == 0:
        raise ValueError(f"{name} is empty")
    check_operand(f"{name} step", step, torch.int32, (), p.device)
    if gate is not None:
        check_operand(f"{name} gate", gate, f32, gate.shape, p.device)
        if gate_cols(gate, p) is None:
            raise ValueError(f"{name}'s gate of shape {tuple(gate.shape)} is "
                             f"not a row gate of {tuple(p.shape)}")


def tables(leaves: list, lr: float, b1: float, b2: float,
           eps: float) -> list:
    """[(tensors, ints)] of the calls that update `leaves`, each a tuple
    (p, g, m, v, step, gate or None) the kernel takes, at most MAX_LEAVES a
    call: tensors p, g, m, v, step, gate (p where ungated) a leaf; ints
    n_leaves, the f32 bits of lr, b1, 1 - b1, b2, 1 - b2, eps, then n and
    cols (0 where ungated) a leaf."""
    scalars = [f32_bits(x) for x in (lr, b1, 1 - b1, b2, 1 - b2, eps)]
    out = []
    for at in range(0, len(leaves), MAX_LEAVES):
        chunk = leaves[at:at + MAX_LEAVES]
        tensors, ints = [], [len(chunk), *scalars]
        for p, g, m, v, step, gate in chunk:
            tensors += [p, g, m, v, step, p if gate is None else gate]
            ints += [p.numel(), 0 if gate is None else gate_cols(gate, p)]
        out.append((tensors, ints))
    return out


def _lib():
    if not _lib_handle:
        lib = load_library("adam")
        lib.psnerf_adam.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        lib.psnerf_adam.restype = ctypes.c_int
        lib.psnerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.psnerf_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle.append(lib)
    return _lib_handle[0]


def _launch(tensors: list, ints: list) -> None:
    """One call of the kernel (its two launches) on a table."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the adam kernel needs CUDA tensors, got {dev}")
    lib = _lib()
    launch(lib.psnerf_adam, lib.psnerf_cuda_error_string, dev, tensors, ints,
           "adam")


def fused_adam(leaves: list, lr: float, b1: float, b2: float,
               eps: float) -> None:
    """One Adam step of `leaves` (tuples as `tables` takes them, every one
    on one CUDA device), in place."""
    for tensors, ints in tables(leaves, lr, b1, b2, eps):
        _launch(tensors, ints)
        fused_adam.launches += 2


fused_adam.launches = 0
