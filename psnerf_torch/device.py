"""Device and dtype policy.

Entry points take an explicit `device` that defaults to "cuda". A CUDA
request on a machine without CUDA raises: nothing falls back to the CPU
silently. Tensors are float32 unless a kernel's packing says otherwise
(bf16 weights and activations inside psnerf_torch.ops).
"""

from __future__ import annotations

import torch

DTYPE = torch.float32


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def f32_convolutions():
    """A context in which cuDNN runs convolutions in f32, not TF32.
    PyTorch's default `torch.backends.cudnn.allow_tf32 = True` rounds conv
    operands to TF32 on the card; the JAX package's convolutions are f32,
    and SDPS-Net's class argmaxes flip under that rounding. The benchmark
    and determinism settings are kept as the caller set them."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)
