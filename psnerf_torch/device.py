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
