"""LPIPS (AlexNet variant) in PyTorch (counterpart of
psnerf_tpu/eval/lpips_jax.py).

The `lpips.LPIPS(net='alex')` metric of the reference
(stage2/utils/metrics.py:64-76): inputs in [-1, 1], ImageNet-stat shift and
scale, AlexNet conv features at the 5 ReLU taps, each channel map
unit-normalized, squared difference, a learned 1x1 head per tap, spatial
mean, sum. The convolutions run in f32 (TF32 off).

No weights ship with the repository and none are downloaded. Point
`LPIPS_WEIGHTS` (or `LPIPS(weights_path)`) at the npz that
tools/export_lpips_npz.py writes (conv{0..4}_{w,b} OIHW, lin{0..4}_w [1, C,
1, 1]) or at a torch state dict; without weights `LPIPS()(a, b)` is None
and the evaluation reports LPIPS as unavailable.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from psnerf_torch.device import f32_convolutions, resolve_device

# AlexNet feature stack: (out_ch, kernel, stride, padding); M = maxpool 3/2
_ALEX = [
    (64, 11, 4, 2), "M",
    (192, 5, 1, 2), "M",
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_TAP_CHANNELS = [64, 192, 384, 256, 256]

_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def alex_features(params: dict, x: torch.Tensor) -> list:
    """x [N, 3, H, W] normalized; returns the 5 ReLU feature maps."""
    taps = []
    ci = 0
    with f32_convolutions():
        for spec in _ALEX:
            if spec == "M":
                x = F.max_pool2d(x, 3, 2)          # VALID windows
                continue
            _, _, stride, pad = spec
            x = torch.relu(F.conv2d(x, params[f"conv{ci}_w"],
                                    params[f"conv{ci}_b"], stride, pad))
            taps.append(x)
            ci += 1
    return taps


def lpips_distance(params: dict, img1: torch.Tensor,
                   img2: torch.Tensor) -> torch.Tensor:
    """img* [H, W, 3] in [0, 1] -> scalar LPIPS (a 0-d tensor)."""
    shift = torch.as_tensor(_SHIFT, device=img1.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=img1.device)[None, :, None, None]

    def prep(im):
        x = im.permute(2, 0, 1)[None] * 2.0 - 1.0  # lpips input convention
        return (x - shift) / scale

    f1 = alex_features(params, prep(img1))
    f2 = alex_features(params, prep(img2))
    total = 0.0
    for i, (a, b) in enumerate(zip(f1, f2)):
        a = a / torch.linalg.norm(a, dim=1, keepdim=True).clamp_min(1e-10)
        b = b / torch.linalg.norm(b, dim=1, keepdim=True).clamp_min(1e-10)
        d = (a - b) ** 2
        w = params[f"lin{i}_w"]  # [1, C, 1, 1]
        total = total + (d * w).sum(1).mean((1, 2))[0]
    return total


class LPIPS:
    """Callable matching the reference interface; None if weights are
    missing. The weights come from `weights_path`, else LPIPS_WEIGHTS; the
    device is resolved only when there are weights."""

    def __init__(self, weights_path: str | None = None,
                 device: str | torch.device = "cuda"):
        self.params = None
        path = weights_path or os.environ.get("LPIPS_WEIGHTS")
        if path and os.path.exists(path):
            self.device = resolve_device(device)
            self.params = {k: v.to(self.device, torch.float32)
                           for k, v in load_weights(path).items()}

    @property
    def available(self) -> bool:
        return self.params is not None

    def __call__(self, img1: np.ndarray, img2: np.ndarray, mask=None):
        if self.params is None:
            return None
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device)
        with torch.no_grad():
            return float(lpips_distance(self.params, t(img1), t(img2)))


def load_weights(path: str) -> dict:
    """{conv{i}_w, conv{i}_b, lin{i}_w: CPU tensor} from an .npz (the
    layout of tools/export_lpips_npz.py) or a torch state dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.as_tensor(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return load_weights_from_torch(sd)


def load_weights_from_torch(sd: dict) -> dict:
    """Accepts a merged state_dict with torchvision AlexNet `features.N.*`
    keys (N in 0, 3, 6, 8, 10), or the lpips package's `net.sliceK.N.*` or
    `alex.features.N.*`, and lpips `lin{i}.model.1.weight` (or
    `lins.{i}.model.1.weight`) heads."""
    t = lambda a: torch.as_tensor(a).detach().cpu()
    conv_ids = [0, 3, 6, 8, 10]
    params = {}
    for ci, n in enumerate(conv_ids):
        for cand in (f"features.{n}.weight", f"net.slice{ci+1}.{n}.weight",
                     f"alex.features.{n}.weight"):
            if cand in sd:
                params[f"conv{ci}_w"] = t(sd[cand])
                params[f"conv{ci}_b"] = t(sd[cand.replace("weight", "bias")])
                break
        else:
            raise KeyError(f"AlexNet conv {ci} weights not found")
    for i in range(5):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in sd:
                params[f"lin{i}_w"] = t(sd[cand])
                break
        else:
            raise KeyError(f"lpips linear head {i} not found")
    return params
