"""Plain reference of PS-NeRF's envmap relighting (stage2/eval.py:173-231):
one directional light per texel of a lat-long envmap (the grid of
NeRFactor's gen_light_xyz, eval_utils.py:64-99), the texel's rgb as the
light's per-channel intensity; each light's rgb is the stage-2 reference's
(`render_eval`: the PSNet heads in float32, the visibility trunk at its
bf16 rounding points), summed over the lights in chunks, the chunk sums
added in order, then clipped and gamma-mapped. Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import stage2 as ref

CHUNK = 128


def envmap_dirs(light_h: int) -> np.ndarray:
    """Unit directions [light_h * 2 light_h, 3] of the texels, row-major
    from the top row (latitude pi/2 - step) and the first column
    (longitude pi - step)."""
    h, w = light_h, 2 * light_h
    lat_step, lng_step = np.pi / (h + 2), 2 * np.pi / (w + 2)
    lats = np.linspace(np.pi / 2 - lat_step, -np.pi / 2 + lat_step, h)
    lngs = np.linspace(np.pi - lng_step, -np.pi + lng_step, w)
    lngs, lats = np.meshgrid(lngs, lats)
    xyz = np.stack([np.cos(lats) * np.cos(lngs), np.cos(lats) * np.sin(lngs),
                    np.sin(lats)], -1).reshape(-1, 3)
    return xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)


@torch.no_grad()
def relight(W, net, points, normals, uv, pose, K, envmap: np.ndarray,
            gamma: float = 1.0, chunk: int = CHUNK) -> torch.Tensor:
    """The relit rgb [N, 3] of N surface pixels under envmap [h, 2h, 3]."""
    dev = points.device
    dirs = torch.as_tensor(envmap_dirs(envmap.shape[0]), dtype=torch.float32,
                           device=dev)
    texels = torch.as_tensor(envmap.reshape(-1, 3), dtype=torch.float32,
                             device=dev)
    acc = torch.zeros((points.shape[0], 3), device=dev)
    for s in range(0, dirs.shape[0], chunk):
        rgb = ref.render_eval(W, net, points, normals, uv, pose, K,
                              dirs[s:s + chunk], texels[s:s + chunk])["rgb"]
        acc = acc + rgb.sum(0)
    return torch.clamp(acc, 0, 1) ** (1.0 / gamma)
