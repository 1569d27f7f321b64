"""Phong visualisation render (counterpart of psnerf_tpu/render/phong.py):
headlight diffuse shading of the marched surface, the last panel of the
stage-1 visualisation strip."""

from __future__ import annotations

import torch

from psnerf_torch.fields.occupancy import OccFieldConfig, occ_gradient
from psnerf_torch.render.unisurf import UnisurfConfig, _march_and_surface

DIFFUSE = (0.7, 0.7, 0.7)
AMBIENT = (0.3, 0.3, 0.3)


def phong_shade(normals: torch.Tensor, mask: torch.Tensor,
                light: torch.Tensor) -> torch.Tensor:
    """Ambient plus headlight diffuse [N, 3] for unit normals [N, 3] under
    the unit light direction [3]; white where mask [N] is off."""
    diffuse = torch.clamp_min(normals @ light, 0.0)[:, None] * \
        normals.new_tensor(DIFFUSE)
    shaded = torch.clamp_max(normals.new_tensor(AMBIENT) + diffuse, 1.0)
    return torch.where(mask[:, None], shaded, 1.0)


@torch.no_grad()
def render_phong(field, field_cfg: OccFieldConfig, rcfg: UnisurfConfig,
                 pixels: torch.Tensor, camera_mat: torch.Tensor,
                 world_mat: torch.Tensor, n_steps: int = 512) -> dict:
    """Re-march the pixels [N, 2] and shade the surface with a light at the
    camera: {"rgb": [N, 3]}."""
    _, _, _, points, surface_mask = _march_and_surface(
        field, field_cfg, rcfg, pixels, camera_mat, world_mat, n_steps)
    light = world_mat[:3, 3] / torch.linalg.norm(world_mat[:3, 3])
    g = occ_gradient(field, points, field_cfg)
    normals = g / torch.clamp_min(torch.linalg.norm(g, dim=-1, keepdim=True),
                                  1e-12)
    return {"rgb": phong_shade(normals, surface_mask, light)}
