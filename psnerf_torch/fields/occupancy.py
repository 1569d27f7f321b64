"""Stage-1 occupancy + appearance field (counterpart of
psnerf_tpu/fields/occupancy.py).

  * geometry MLP: softplus(beta=100), hidden 256, skip at layer 4 (input
    re-concatenated, divided by sqrt(2)), weight norm on every layer,
    geometric init to a sphere of radius ~0.6. Emits 1 occupancy logit +
    `feat_size` feature channels.
  * appearance MLP: 4 hidden ReLU layers on [p, PE(view), normal, feat],
    output tanh(x) * 0.5 + 0.5.
  * occupancy probability alpha = sigmoid(-10 * logit).
  * analytic normals = gradient of the raw logit wrt position, by
    torch.autograd.grad with create_graph, so a loss on them
    differentiates through to the weights (second order).

The field is an nn.Module with `geo` and `app` lists of WNLinear, so its
state-dict keys (`geo.0.v`, ...) are the JAX leaf paths (`geo/0/v`, ...).
All apply functions take points [..., 3] and broadcast over leading axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from psnerf_torch.core.encoding import nerf_embed, nerf_embed_dim
from psnerf_torch.fields.mlp import wn_from_dense, wn_linear_apply


@dataclasses.dataclass(frozen=True)
class OccFieldConfig:
    num_layers: int = 8          # hidden layers in the geometry MLP
    hidden_dim: int = 256
    octaves_pe: int = 6          # position PE octaves
    octaves_pe_views: int = 4    # view-direction PE octaves
    skips: Sequence[int] = (4,)
    feat_size: int = 256
    rescale: float = 1.0
    geometric_init: bool = True
    sphere_bias: float = 0.6     # radius of the init sphere
    # 'float32' | 'bfloat16': the matmul operand type of the field's
    # products (weights and activations rounded to bf16, f32 accumulation;
    # the weight-norm fold, bias adds and activations stay f32)
    compute_dtype: str = "float32"

    @property
    def _cdt(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None

    @property
    def dim_embed(self) -> int:
        return nerf_embed_dim(3, self.octaves_pe)

    @property
    def dim_embed_view(self) -> int:
        # [p(3), PE(view), normal(3), feat]; PE(view) includes the raw view
        return 3 + nerf_embed_dim(3, self.octaves_pe_views) + 3 + self.feat_size

    @property
    def dims_geo(self) -> list:
        return ([self.dim_embed] + [self.hidden_dim] * self.num_layers
                + [self.feat_size + 1])


class OccField(nn.Module):
    def __init__(self, geo, app):
        super().__init__()
        self.geo = nn.ModuleList(geo)
        self.app = nn.ModuleList(app)


def init_occupancy_field(cfg: OccFieldConfig,
                         generator: torch.Generator | None = None,
                         device: str | torch.device = "cpu") -> OccField:
    """SAL geometric init of the geometry MLP and torch's default init of
    the appearance MLP. Draws on the CPU from `generator`, then moves, so a
    seed gives the same weights on every device (not JAX's weights: the
    two packages' generators differ)."""
    dims_geo = cfg.dims_geo
    n_geo = len(dims_geo) - 1
    normal = lambda *shape: torch.randn(shape, generator=generator)

    def uniform(shape, bound):
        return torch.rand(shape, generator=generator) * (2 * bound) - bound

    geo = []
    for l in range(n_geo):
        din = dims_geo[l]
        dout = (dims_geo[l + 1] - dims_geo[0] if l + 1 in cfg.skips
                else dims_geo[l + 1])
        if cfg.geometric_init:
            if l == n_geo - 1:
                w = (torch.full((din, dout), math.sqrt(math.pi) / math.sqrt(din))
                     + 1e-4 * normal(din, dout))
                b = torch.full((dout,), -cfg.sphere_bias)
            elif cfg.octaves_pe > 0 and l == 0:
                w = torch.zeros((din, dout))
                w[:3] = math.sqrt(2) / math.sqrt(dout) * normal(3, dout)
                b = torch.zeros((dout,))
            elif cfg.octaves_pe > 0 and l in cfg.skips:
                w = math.sqrt(2) / math.sqrt(dout) * normal(din, dout)
                w[-(dims_geo[0] - 3):] = 0.0   # the re-concatenated PE rows
                b = torch.zeros((dout,))
            else:
                w = math.sqrt(2) / math.sqrt(dout) * normal(din, dout)
                b = torch.zeros((dout,))
        else:
            bound = math.sqrt(1.0 / din)
            w, b = uniform((din, dout), bound), uniform((dout,), bound)
        geo.append(wn_from_dense(w.to(device), b.to(device)))

    dims_view = [cfg.dim_embed_view] + [cfg.hidden_dim] * 4 + [3]
    app = []
    for l in range(len(dims_view) - 1):
        din, dout = dims_view[l], dims_view[l + 1]
        bound = math.sqrt(1.0 / din)
        w, b = uniform((din, dout), bound), uniform((dout,), bound)
        app.append(wn_from_dense(w.to(device), b.to(device)))
    return OccField(geo, app)


def _softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus with beta=100: log(1 + e^(100 x)) / 100, linear above the
    cutover at 100 x > 20."""
    bx = 100.0 * x
    return torch.where(bx > 20.0, x, torch.nn.functional.softplus(bx) / 100.0)


def _rnd(x: torch.Tensor, cdt) -> torch.Tensor:
    return x if cdt is None else x.to(cdt).float()


def occ_logits_and_feat(field: OccField, p: torch.Tensor,
                        cfg: OccFieldConfig) -> torch.Tensor:
    """Geometry MLP: points [..., 3] -> [..., 1 + feat_size]. Channel 0 is
    the raw occupancy logit (positive outside at init)."""
    cdt = cfg._cdt
    pe = _rnd(nerf_embed(p / cfg.rescale, cfg.octaves_pe), cdt)
    x = pe
    n = len(field.geo)
    for l, lyr in enumerate(field.geo):
        if l in cfg.skips:
            x = _rnd(torch.cat([x, pe], dim=-1) / math.sqrt(2), cdt)
        x = wn_linear_apply(lyr, x, cdt)
        if l < n - 1:
            x = _rnd(_softplus100(x), cdt)
    return x


def occ_logit(field: OccField, p: torch.Tensor,
              cfg: OccFieldConfig) -> torch.Tensor:
    """Raw logit only: [..., 3] -> [...]."""
    return occ_logits_and_feat(field, p, cfg)[..., 0]


def occ_alpha(field: OccField, p: torch.Tensor,
              cfg: OccFieldConfig) -> torch.Tensor:
    """Occupancy probability alpha = sigmoid(-10 * logit)."""
    return torch.sigmoid(-10.0 * occ_logit(field, p, cfg))


def _logits_and_gradient(field, p, cfg):
    """(geometry output [..., 1 + feat], d logit / d p [..., 3]). The
    gradient keeps its graph (create_graph) whenever grad mode is on, so
    losses on the normals reach the weights; the points themselves get no
    gradient (the call sites' points come from the no-grad march)."""
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        out = occ_logits_and_feat(field, q, cfg)
        g, = torch.autograd.grad(out[..., 0].sum(), q, create_graph=keep)
    return (out, g) if keep else (out.detach(), g.detach())


def occ_gradient(field: OccField, p: torch.Tensor,
                 cfg: OccFieldConfig) -> torch.Tensor:
    """Spatial gradient of the raw logit (normal direction), [..., 3]."""
    return _logits_and_gradient(field, p, cfg)[1]


def appearance(field: OccField, p: torch.Tensor, normals: torch.Tensor,
               view_dirs: torch.Tensor, feat: torch.Tensor,
               cfg: OccFieldConfig) -> torch.Tensor:
    """Appearance MLP -> rgb in [0, 1]. view_dirs are PE-encoded unit
    directions."""
    cdt = cfg._cdt
    x = _rnd(torch.cat([p, view_dirs, normals, feat], dim=-1), cdt)
    n = len(field.app)
    for l, lyr in enumerate(field.app):
        x = wn_linear_apply(lyr, x, cdt)
        if l < n - 1:
            x = _rnd(torch.relu(x), cdt)
    return torch.tanh(x) * 0.5 + 0.5


def radiance_and_alpha(field: OccField, p: torch.Tensor, ray_d: torch.Tensor,
                       cfg: OccFieldConfig):
    """Full forward: (rgb [..., 3], alpha [...]). The normals carry their
    graph into the appearance MLP, so the weight gradients include the
    second-order terms of the normal path. One geometry forward serves the
    logit, the feature and (by autograd) the normals."""
    out, normals = _logits_and_gradient(field, p, cfg)
    logit, feat = out[..., 0], out[..., 1:]
    view = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    view_pe = nerf_embed(view, cfg.octaves_pe_views)
    rgb = appearance(field, p, normals, view_pe, feat, cfg)
    return rgb, torch.sigmoid(-10.0 * logit)
