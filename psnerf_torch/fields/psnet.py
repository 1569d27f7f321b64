"""Stage-2 PSNet (counterpart of psnerf_tpu/fields/psnet.py): SVBRDF,
normal and visibility MLPs.

  * albedo:     SkipMLP(PE(xyz; 10), 3, W=128, depth=4, skip@2), sigmoid out
  * rough (SG): SkipMLP(PE(xyz), nbasis[*3], W=64, depth=2, no skip)
  * rough (MF): SkipMLP(PE(xyz), 1, 128, 4, skip@2), sigmoid out
  * normal:     SkipMLP(PE(xyz), 3, 128, 4, skip@2), normalized out
  * visibility: SkipMLP(PE(xyz) ++ PE(l), 1, 256, 8, skip@4)

PSNet is an nn.ModuleDict of those heads; its state-dict key `albedo.0.w`
is the JAX leaf path `albedo/0/w`. The forward pass lives in
psnerf_torch.render.shading.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from psnerf_torch.core.encoding import nerf_embed_dim
from psnerf_torch.fields.mlp import skip_mlp_init


@dataclasses.dataclass(frozen=True)
class PSNetConfig:
    render_model: str = "sgbasis"      # 'sgbasis' | 'microfacet'
    nbasis: int = 9
    specular_rgb: bool = True
    fresnel_f0: float = 0.05
    light_int: float = 2.0

    n_freqs_xyz: int = 10
    mlp_width: int = 128
    mlp_depth: int = 4
    mlp_skip_at: int = 2
    xyz_jitter_std: float = 0.01

    sg_mlp_width: int = 64
    sg_mlp_depth: int = 2
    sg_mlp_skip_at: int = -1

    normal_mlp: bool = True
    normal_joint: bool = True
    normal_n_freqs_xyz: int = 10
    normal_mlp_width: int = 128
    normal_mlp_depth: int = 4
    normal_mlp_skip_at: int = 2
    normal_jitter_std: float = 0.0

    visibility: bool = True
    light_vis_detach: bool = True
    vis_rgb_detach: bool = True
    vis_mlp_width: int = 256
    vis_mlp_depth: int = 8
    vis_mlp_skip_at: int = 4

    # 'float32' | 'bfloat16': matmul precision of the per-point MLPs
    compute_dtype: str = "float32"

    @property
    def dim_emb(self) -> int:
        return nerf_embed_dim(3, self.n_freqs_xyz)

    @property
    def dim_emb_n(self) -> int:
        return nerf_embed_dim(3, self.normal_n_freqs_xyz)

    @property
    def n_weights(self) -> int:
        """Width of the SG-weight head output."""
        return self.nbasis * (3 if self.specular_rgb else 1)


class PSNet(nn.ModuleDict):
    """{albedo, rough, normal?, visibility?} heads of one PSNetConfig."""

    def __init__(self, cfg: PSNetConfig, heads: dict):
        super().__init__(heads)
        self.cfg = cfg


def init_psnet(cfg: PSNetConfig, generator: torch.Generator | None = None,
               device: str | torch.device = "cpu") -> PSNet:
    kw = dict(generator=generator, device=device)
    heads = {"albedo": skip_mlp_init(
        cfg.dim_emb, 3, cfg.mlp_width, cfg.mlp_depth, (cfg.mlp_skip_at,),
        "sigmoid", **kw)}
    if cfg.render_model == "sgbasis":
        heads["rough"] = skip_mlp_init(
            cfg.dim_emb, cfg.n_weights, cfg.sg_mlp_width, cfg.sg_mlp_depth,
            (cfg.sg_mlp_skip_at,), "none", **kw)
    elif cfg.render_model == "microfacet":
        heads["rough"] = skip_mlp_init(
            cfg.dim_emb, 1, cfg.mlp_width, cfg.mlp_depth, (cfg.mlp_skip_at,),
            "sigmoid", **kw)
    else:
        raise ValueError(f"unknown render_model {cfg.render_model!r}")
    if cfg.normal_mlp:
        heads["normal"] = skip_mlp_init(
            cfg.dim_emb_n, 3, cfg.normal_mlp_width, cfg.normal_mlp_depth,
            (cfg.normal_mlp_skip_at,), "none", **kw)
    if cfg.visibility:
        heads["visibility"] = skip_mlp_init(
            cfg.dim_emb * 2, 1, cfg.vis_mlp_width, cfg.vis_mlp_depth,
            (cfg.vis_mlp_skip_at,), "none", **kw)
    return PSNet(cfg, heads)
