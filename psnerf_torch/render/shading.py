"""Stage-2 shading layer (counterpart of psnerf_tpu/render/shading.py).

The per-point heads (albedo, SG weights, normal) run once per point; the
per-(light, point) work (SG specular, cosine, visibility MLP) carries the
light axis as a leading batch dimension. Outputs outside the surface mask
take the reference's fill values (ones, zeros for sg_weight).

Training adds the jittered heads of the smoothness losses, from standard
normal draws given as `noise` (`draw_psnet_noise`; None on the eval path),
and the visibility of extra supervision lights (`light_vis_train`).
Material edits (renderer.py:167-181) override the albedo (`albedo_new`)
or swap the SG weights for one basis lobe (`basis_new`).
"""

from __future__ import annotations

import torch

from psnerf_torch.core.encoding import nerf_embed
from psnerf_torch.fields.brdf import microfacet_brdf, sg_basis
from psnerf_torch.fields.psnet import PSNet, PSNetConfig


def _normalize(v, eps=1e-12):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), eps)


def _cdt(cfg: PSNetConfig):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def draw_psnet_noise(n: int, generator: torch.Generator,
                     device: str | torch.device = "cpu") -> dict:
    """The jitter draws of one training render of n points: standard
    normal offsets {"xyz": [n, 3], "normal": [n, 3]} (render_psnet scales
    them by the config's jitter std)."""
    draw = lambda: torch.randn((n, 3), generator=generator, device=device)
    return {"xyz": draw(), "normal": draw()}


def psnet_point_heads(model: PSNet, cfg: PSNetConfig, points: torch.Tensor,
                      normals_pregen: torch.Tensor,
                      albedo_new=None, basis_new: int | None = None) -> dict:
    """The light-independent heads, once per point. Returns {point_emb,
    albedo, weights, normal, normal_pred?}; `normal` is the shading normal
    (the MLP's when cfg.normal_mlp, else the stage-1 one).

    Edits: albedo_new [3] replaces every point's albedo; basis_new (SG
    model) replaces the SG weights by 2**basis_new / 100 on that lobe and
    0 elsewhere, on every channel when cfg.specular_rgb."""
    cdt = _cdt(cfg)
    n = points.shape[0]
    point_emb = nerf_embed(points, cfg.n_freqs_xyz)
    albedo = model["albedo"](point_emb, cdt)
    if albedo_new is not None:
        albedo = torch.as_tensor(albedo_new, dtype=albedo.dtype,
                                 device=albedo.device).expand(albedo.shape)
    weights = model["rough"](point_emb, cdt)
    if cfg.render_model == "sgbasis":
        weights = torch.relu(weights)
        if basis_new is not None:
            w_new = torch.zeros_like(weights)
            val = 2.0 ** basis_new / 100.0
            if cfg.specular_rgb:
                w_new.view(n, 3, cfg.nbasis)[:, :, basis_new] = val
            else:
                w_new[:, basis_new] = val
            weights = w_new
    out = {"point_emb": point_emb, "albedo": albedo, "weights": weights}
    if cfg.normal_mlp:
        emb_n = nerf_embed(points, cfg.normal_n_freqs_xyz)
        out["normal"] = _normalize(model["normal"](emb_n, cdt))
        out["normal_pred"] = out["normal"]
    else:
        out["normal"] = normals_pregen
    return out


def render_psnet(
    model: PSNet,
    cfg: PSNetConfig,
    points: torch.Tensor,           # [N, 3] surface points
    normals_pregen: torch.Tensor,   # [N, 3] stage-1 normals
    surface_mask: torch.Tensor,     # [N] bool
    ray_dirs: torch.Tensor,         # [N, 3] unit camera rays
    light_dirs: torch.Tensor,       # [L, 3] unit light directions (world)
    light_ints: torch.Tensor,       # [], [L] or [L, 3]
    vis_precomputed: torch.Tensor | None = None,  # [L, N, 1] raw vis
    noise: dict | None = None,      # jitter draws (None: eval, no jitter)
    light_vis_train: torch.Tensor | None = None,  # [Lv, 3] extra vis lights
    albedo_new=None,                # [3] albedo edit
    basis_new: int | None = None,   # SG basis index edit
) -> dict:
    """All N pixels under all L lights: rgb [L, N, 3], albedo [N, 3],
    sg_weight [N, n_weights], rough [L, N, 3] (SG specular) or [N, 3]
    (microfacet), normal_pred [N, 3], visibility [L, N, 1]; with noise
    (and cfg.xyz_jitter_std > 0) albedo_jitter, rough_jitter and, for a
    normal MLP with normal_jitter_std > 0, normal_jitter; with
    light_vis_train, vis_train [Lv, N]. albedo_new / basis_new: the
    material edits of psnet_point_heads."""
    n = points.shape[0]
    n_l = light_dirs.shape[0]
    mask1 = surface_mask[:, None]
    heads = psnet_point_heads(model, cfg, points, normals_pregen,
                              albedo_new, basis_new)
    point_emb, albedo, weights = (
        heads["point_emb"], heads["albedo"], heads["weights"])
    normal = heads["normal"]
    pts2c = -ray_dirs

    light_ints = torch.as_tensor(light_ints, dtype=points.dtype,
                                 device=points.device)
    if light_ints.ndim == 0:
        light_ints = light_ints.expand(n_l)
    lint = light_ints[:, None, None] if light_ints.ndim == 1 \
        else light_ints[:, None, :]                           # [L, 1, 1|3]
    l = light_dirs[:, None, :].expand(n_l, n, 3)              # [L, N, 3]

    if cfg.render_model == "sgbasis":
        brdf, spec = sg_basis(v=pts2c[None], n=normal[None], l=l,
                              albedo=albedo[None], weights=weights[None],
                              specular_rgb=cfg.specular_rgb, nbasis=cfg.nbasis)
    else:
        brdf = microfacet_brdf(l=l, v=pts2c[None], n=normal[None],
                               albedo=albedo[None], rough=weights[None],
                               f0=cfg.fresnel_f0)
        spec = weights
    cos = torch.sum(l * normal[None], dim=-1, keepdim=True)   # [L, N, 1]
    if cfg.visibility:
        if vis_precomputed is not None:
            vis = vis_precomputed
        else:
            vis = _visibility(model, cfg, point_emb, l)       # [L, N, 1]
        vis_c = torch.clamp(vis, 0.0, 1.0)
        if cfg.vis_rgb_detach:
            vis_c = vis_c.detach()
        rgb = torch.clamp(brdf * lint * cos * vis_c, 0.0, 1.0)
    else:
        vis = torch.ones((n_l, n, 1), dtype=brdf.dtype, device=brdf.device)
        rgb = torch.clamp(brdf * lint * cos, 0.0, 1.0)

    one = torch.ones((), dtype=rgb.dtype, device=rgb.device)
    zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    out = {
        "points": points,
        "network_object_mask": surface_mask,
        "rgb": torch.where(mask1[None], rgb, one),
        "normal_values": normals_pregen,
        "albedo": torch.where(mask1, albedo, one),
        "sg_weight": torch.where(mask1, weights, zero),
        "visibility": torch.where(mask1[None], vis, one),
    }
    if cfg.render_model == "sgbasis":
        out["rough"] = torch.where(
            mask1[None], spec.expand(*spec.shape[:-1], 3), one)
    else:
        out["rough"] = torch.where(mask1, weights.expand(n, 3), one)
    if cfg.normal_mlp:
        out["normal_pred"] = torch.where(mask1, heads["normal_pred"], one)

    # jittered duplicates for the smoothness losses
    if noise is not None and cfg.xyz_jitter_std > 0:
        cdt = _cdt(cfg)
        emb_jit = nerf_embed(points + cfg.xyz_jitter_std * noise["xyz"],
                             cfg.n_freqs_xyz)
        rough_jit = model["rough"](emb_jit, cdt)
        if cfg.render_model == "sgbasis":
            rough_jit = torch.relu(rough_jit)
        out["albedo_jitter"] = torch.where(
            mask1, model["albedo"](emb_jit, cdt), one)
        out["rough_jitter"] = torch.where(mask1, rough_jit, one)
        if cfg.normal_mlp and cfg.normal_jitter_std > 0:
            emb_jn = nerf_embed(
                points + cfg.normal_jitter_std * noise["normal"],
                cfg.normal_n_freqs_xyz)
            out["normal_jitter"] = torch.where(
                mask1, _normalize(model["normal"](emb_jn, cdt)), one)

    # extra visibility supervision lights
    if cfg.visibility and light_vis_train is not None:
        l_v = light_vis_train[:, None, :].expand(-1, n, 3)
        vt = _visibility(model, cfg, point_emb, l_v)[..., 0]   # [Lv, N]
        out["vis_train"] = torch.where(surface_mask[None], vt, one)
    return out


def _visibility(model: PSNet, cfg: PSNetConfig, point_emb: torch.Tensor,
                l: torch.Tensor) -> torch.Tensor:
    """The visibility MLP on (point, light) rows: l [L, N, 3] -> [L, N, 1];
    the light input is detached when cfg.light_vis_detach."""
    if cfg.light_vis_detach:
        l = l.detach()
    x = torch.cat([point_emb[None].expand(l.shape[0], -1, -1),
                   nerf_embed(l, cfg.n_freqs_xyz)], dim=-1)
    return model["visibility"](x, _cdt(cfg))
