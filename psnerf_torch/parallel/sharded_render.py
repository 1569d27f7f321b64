"""Full-frame stage-2 rendering over a mesh (counterpart of
psnerf_tpu/parallel/sharded_render.py).

Every rank gets the whole frame's inputs, renders its contiguous pixel
block with the port's frame renderer (and, on a rays x lights mesh, only
its block of the lights), so the fused_vis kernels run per rank; the
outputs are all-gathered in rank order, so every rank returns the whole
frame. Rays are independent: the only other collective is the light sum
rgb_sum on a rays x lights mesh, summed over the light axis.
"""

from __future__ import annotations

from psnerf_torch.eval.frame import render_frame_stage2
from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.parallel.mesh import (LIGHT_AXIS, RAY_AXIS, Mesh, all_sum,
                                        gather_lights, gather_rays,
                                        light_block, ray_block)


def _pix1(cfg: PSNetConfig) -> set:
    """The outputs whose pixel axis is the second: [L, N, ...] (as the
    frame renderer gives them) and rgb_cnl [3, N, L]."""
    return {"rgb", "visibility", "rgb_cnl"} | (
        {"rough"} if cfg.render_model == "sgbasis" else set())


def make_sharded_frame_renderer_2d(
    cfg: PSNetConfig,
    mesh: Mesh,
    tile: int = 4096,
    outputs: tuple = ("rgb",),
    use_fused_vis: bool = False,
    albedo_new=None,
    basis_new: int | None = None,
):
    """Returns fn(model, uv, pose, K, points, normals, mask, ldirs, lints)
    -> {name: [L, N, ...] or [N, ...]}, the whole frame on every rank.
    Over a rays x lights mesh (a 1-D mesh is its n x 1 case) each rank
    renders its block of the N pixels, in tiles of `tile`, under its block
    of the L lights: N % (ray ranks * tile) == 0 and L % light ranks == 0.
    Per-light outputs are gathered along both axes; rgb_sum (the envmap
    relighting's light sum) is summed over the light axis first.
    albedo_new / basis_new: the material-edit hooks, applied on every
    rank."""

    def fn(model, uv, pose, K, pts, nrm, msk, ld, li):
        n = uv.shape[0]
        if n % (mesh.shape[RAY_AXIS] * tile):
            raise ValueError(f"{n} pixels: not a multiple of {tile} pixels "
                             f"on each of {mesh.shape[RAY_AXIS]} ray ranks")
        rb = lambda x: ray_block(x, mesh)
        lb = lambda x: light_block(x, mesh, 0, "light count")
        out = render_frame_stage2(
            model, cfg, rb(uv), pose, K, rb(pts), rb(nrm), rb(msk), lb(ld),
            lb(li), tile=tile, outputs=outputs, use_fused_vis=use_fused_vis,
            albedo_new=albedo_new, basis_new=basis_new)
        pix1, res = _pix1(cfg), {}
        for k, v in out.items():
            if k == "rgb_sum":
                v = all_sum(v, mesh.groups[LIGHT_AXIS])
            elif k == "rgb_cnl":
                v = gather_lights(v, mesh, 2)
            elif k in pix1:
                v = gather_lights(v, mesh, 0)
            res[k] = gather_rays(v, mesh, 1 if k in pix1 else 0)
        return res

    return fn


# the JAX package's name for the ray-axis form; one renderer serves both
make_sharded_frame_renderer = make_sharded_frame_renderer_2d
