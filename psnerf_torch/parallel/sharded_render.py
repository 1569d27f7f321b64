"""Full-frame stage-2 rendering over a mesh (counterpart of
psnerf_tpu/parallel/sharded_render.py), in two steps around the port's
frame renderer:

  * frame_block: this rank's contiguous block of the frame's pixels (and,
    on a rays x lights mesh, of its lights), from the whole frame's
    inputs, which every rank holds;
  * gather_frame: the rank's outputs all-gathered in rank order, so every
    rank returns the whole frame. Rays are independent: the only other
    collective is the light sum rgb_sum on a rays x lights mesh, summed
    over the light axis.

On one rank both return their inputs. Stage2Runner.render_view calls the
renderer between them, so the fused_vis kernels run per rank;
make_sharded_frame_renderer_2d is the same composition as a function.
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


def frame_block(mesh: Mesh, tile: int, uv, pose, K, pts, nrm, msk, ld,
                li) -> tuple:
    """This rank's block of the frame renderer's inputs (uv, pose, K,
    points, normals, mask, ldirs, lints), in that order: its block of the
    N pixels, rendered in tiles of `tile`, and of the L lights. N %
    (ray ranks * tile) == 0 and L % light ranks == 0."""
    n = uv.shape[0]
    if n % (mesh.shape[RAY_AXIS] * tile):
        raise ValueError(f"{n} pixels: not a multiple of {tile} pixels "
                         f"on each of {mesh.shape[RAY_AXIS]} ray ranks")
    rb = lambda x: ray_block(x, mesh)
    lb = lambda x: light_block(x, mesh, 0, "light count")
    return rb(uv), pose, K, rb(pts), rb(nrm), rb(msk), lb(ld), lb(li)


def gather_frame(out: dict, cfg: PSNetConfig, mesh: Mesh) -> dict:
    """The whole frame's {name: [L, N, ...] or [N, ...]} on every rank from
    each rank's frame_block outputs: per-light outputs gathered along both
    axes, rgb_sum (the envmap relighting's light sum) summed over the
    light axis first."""
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
    -> {name: [L, N, ...] or [N, ...]}, the whole frame on every rank:
    gather_frame of render_frame_stage2 on frame_block's inputs. Over a
    rays x lights mesh (a 1-D mesh is its n x 1 case) each rank renders
    its block of the N pixels, in tiles of `tile`, under its block of the
    L lights. albedo_new / basis_new: the material-edit hooks, applied on
    every rank."""

    def fn(model, *args):
        out = render_frame_stage2(
            model, cfg, *frame_block(mesh, tile, *args), tile=tile,
            outputs=outputs, use_fused_vis=use_fused_vis,
            albedo_new=albedo_new, basis_new=basis_new)
        return gather_frame(out, cfg, mesh)

    return fn


# the JAX package's name for the ray-axis form; one renderer serves both
make_sharded_frame_renderer = make_sharded_frame_renderer_2d
