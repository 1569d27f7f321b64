"""The stage-1 shape export over a mesh (counterpart of
psnerf_tpu/parallel/sharded_export.py): the surface march and the
per-light visibility march, the pipeline's most expensive step.

Both passes are per ray, so their only collectives gather the outputs:

  * the march (pixels -> points, normals, mask): each rank marches its
    contiguous block of the pixels, with the fused_occ kernel per rank
    when the caller's occupancy route takes it;
  * the visibility (surface points x lights -> transmittance): over a
    rays x lights mesh (export_vis_mesh), each rank marches its block of the
    points toward its block of the lights.
"""

from __future__ import annotations

from psnerf_torch.fields.occupancy import occ_alpha
from psnerf_torch.parallel.mesh import (Mesh, gather_lights, gather_rays,
                                        light_block, make_mesh_2d, ray_block)
from psnerf_torch.render.marching import light_visibility
from psnerf_torch.render.unisurf import render_shape_extract


def make_sharded_march_fn(field_cfg, rcfg, mesh: Mesh, n_steps: int = 512,
                          occ_builder=None):
    """Returns fn(field, pix [N, 2], K, pose) -> {points, normal, mask}
    over all N pixels on every rank, each rank marching its block of them.
    N must be divisible by the ray ranks. occ_builder(field) -> occ_fn
    builds the rank's occupancy closure (the fused_occ kernel's; None: the
    plain route)."""

    def fn(field, pix, K, pose):
        occ_fn = occ_builder(field) if occ_builder is not None else None
        out = render_shape_extract(field, field_cfg, rcfg,
                                   ray_block(pix, mesh, 0, "pixels"), K, pose,
                                   n_steps=n_steps, occ_fn=occ_fn)
        return {k: gather_rays(v, mesh) for k, v in out.items()}

    return fn


def make_sharded_vis_fn(field_cfg, mesh2: Mesh, occ_builder=None,
                        vis_steps: int = 128, vis_rescale: bool = False,
                        light_chunk: int = 1, guide_coarse: int = 16):
    """Returns fn(field, surf [N, 3], light_dir [L, 3], guide=None) ->
    visibility [L, N] on every rank, each rank marching its block of the
    points toward its block of the lights over the rays x lights mesh
    mesh2: N % ray ranks == 0 and L % light ranks == 0 (callers pad both).
    vis_steps / vis_rescale / guide / guide_coarse select the protocol and
    light_chunk the lights per occupancy call on each rank
    (render.marching.light_visibility); the guide grid is whole on every
    rank."""

    def fn(field, surf, light_dir, guide=None):
        occ_fn = (occ_builder(field) if occ_builder is not None
                  else lambda p: occ_alpha(field, p, field_cfg))
        vis = light_visibility(
            occ_fn, ray_block(surf, mesh2, 0, "surface points"),
            light_block(light_dir, mesh2, 0, "lights"), n_steps=vis_steps,
            rescale=vis_rescale, light_chunk=light_chunk, guide=guide,
            guide_coarse=guide_coarse)
        return gather_rays(gather_lights(vis, mesh2, 0), mesh2, 1)

    return fn


def export_vis_mesh(mesh: Mesh) -> Mesh:
    """The rays x lights layout of the visibility pass over the ranks of a
    1-D mesh: n // 2 x 2 for an even count n > 1 (the split only balances
    each rank's working set), else the mesh itself (n x 1). Made once per
    mesh; every rank must ask for it, as every rank makes a mesh's
    groups."""
    got = getattr(mesh, "_vis_mesh", None)
    if got is None:
        n = mesh.size
        got = mesh._vis_mesh = (make_mesh_2d(n // 2, 2, mesh.device)
                                if n > 1 and n % 2 == 0 else mesh)
    return got
