"""The layout of the stage-1 shape export over a mesh (counterpart of
psnerf_tpu/parallel/sharded_export.py). The export's march and visibility
(psnerf_torch.runners.stage1.export_fns) are per ray, so their only
collectives gather the outputs: each rank marches its block of the pixels,
and its block of the surface points toward its block of the lights over
the rays x lights layout below.
"""

from __future__ import annotations

from psnerf_torch.parallel.mesh import Mesh, make_mesh_2d


def export_vis_mesh(mesh: Mesh) -> Mesh:
    """The rays x lights layout of the visibility pass over the ranks of a
    1-D mesh: n // 2 x 2 for an even count n > 1 (the split only balances
    each rank's working set), else the mesh itself (n x 1; one rank
    included). Made once per mesh; every rank must ask for it, as every
    rank makes a mesh's groups."""
    got = getattr(mesh, "_vis_mesh", None)
    if got is None:
        n = mesh.size
        got = mesh._vis_mesh = (make_mesh_2d(n // 2, 2, mesh.device)
                                if n > 1 and n % 2 == 0 else mesh)
    return got
