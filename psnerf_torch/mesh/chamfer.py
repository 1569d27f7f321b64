"""Chamfer distance between meshes (counterpart of
psnerf_tpu/mesh/chamfer.py; reference chamfer_dist.py:19-41).

Bidirectional mean of exact point-to-mesh distances over area-weighted
surface samples; the closest-point queries run through the native BVH
(csrc/proximity.cpp). The samples are numpy draws from default_rng(seed),
so the numbers equal the JAX package's."""

from __future__ import annotations

import numpy as np

from psnerf_torch.mesh import native
from psnerf_torch.mesh.meshio import sample_surface


class MeshProximity:
    """Exact point-to-triangle-mesh distances through a BVH."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self._lib = native._load()
        v = np.ascontiguousarray(vertices, np.float64)
        t = np.ascontiguousarray(faces, np.int64)
        self._h = self._lib.bvh_build(native._ptr(v), len(v),
                                      native._ptr(t), len(t))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bvh_free(self._h)
            self._h = None

    def distances(self, points: np.ndarray) -> np.ndarray:
        p = np.ascontiguousarray(points, np.float64)
        out = np.empty((len(p),), np.float64)
        self._lib.bvh_distances(self._h, native._ptr(p), len(p),
                                native._ptr(out))
        return out


def chamfer_distance(verts_src: np.ndarray, faces_src: np.ndarray,
                     verts_tgt: np.ndarray, faces_tgt: np.ndarray,
                     num_samples: int = 10_000, seed: int = 0) -> float:
    """Mean bidirectional sampled point-to-surface distance (the meshes'
    units; the CLI multiplies by 1000 for mm)."""
    rng = np.random.default_rng(seed)
    src_pts = sample_surface(verts_src, faces_src, num_samples, rng)
    tgt_pts = sample_surface(verts_tgt, faces_tgt, num_samples, rng)
    d_st = MeshProximity(verts_tgt, faces_tgt).distances(src_pts)
    d_ts = MeshProximity(verts_src, faces_src).distances(tgt_pts)
    d_st = np.nan_to_num(d_st)
    d_ts = np.nan_to_num(d_ts)
    return float((d_st.mean() + d_ts.mean()) / 2.0)


def surface_distance(verts_src: np.ndarray, faces_src: np.ndarray,
                     verts_tgt: np.ndarray, faces_tgt: np.ndarray,
                     num_samples: int = 10_000, seed: int = 0) -> float:
    """One-directional P2S: mean distance from src surface samples to the
    target mesh (stage2/utils/metrics.py:103-113)."""
    rng = np.random.default_rng(seed)
    src_pts = sample_surface(verts_src, faces_src, num_samples, rng)
    d = MeshProximity(verts_tgt, faces_tgt).distances(src_pts)
    return float(np.nan_to_num(d).mean())
