"""ctypes bindings of the native mesh library (counterpart of
psnerf_tpu/mesh/native.py, same API):

  MISE(res0, depth, threshold).query() / .update(points, values) /
    .to_dense(): the multi-resolution isosurface octree (final resolution
    res0 * 2**depth);
  marching_cubes(grid, iso) -> (vertices [V, 3] float64 in grid
    coordinates, triangles [T, 3] int64): marching tetrahedra over a dense
    grid, values > iso inside (see csrc/isosurface.cpp);
  the BVH of csrc/proximity.cpp (bound here, used by mesh/chamfer.py).

The library is built from this package's own csrc/ by mesh/build.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

from psnerf_torch.mesh.build import build

_lib_handle = []


def _load() -> ctypes.CDLL:
    if _lib_handle:
        return _lib_handle[0]
    L = ctypes.CDLL(build())
    p, i, i64, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_double)
    sigs = {
        "mise_new": ([i, i, d], p), "mise_free": ([p], None),
        "mise_resolution": ([p], i), "mise_query_count": ([p], i64),
        "mise_query": ([p, p], None), "mise_update": ([p, p, p, i64], None),
        "mise_to_dense": ([p, p], None), "mise_to_dense_f32": ([p, p], None),
        "iso_run": ([p, i64, i64, i64, d], p),
        "iso_run_f32": ([p, i64, i64, i64, d], p),
        "iso_n_verts": ([p], i64), "iso_n_tris": ([p], i64),
        "iso_copy": ([p, p, p], None), "iso_free": ([p], None),
        "bvh_build": ([p, i64, p, i64], p), "bvh_free": ([p], None),
        "bvh_distances": ([p, p, i64, p], None)}
    for name, (args, res) in sigs.items():
        fn = getattr(L, name)
        fn.argtypes, fn.restype = args, res
    _lib_handle.append(L)
    return L


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class MISE:
    """Multi-resolution isosurface octree (final res = res0 * 2**depth)."""

    def __init__(self, resolution0: int, depth: int, threshold: float):
        self._lib = _load()
        self._h = self._lib.mise_new(resolution0, depth, float(threshold))
        self.resolution = self._lib.mise_resolution(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mise_free(self._h)
            self._h = None

    def query(self) -> np.ndarray:
        """Integer grid points [n, 3] whose values the octree needs next."""
        n = self._lib.mise_query_count(self._h)
        out = np.empty((n, 3), dtype=np.int64)
        if n:
            self._lib.mise_query(self._h, _ptr(out))
        return out

    def update(self, points: np.ndarray, values: np.ndarray) -> None:
        points = np.ascontiguousarray(points, dtype=np.int64)
        values = np.ascontiguousarray(values, dtype=np.float64)
        if points.ndim != 2 or points.shape[1] != 3 \
                or values.shape != (points.shape[0],):
            raise ValueError(f"points {points.shape} and values "
                             f"{values.shape} do not match")
        self._lib.mise_update(self._h, _ptr(points), _ptr(values),
                              points.shape[0])

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        """The dense value grid [n, n, n], n = resolution + 1; float32
        halves the host memory of a 513^3 grid."""
        n = self.resolution + 1
        out = np.empty((n, n, n), dtype=dtype)
        if out.dtype == np.float32:
            self._lib.mise_to_dense_f32(self._h, _ptr(out))
        elif out.dtype == np.float64:
            self._lib.mise_to_dense(self._h, _ptr(out))
        else:
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        return out


def marching_cubes(grid: np.ndarray, iso: float = 0.0):
    """Dense scalar grid -> (vertices, triangles); values > iso are inside.
    float32 grids march natively (no float64 copy)."""
    lib = _load()
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-d, got {grid.shape}")
    if grid.dtype == np.float32:
        grid = np.ascontiguousarray(grid)
        run = lib.iso_run_f32
    else:
        grid = np.ascontiguousarray(grid, dtype=np.float64)
        run = lib.iso_run
    h = run(_ptr(grid), grid.shape[0], grid.shape[1], grid.shape[2],
            float(iso))
    try:
        nv, nt = lib.iso_n_verts(h), lib.iso_n_tris(h)
        verts = np.empty((nv, 3), dtype=np.float64)
        tris = np.empty((nt, 3), dtype=np.int64)
        if nv:
            lib.iso_copy(h, _ptr(verts), _ptr(tris))
    finally:
        lib.iso_free(h)
    return verts, tris
