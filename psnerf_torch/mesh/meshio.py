"""Mesh I/O and surface sampling in numpy (counterpart of
psnerf_tpu/mesh/meshio.py): OBJ and PLY (binary little-endian, or ascii on
load), triangle areas and area-weighted surface samples (the trimesh
functions the reference's Chamfer protocol uses, chamfer_dist.py:19-41)."""

from __future__ import annotations

import numpy as np


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def load_obj(path: str):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        f.write(np.asarray(vertices, "<f4").tobytes())
        packed = np.concatenate(
            [np.full((len(faces), 1), 3, "<u1").view("<u1"),
             np.asarray(faces, "<i4").view("<u1").reshape(len(faces), 12)],
            axis=1,
        )
        f.write(packed.tobytes())


def load_ply(path: str):
    """Load ascii or binary_little_endian PLY with float32 xyz + uchar-int faces."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode()
    n_vert = n_face = 0
    fmt = "ascii"
    for line in header.splitlines():
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element vertex"):
            n_vert = int(line.split()[-1])
        elif line.startswith("element face"):
            n_face = int(line.split()[-1])
    if fmt == "ascii":
        rows = data[end:].decode().split("\n")
        verts = np.asarray(
            [[float(x) for x in rows[i].split()[:3]] for i in range(n_vert)]
        )
        faces = np.asarray(
            [[int(x) for x in rows[n_vert + i].split()[1:4]] for i in range(n_face)],
            np.int64,
        )
        return verts, faces
    body = data[end:]
    verts = np.frombuffer(body, "<f4", n_vert * 3).reshape(n_vert, 3).astype(np.float64)
    off = n_vert * 12
    faces = np.empty((n_face, 3), np.int64)
    rec = np.frombuffer(body[off:off + n_face * 13], np.uint8).reshape(n_face, 13)
    faces[:] = rec[:, 1:].copy().view("<i4")
    return verts, faces


def load_mesh(path: str):
    if path.endswith(".obj"):
        return load_obj(path)
    if path.endswith(".ply"):
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def triangle_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


def sample_surface(
    vertices: np.ndarray, faces: np.ndarray, n: int,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Area-weighted uniform surface samples (trimesh.sample.sample_surface
    equivalent, used by chamfer_dist.py:19-25)."""
    rng = rng or np.random.default_rng(0)
    areas = triangle_areas(vertices, faces)
    probs = areas / areas.sum()
    idx = rng.choice(len(faces), size=n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    tri = vertices[faces[idx]]
    return tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])
