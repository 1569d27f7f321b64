"""Mesh vertex refinement and multi-view silhouette carving (counterpart of
psnerf_tpu/mesh/refine.py).

refine_mesh: RMSprop on the vertex positions, pulling random face samples
onto the occupancy iso level while aligning face normals with the field's
gradient (reference stage1/model/extracting.py:237-323); the loss holds
the field's gradient, so its vertex gradient is a second-order autograd.

make_mask_carver: the multi-view projection test against dilated masks
that carves the value grid before marching (extracting.py:326-377), as a
device program over fixed-size point chunks.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from scipy import ndimage

from psnerf_torch.device import resolve_device


def draw_refine_samples(n_faces: int, fb: int, generator: torch.Generator,
                        device) -> tuple:
    """One step's draws: fb distinct face indices [fb] and Dirichlet(1/2,
    1/2, 1/2) barycentrics [fb, 3] (squared standard normals, each half a
    Gamma(1/2) draw, normalised)."""
    idx = torch.randperm(n_faces, generator=generator, device=device)[:fb]
    z = torch.randn((fb, 3), generator=generator, device=device)
    gam = z * z
    return idx, gam / gam.sum(dim=-1, keepdim=True)


def refine_mesh(
    occ_fn: Callable,      # [M, 3] -> occupancy in [0, 1], differentiable
    vertices: np.ndarray,
    faces: np.ndarray,
    steps: int = 100,
    faces_per_step: int = 10_000,
    lr: float = 1e-5,
    threshold: float = 0.5,
    normal_weight: float = 0.01,
    seed: int = 0,
    draws: Sequence | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Returns the refined vertices. Loss per sampled face point p (a
    Dirichlet barycentric sample): (occ(p) - tau)^2 + w * ||n_face -
    n_field||^2, n_field = -grad occ / |grad occ|.

    draws: per step (face indices [fb], barycentrics [fb, 3]), fb =
    min(faces_per_step, faces); by default draw_refine_samples from a
    torch.Generator seeded with `seed` on the device."""
    dev = resolve_device(device)
    v = torch.tensor(np.asarray(vertices), dtype=torch.float32, device=dev)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    n_faces = f.shape[0]
    fb = min(faces_per_step, n_faces)
    if draws is not None and len(draws) < steps:
        raise ValueError(f"{len(draws)} draws for {steps} steps")
    gen = None if draws is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    ms = torch.zeros_like(v)
    for i in range(steps):
        if draws is not None:
            idx, eps = draws[i]
            idx = torch.tensor(np.asarray(idx), dtype=torch.int64, device=dev)
            eps = torch.tensor(np.asarray(eps), dtype=torch.float32,
                               device=dev)
        else:
            idx, eps = draw_refine_samples(n_faces, fb, gen, dev)
        v.requires_grad_(True)
        tri = v[f[idx]]                                    # [fb, 3, 3]
        p = torch.sum(tri * eps[:, :, None], dim=1)        # [fb, 3]
        face_n = torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 1],
                             dim=-1)
        face_n = face_n / (torch.linalg.norm(face_n, dim=-1, keepdim=True)
                           + 1e-10)
        occ = occ_fn(p)
        # the field's gradient at each point (points are independent, so
        # the gradient of the sum is the per-point gradient)
        g = torch.autograd.grad(occ.sum(), p, create_graph=True)[0]
        target_n = -g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-10)
        loss_t = torch.mean((occ - threshold) ** 2)
        loss_n = torch.mean(torch.sum((face_n - target_n) ** 2, dim=-1))
        gv = torch.autograd.grad(loss_t + normal_weight * loss_n, v)[0]
        with torch.no_grad():
            ms = 0.99 * ms + 0.01 * gv * gv               # RMSprop, alpha .99
            v = v.detach() - lr * gv / (torch.sqrt(ms) + 1e-8)
    return v.detach().cpu().numpy()


def _carve_chunk(pts, dil, proj):
    """Keep-mask of one point chunk: inside every view's dilated mask where
    the point projects into the image, and inside at least one image."""
    h, w = dil.shape[1:]
    keep = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    inside_any = torch.zeros_like(keep)
    for dv, pm in zip(dil, proj):
        p = pts @ pm[:3, :3].T + pm[:3, 3]
        xy = p[:, :2] / p[:, 2:3]                  # [-1, 1] screen convention
        inside = ((xy[:, 0] >= -1) & (xy[:, 0] <= 1)
                  & (xy[:, 1] >= -1) & (xy[:, 1] <= 1))
        # truncation toward zero, as the reference's int cast; outside the
        # image the clamped index is never used
        px = ((xy[:, 0] + 1) * (w - 1) * 0.5).to(torch.int64).clamp(0, w - 1)
        py = ((xy[:, 1] + 1) * (h - 1) * 0.5).to(torch.int64).clamp(0, h - 1)
        keep &= torch.where(inside, dv[py, px] >= 0.5, True)
        inside_any |= inside
    return inside_any & keep


def _grid_chunk_points(start: int, count: int, n: int, box_size: float,
                       device) -> torch.Tensor:
    """World coordinates of `count` linear ids of an n^3 ij-indexed grid
    from `start`, made on the device."""
    idx = start + torch.arange(count, dtype=torch.int32, device=device)
    k = idx % n
    j = (idx // n) % n
    i = idx // (n * n)
    ijk = torch.stack([i, j, k], -1).to(torch.float32)
    return box_size * (ijk / (n - 1) - 0.5)


_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


class MaskCarver:
    """carve(points [N, 3]) -> keep [N] bool: a point survives iff it
    projects inside every view's dilated mask and inside at least one
    image (extracting.py:326-377). Projection: K @ w2c @ p, normalised by
    row 2 to the reference's [-1, 1] screen convention.

    The projection and the mask gather run on the device over chunks of
    `chunk` points; carve_dense_grid(n, box_size) makes the grid's
    coordinates on the device and brings back only the keep-bits, 8 a
    byte, in one copy."""

    def __init__(self, dil: torch.Tensor, proj: torch.Tensor, chunk: int):
        self.dil, self.proj, self.chunk = dil, proj, chunk
        self.weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                                    device=dil.device)

    def __call__(self, points: np.ndarray) -> np.ndarray:
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.dil.device)
        keep = torch.cat([_carve_chunk(pts[s:s + self.chunk], self.dil,
                                       self.proj)
                          for s in range(0, pts.shape[0], self.chunk)])
        return keep.cpu().numpy()

    def carve_dense_grid(self, n: int, box_size: float) -> np.ndarray:
        """Keep-mask [n, n, n] of the ij-indexed linspace(-0.5, 0.5, n)
        grid scaled by box_size (build_value_grid's carve grid)."""
        total = n * n * n
        packed = []
        for s in range(0, total, self.chunk):
            # a multiple of 8 ids a chunk for the bit pack; the last
            # chunk's ids past the grid are sliced off below
            count = min(self.chunk, -(-(total - s) // 8) * 8)
            keep = _carve_chunk(
                _grid_chunk_points(s, count, n, float(box_size),
                                   self.dil.device), self.dil, self.proj)
            bits = keep.reshape(-1, 8).to(torch.uint8)
            packed.append(torch.sum(bits * self.weights, dim=1,
                                    dtype=torch.uint8))
        keep = np.unpackbits(torch.cat(packed).cpu().numpy(),
                             bitorder="little")[:total]
        return keep.astype(bool).reshape(n, n, n)


def make_mask_carver(
    masks: np.ndarray,          # [V, H, W] float 0/1
    camera_mats: np.ndarray,    # [V, 4, 4] intrinsics
    world_mats: np.ndarray,     # [V, 4, 4] world -> camera
    dilate_radius: int = 12,
    chunk: int = 1 << 23,
    device: str | torch.device = "cuda",
) -> MaskCarver:
    """The silhouette carver of these views: each mask dilated by a disk of
    dilate_radius, and K @ w2c once per view, on the device."""
    dev = resolve_device(device)
    struct = _disk(dilate_radius)
    dil = torch.as_tensor(np.stack([
        ndimage.binary_dilation(m > 0.5, structure=struct) for m in masks
    ]).astype(np.float32), device=dev)
    proj = torch.as_tensor(np.stack([
        (camera_mats[vi] @ world_mats[vi]).astype(np.float32)
        for vi in range(len(masks))]), device=dev)
    return MaskCarver(dil, proj, chunk)


def pixel_to_ndc_camera(K: np.ndarray, h: int, w: int) -> np.ndarray:
    """Fold the pixel -> [-1, 1] screen map into a pixel-space intrinsics
    matrix, for `camera_mats` of make_mask_carver (the carver projects in
    the reference's NDC convention, extracting.py:350-368; its inverse
    pixel map is px = (x + 1)(w - 1) / 2)."""
    ndc = np.eye(4, dtype=np.float32)
    ndc[0, 0], ndc[0, 2] = 2.0 / (w - 1), -1.0
    ndc[1, 1], ndc[1, 2] = 2.0 / (h - 1), -1.0
    k44 = np.eye(4, dtype=np.float32)
    k44[:3, :3] = np.asarray(K, np.float32)[:3, :3]
    return ndc @ k44


def _disk(r: int) -> np.ndarray:
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r)
