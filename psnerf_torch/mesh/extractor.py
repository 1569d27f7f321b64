"""Octree-refined mesh extraction (counterpart of
psnerf_tpu/mesh/extractor.py).

The MISE octree runs on the host (native library, one `update` per round);
each round's query points go to the value function's device in one copy,
every fixed-size batch is queued there, and the values come back in one
copy: one device round trip per round, none per batch.

Values are INSIDE-POSITIVE logits (the reference evaluates
`model(p, return_logits=True)` = -geometry logit, extracting.py:149 and
network.py:138); the iso level of occupancy tau is log(tau) - log(1 - tau)
(extracting.py:83).
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from psnerf_torch.mesh.native import MISE, marching_cubes
from psnerf_torch.mesh.refine import MaskCarver


def extract_mesh(
    value_fn: Callable,            # [N, 3] -> [N] inside-positive
    threshold: float = 0.5,
    resolution0: int = 64,
    upsampling_steps: int = 3,
    padding: float = 0.4,
    points_batch: int = 100_000,
    mask_carve: Optional[MaskCarver] = None,
    clip_bottom: Optional[float] = None,
    exterior_only: bool = False,
):
    """Returns (vertices [V, 3] float32 world coordinates, triangles [T, 3]
    int64).

    mask_carve: optional silhouette carver from make_mask_carver
    (multi-view carving, extracting.py:120-126). clip_bottom:
    clip z below this world coordinate (extracting.py:130-132).
    exterior_only: fill every enclosed empty pocket of the value grid to
    "inside" before marching, so only the exterior surface is extracted
    (UNISURF's interior is unsupervised and can hollow out; the raw
    protocol, the reference's, then samples cavity walls in a Chamfer
    comparison). The reference has no counterpart; publish both."""
    value_grid, iso, box_size = build_value_grid(
        value_fn, threshold=threshold, resolution0=resolution0,
        upsampling_steps=upsampling_steps, padding=padding,
        points_batch=points_batch, mask_carve=mask_carve,
        clip_bottom=clip_bottom)
    return march_value_grid(value_grid, iso, box_size,
                            exterior_only=exterior_only)


def _values_to_host(parts) -> np.ndarray:
    """The values of every queued batch as one float64 host array: one copy
    for device tensors."""
    if torch.is_tensor(parts[0]):
        return torch.cat(parts).cpu().numpy().astype(np.float64)
    return np.concatenate([np.asarray(v, np.float64) for v in parts])


def build_value_grid(
    value_fn: Callable,
    threshold: float = 0.5,
    resolution0: int = 64,
    upsampling_steps: int = 3,
    padding: float = 0.4,
    points_batch: int = 100_000,
    mask_carve: Optional[MaskCarver] = None,
    clip_bottom: Optional[float] = None,
    timings: Optional[dict] = None,
):
    """Evaluate, carve and clip the dense value grid (the costly phase that
    several protocols share); returns (value_grid float32 [n, n, n], iso,
    box_size). Pair with march_value_grid.

    value_fn takes float32 points [B, 3] (B = points_batch; the tail is
    padded with zeros) and returns [B] values: a numpy function gets numpy
    batches; one with a `device` attribute (make_field_value_fn) gets
    slices of a tensor copied to that device once per MISE round.
    timings: a dict that gets the seconds of each leg (eval_s: the value
    function's batches and the copies, mise_s: the octree's queries and
    updates, carve_s, clip_s) and the points evaluated (points)."""
    iso = math.log(threshold) - math.log(1.0 - threshold)
    box_size = 2.0 + padding
    legs = dict.fromkeys(("eval_s", "mise_s", "carve_s", "clip_s"), 0.0)
    legs["points"] = 0
    device = getattr(value_fn, "device", None)

    def eval_padded(pts: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        n = pts.shape[0]
        pad = (-n) % points_batch
        if pad:
            pts = np.concatenate([pts, np.zeros((pad, 3), pts.dtype)], 0)
        src = pts if device is None else torch.from_numpy(pts).to(device)
        pending = [value_fn(src[s:s + points_batch])
                   for s in range(0, n + pad, points_batch)]
        out = _values_to_host(pending)[:n]
        legs["eval_s"] += time.perf_counter() - t0
        legs["points"] += n
        return out

    if upsampling_steps == 0:
        nx = resolution0
        lin = np.linspace(-0.5, 0.5, nx)
        grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
        pts = (box_size * grid).reshape(-1, 3).astype(np.float32)
        value_grid = eval_padded(pts).reshape(nx, nx, nx).astype(np.float32)
    else:
        t0 = time.perf_counter()
        mise = MISE(resolution0, upsampling_steps, iso)
        res = mise.resolution
        points = mise.query()
        while points.shape[0] != 0:
            pts = points.astype(np.float32) / res
            pts = box_size * (pts - 0.5)
            values = eval_padded(pts)
            mise.update(points, values)
            points = mise.query()
        # float32 end to end: 0.54 GB at 513^3 (1.08 GB in float64), and
        # every later host pass over the grid is memory-bound
        value_grid = mise.to_dense(np.float32)
        legs["mise_s"] = time.perf_counter() - t0 - legs["eval_s"]

    n = value_grid.shape[0]
    if mask_carve is not None:
        t0 = time.perf_counter()
        # grid coordinates made on the device: no [n^3, 3] host array
        keep = mask_carve.carve_dense_grid(n, box_size)
        np.logical_not(keep, out=keep)
        value_grid[keep] = -30.0            # in place: no second grid
        legs["carve_s"] = time.perf_counter() - t0
    if clip_bottom is not None:
        t0 = time.perf_counter()
        lin = box_size * np.linspace(-0.5, 0.5, n)
        value_grid[:, :, lin < clip_bottom] = -30.0
        legs["clip_s"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(legs)
    return value_grid, iso, box_size


# warn when the enclosed (interior-cavity) volume exceeds this share of the
# inside volume under the raw protocol: a sampled Chamfer on such a mesh
# samples cavity walls (the snowman: 27.97 mm raw, 4.21 mm exterior-only)
POCKET_WARN_FRACTION = 0.005


def march_value_grid(value_grid: np.ndarray, iso: float, box_size: float,
                     exterior_only: bool = False,
                     timings: Optional[dict] = None):
    """Surface a dense value grid -> (verts [V, 3] float32 world, tris
    [T, 3]).

    Under the raw protocol (the reference's) it warns when enclosed
    interior pockets large enough to corrupt a sampled Chamfer are present;
    exterior_only=True fills them. timings: a dict that gets pocket_s (finding or filling the
    pockets) and march_s."""
    n = value_grid.shape[0]
    t0 = time.perf_counter()
    if exterior_only:
        value_grid = fill_enclosed_pockets(value_grid, iso)
    else:
        enclosed = find_enclosed_pockets(value_grid, iso)
        n_enc = int(enclosed.sum())
        n_inside = int((value_grid >= iso).sum())
        if n_enc > POCKET_WARN_FRACTION * max(n_inside, 1):
            warnings.warn(
                f"raw mesh extraction found enclosed interior pockets "
                f"({n_enc} voxels, {n_enc / max(n_inside, 1):.1%} of the "
                "inside volume): the unsupervised UNISURF interior has "
                "hollowed out, and a sampled Chamfer on this mesh will "
                "include cavity walls (snowman: 27.97 mm raw vs 4.21 mm "
                "exterior). Extract with exterior_only=True for the "
                "exterior-surface protocol.", stacklevel=2)
    t1 = time.perf_counter()
    padded = np.pad(value_grid, 1, "constant", constant_values=-1e6)
    verts, tris = marching_cubes(padded, iso)
    # undo the padding; grid coordinates to the world box
    # (extracting.py:176-181)
    verts = verts - 1.0
    verts = verts / (n - 1)
    verts = box_size * (verts - 0.5)
    if timings is not None:
        timings["pocket_s"] = t1 - t0
        timings["march_s"] = time.perf_counter() - t1
    return verts.astype(np.float32), tris


def find_enclosed_pockets(value_grid: np.ndarray, iso: float) -> np.ndarray:
    """Bool mask of below-iso voxels NOT face-connected to the box boundary
    (interior cavities), by connected-component labelling on the host."""
    from scipy import ndimage

    outside = value_grid < iso
    lbl, n_lbl = ndimage.label(outside)        # 6-connectivity (faces)
    if n_lbl == 0:
        return np.zeros(value_grid.shape, bool)
    boundary = np.unique(np.concatenate([
        lbl[0].ravel(), lbl[-1].ravel(),
        lbl[:, 0].ravel(), lbl[:, -1].ravel(),
        lbl[:, :, 0].ravel(), lbl[:, :, -1].ravel()]))
    reach = np.zeros(n_lbl + 1, bool)
    reach[boundary] = True
    reach[0] = False
    return outside & ~reach[lbl]


def fill_enclosed_pockets(value_grid: np.ndarray, iso: float) -> np.ndarray:
    """Fill every below-iso region NOT face-connected to the box boundary
    to 'inside' (+30), leaving only the exterior surface for marching."""
    enclosed = find_enclosed_pockets(value_grid, iso)
    if enclosed.any():
        value_grid = value_grid.copy()
        value_grid[enclosed] = 30.0            # copy, then fill; dtype kept
    return value_grid


def make_field_value_fn(field, field_cfg, fused: bool = False):
    """Inside-positive logit evaluator of the stage-1 field for
    build_value_grid: points [B, 3] on the field's device -> [B] there.

    fused: through the fused_occ kernel (one packing of the field's current
    weights; pair it with a 1M-point batch), else -occ_logit in plain
    PyTorch. The returned function carries the field's `device`."""
    from psnerf_torch.fields.occupancy import occ_logit
    from psnerf_torch.ops.fused_occ import make_fused_occ_fn

    device = next(field.parameters()).device
    if fused:
        occ_fn = make_fused_occ_fn(field, field_cfg, output="inside_logit")
    else:
        @torch.no_grad()
        def occ_fn(p):
            return -occ_logit(field, p, field_cfg)

    def value_fn(pts):
        return occ_fn(torch.as_tensor(pts, dtype=torch.float32,
                                      device=device))

    value_fn.device = device
    return value_fn
