"""Spherical coordinates and lat-long environment-map helpers (counterpart of
psnerf_tpu/core/spherical.py), in numpy: they build static light grids once
per run.

Conventions follow stage2/utils/eval_utils.py:
  lat-lng: z = r sin(lat); x = r cos(lat) cos(lng); y = r cos(lat) sin(lng)
  (eval_utils.py:283-291); gen_light_xyz builds an (h, w) lat-long grid of
  directional lights with per-texel solid angles (eval_utils.py:64-99).
"""

from __future__ import annotations

import numpy as np


def sph2cart(pts_sph: np.ndarray) -> np.ndarray:
    """(r, lat, lng) [..., 3] -> (x, y, z). eval_utils.py:255-296 (lat-lng)."""
    pts_sph = np.asarray(pts_sph)
    r, lat, lng = pts_sph[..., 0], pts_sph[..., 1], pts_sph[..., 2]
    z = r * np.sin(lat)
    x = r * np.cos(lat) * np.cos(lng)
    y = r * np.cos(lat) * np.sin(lng)
    return np.stack([x, y, z], axis=-1)


def cart2sph(pts_cart: np.ndarray) -> np.ndarray:
    """(x, y, z) [..., 3] -> (r, lat, lng). eval_utils.py:180-252 (lat-lng)."""
    pts_cart = np.asarray(pts_cart)
    r = np.sqrt(np.sum(np.square(pts_cart), axis=-1))
    lat = np.arcsin(pts_cart[..., 2] / r)
    lng = np.arctan2(pts_cart[..., 1], pts_cart[..., 0])
    return np.stack([r, lat, lng], axis=-1)


def gen_light_xyz(envmap_h: int, envmap_w: int, envmap_radius: float = 1e2):
    """Lat-long grid of light positions + solid angles.

    Returns (xyz [h, w, 3], areas [h, w]). Reference: eval_utils.py:64-99.
    """
    lat_step = np.pi / (envmap_h + 2)
    lng_step = 2 * np.pi / (envmap_w + 2)
    lats = np.linspace(np.pi / 2 - lat_step, -np.pi / 2 + lat_step, envmap_h)
    lngs = np.linspace(np.pi - lng_step, -np.pi + lng_step, envmap_w)
    lngs, lats = np.meshgrid(lngs, lats)

    rlatlngs = np.stack(
        [envmap_radius * np.ones_like(lats), lats, lngs], axis=-1
    ).reshape(-1, 3)
    xyz = sph2cart(rlatlngs).reshape(envmap_h, envmap_w, 3)

    sin_colat = np.sin(np.pi / 2 - lats)
    areas = 4 * np.pi * sin_colat / np.sum(sin_colat)
    if 0 in areas:
        raise ValueError("every envmap texel must contribute")
    return xyz, areas


def uniform_sample_sph(n: int, r: float = 1.0, seed: int | None = None):
    """Area-uniform grid sample of the sphere (n must be a perfect square).

    Returns cartesian points [n, 3]. Reference: eval_utils.py:140-177 (there
    returned in spherical convention; we return cartesian directly).
    """
    n_ = int(np.sqrt(n))
    if n_ * n_ != n:
        raise ValueError(f"{n} is not a perfect square")
    u, v = np.meshgrid(np.linspace(0, 1, n_), np.linspace(0, 1, n_), indexing="ij")
    theta = np.arccos(2 * u - 1)  # colatitude in [0, pi]
    phi = 2 * np.pi * v
    z = r * np.cos(theta)
    x = r * np.sin(theta) * np.cos(phi)
    y = r * np.sin(theta) * np.sin(phi)
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)


def random_sphere_dirs(n: int, rng: np.random.Generator) -> np.ndarray:
    """n random unit directions (for vis_plus FPS candidate pool,
    stage1/shape_extract.py:117-123)."""
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def vis_light_probe(env_light: np.ndarray, h: int = 128) -> np.ndarray:
    """Tonemapped light-probe preview image (stage2/utils/eval_utils.py:43-61):
    nearest-upsampled envmap, hdr/max then gamma 4."""
    eh, ew = env_light.shape[:2]
    scale = max(1, h // eh)
    probe = np.repeat(np.repeat(env_light, scale, axis=0), scale, axis=1)
    tone = (probe / max(probe.max(), 1e-8)) ** (1.0 / 4.0)
    return (np.clip(tone, 0, 1) * 255).astype(np.uint8)
