"""Quality metrics (a copy of psnerf_tpu/eval/metrics.py): PSNR / SSIM /
normal-MAE. numpy host-side, matching the reference's exact settings
(stage2/utils/metrics.py:17-113, evaluation.py:15-26).

SSIM reimplements skimage.structural_similarity for the reference's
arguments (gaussian_weights=True, sigma=1.5, use_sample_covariance=False,
data_range=1, channel_axis=2) — skimage is not in this image; parity is
pinned by golden tests against the published formula.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.ndimage import gaussian_filter


def mae(vec1: np.ndarray, vec2: np.ndarray, mask=None, normalize=True):
    """Mean angular error in degrees. Returns (mean, per-element)."""
    vec1 = vec1.astype(np.float64).copy()
    vec2 = vec2.astype(np.float64).copy()
    if normalize:
        n1 = np.linalg.norm(vec1, axis=-1)
        n2 = np.linalg.norm(vec2, axis=-1)
        vec1 /= n1[..., None] + 1e-5
        vec2 /= n2[..., None] + 1e-5
        vec1[n1 == 0] = 0
        vec2[n2 == 0] = 0
    dot = (vec1 * vec2).sum(-1).clip(-1, 1)
    if mask is not None:
        dot = dot[mask.astype(bool)]
    ang = np.arccos(dot) * 180.0 / math.pi
    return ang.mean(), ang


def psnr(img1: np.ndarray, img2: np.ndarray, mask=None) -> float:
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    if mask is not None:
        img1, img2 = img1[mask.astype(bool)], img2[mask.astype(bool)]
    mse = np.mean((img1 - img2) ** 2)
    return 100.0 if mse == 0 else -10.0 * math.log10(mse)


def _ssim_single(x, y, data_range, sigma, use_sample_covariance):
    truncate = 3.5
    r = int(truncate * sigma + 0.5)
    win_size = 2 * r + 1
    f = lambda im: gaussian_filter(im, sigma, truncate=truncate, mode="reflect")
    ux, uy = f(x), f(y)
    uxx, uyy, uxy = f(x * x), f(y * y), f(x * y)
    np_pts = win_size ** x.ndim
    cov_norm = np_pts / (np_pts - 1) if use_sample_covariance else 1.0
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux**2 + uy**2 + c1) * (vx + vy + c2)
    )
    pad = (win_size - 1) // 2
    return s[pad:-pad, pad:-pad].mean()


def ssim(
    img1: np.ndarray, img2: np.ndarray, mask=None, data_range: float = 1.0,
    channel_axis: int = 2, gaussian_weights: bool = True, sigma: float = 1.5,
    use_sample_covariance: bool = False,
) -> float:
    assert gaussian_weights, "only the reference's gaussian-window variant"
    img1 = np.moveaxis(img1.astype(np.float64), channel_axis, 0)
    img2 = np.moveaxis(img2.astype(np.float64), channel_axis, 0)
    vals = [
        _ssim_single(c1, c2, data_range, sigma, use_sample_covariance)
        for c1, c2 in zip(img1, img2)
    ]
    return float(np.mean(vals))
