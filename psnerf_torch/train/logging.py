"""Training observability (counterpart of psnerf_tpu/train/logging.py):
metrics as a JSONL stream (`MetricLogger`, one {"it", "wall", **scalars}
object per line) and the stage-1 visualisation strip. The TensorBoard
mirror comes with a later slice."""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, it: int, scalars: dict) -> None:
        rec = {"it": int(it), "wall": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            if v is None:
                continue
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def _to8(x):
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def _jet(x):
    """Minimal jet colormap for error heatmaps (x in [0, 1]) -> [..., 3]."""
    x = np.clip(x, 0, 1)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def _safe_norm(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)


def stage1_vis_strip(render: dict, gt_img: np.ndarray,
                     gt_normal: np.ndarray | None = None,
                     mask_gt: np.ndarray | None = None) -> np.ndarray:
    """The stage-1 visualisation strip of a Stage1Runner.render_view result
    (numpy arrays): gt | render | normal [| SDPS normal | angular error
    heatmap] | mask | acc [| phong]. Returns uint8 [H, W * k, 3]."""
    cols = [_to8(gt_img), _to8(render["rgb"]),
            _to8(render["normal"] / 2 + 0.5)]
    if gt_normal is not None:
        cols.append(_to8(gt_normal / 2 + 0.5))
        dot = np.clip(np.sum(
            _safe_norm(render["normal"]) * _safe_norm(gt_normal), -1), -1, 1)
        err = np.degrees(np.arccos(dot)) / 45.0
        m = render["mask"]
        if mask_gt is not None:
            m = m | (mask_gt > 0.5)
        cols.append(_to8(_jet(np.clip(err, 0, 1)) * m[..., None]))
    cols.append(_to8(np.repeat(render["mask"][..., None], 3, -1).astype(float)))
    cols.append(_to8(np.repeat(render["acc"][..., None], 3, -1)))
    if "phong" in render:
        cols.append(_to8(render["phong"]))
    return np.concatenate(cols, axis=1)
