"""Farthest-point sampling on the host (a copy of psnerf_tpu/ops/fps.py
`farthest_point_sampling_np`): picks well-spread extra light directions for
the visibility supervision of the shape export. 256 of 10,000 candidates is
a few MFLOP of sequential greedy work, a host-scale problem."""

from __future__ import annotations

import numpy as np


def farthest_point_sampling_np(points, n_samples: int,
                               start: int = 0) -> np.ndarray:
    """Greedy FPS: points [N, D] -> indices [n_samples], deterministic given
    `start` (the first selected index); each next index is the argmax of
    the squared distance to the selected set."""
    pts = np.asarray(points, np.float64)
    sel = np.empty((n_samples,), np.int64)
    sel[0] = start
    d2 = ((pts - pts[start]) ** 2).sum(-1)
    for i in range(1, n_samples):
        nxt = int(d2.argmax())
        sel[i] = nxt
        np.minimum(d2, ((pts - pts[nxt]) ** 2).sum(-1), out=d2)
    return sel
