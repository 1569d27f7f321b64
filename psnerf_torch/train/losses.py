"""Stage-2 loss weights (counterpart of psnerf_tpu/train/losses.py). The
losses themselves come with the training slice."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Stage2LossWeights:
    sg_rgb_weight: float = 1.0
    loss_type: str = "L1"          # 'L1' | 'L2'
    albedo_smooth_weight: float = 0.05
    rough_smooth_weight: float = 0.01
    vis_weight: float = 1.0
    normal_weight: float = 1.0
    normal_smooth_weight: float = 0.05
