"""Stage-2 parameters and train config (counterpart of
psnerf_tpu/train/stage2.py). The train step comes with the training slice."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from psnerf_torch.fields.psnet import PSNet
from psnerf_torch.train.losses import Stage2LossWeights


@dataclasses.dataclass(frozen=True)
class Stage2TrainConfig:
    sg_learning_rate: float = 5e-4
    light_learning_rate: float = 5e-4
    light_inten_lr: float = 1e-3
    milestone_iters: Sequence[int] = ()
    gamma: float = 0.5
    light_train: bool = True
    light_inten_train: bool = True
    light_decay: bool = True
    train_order: bool = True
    warmup_iters: int = 5000
    warmup_vis_weight: float = 10.0
    ana_fixlight: bool = False
    weights: Stage2LossWeights = Stage2LossWeights()


def init_stage2_params(model: PSNet, light_dirs_init, light_ints_init,
                       device: str | torch.device = "cpu") -> dict:
    """{model, light_dirs [Ltot, 3], light_ints [Ltot, 1]}: the tree whose
    leaves are the checkpoint's `params/...` keys."""
    f32 = torch.float32
    return {
        "model": model,
        "light_dirs": torch.as_tensor(np.asarray(light_dirs_init), dtype=f32,
                                      device=device),
        "light_ints": torch.as_tensor(np.asarray(light_ints_init), dtype=f32,
                                      device=device).reshape(-1, 1),
    }
