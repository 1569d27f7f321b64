"""Stage-2 run config (counterpart of psnerf_tpu/config.py:Stage2Config,
same field names). The HOCON/YAML parsers come with a later slice."""

from __future__ import annotations

import dataclasses

from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.train.stage2 import Stage2TrainConfig


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    net: PSNetConfig
    train: Stage2TrainConfig
    data_dir: str = ""
    obj_name: str = ""
    expname: str = "default"
    stage1_shape_path: str = ""
    inten_normalize: str | None = "sdps"
    train_view: int | None = None
    train_light: int | None = None
    all_view: bool = False
    multi_light: bool = True
    light_bs: int = 10
    light_init: str = "pred"
    light_inten_init: str = "same"
    num_pixels: int = 8192
    train_all_pixels: bool = True
    sample_in_mask: bool = True
    vis_loss: bool = True
    vis_plus: bool = True
    vis_train_num: int = 8
    image_store: str = "auto"
    normal_train: bool = True
    plot_freq: int = 1000
    ckpt_freq: int = 1000
    nepochs: int = 20000
    sched_milestones_epochs: tuple = ()
