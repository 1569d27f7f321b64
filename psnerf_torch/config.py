"""Run configs (counterpart of psnerf_tpu/config.py: Stage1Config,
Stage2Config and milestones_epochs_to_iters, same field names). The
HOCON/YAML parsers come with a later slice."""

from __future__ import annotations

import dataclasses

from psnerf_torch.fields.occupancy import OccFieldConfig
from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.render.unisurf import UnisurfConfig
from psnerf_torch.train.stage1 import Stage1TrainConfig
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


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    field: OccFieldConfig
    render: UnisurfConfig
    train: Stage1TrainConfig
    data_dir: str = ""
    obj_name: str = ""
    out_dir: str = "out"
    inten_normalize: str | None = "sdps"
    train_view: int | None = None
    train_light: int | None = None
    all_view: bool = False
    mask_black: bool = False
    est_norm: bool = True
    visualize_every: int = 10000
    print_every: int = 200
    backup_every: int = 10000
    checkpoint_every: int = 5000
    max_iters: int = 100000
    extraction_resolution: int = 64
    extraction_upsampling: int = 3
    extraction_refinement: int = 0


def milestones_epochs_to_iters(milestones, views_per_epoch: int):
    return tuple(int(m) * int(views_per_epoch) for m in milestones)
