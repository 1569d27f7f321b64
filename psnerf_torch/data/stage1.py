"""Stage-1 data (counterpart of psnerf_tpu/data/stage1.py): light-averaged
images and SDPS normals as tensors on one device, and a per-step ray-batch
sampler that gathers on that device from a torch.Generator."""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from scipy import ndimage

from psnerf_torch.data.scene import SceneParams, load_image, load_mask
from psnerf_torch.device import resolve_device


def load_stage1_data(scene: SceneParams, split: str = "train",
                     inten_normalize: str | None = "sdps",
                     train_view: int | None = None,
                     train_light: int | None = None, all_view: bool = False,
                     white_background: bool = True, normal_loss: bool = True,
                     mask_valid: bool = True, mask_black: bool = False,
                     device: str | torch.device = "cuda") -> dict:
    """Returns tensors on `device`: imgs [V, H, W, 3], masks [V, H, W],
    norm_mask [V, H, W] bool, normals [V, H, W, 3] (SDPS camera frame),
    mask_valid [V, H, W] bool, poses [V, 4, 4] (OpenCV c2w), K [4, 4]; and
    views (original indices, numpy)."""
    dev = resolve_device(device)
    views = scene.view_split(split, train_view, all_view)
    im_sub, im_type = scene.img_subdir(inten_normalize, train_light)
    sdps_dir = scene.sdps_dir(inten_normalize, train_light)

    imgs, masks, norm_masks, normals, valids = [], [], [], [], []
    for vi in views:
        name = f"view_{vi + 1:02d}"
        imgs.append(load_image(os.path.join(scene.basedir, im_sub, im_type,
                                            name + ".png")))
        mask = load_mask(os.path.join(scene.basedir, "mask", name + ".png"))
        masks.append(mask)
        nm_path = os.path.join(scene.basedir, "norm_mask", name + ".png")
        norm_masks.append(load_mask(nm_path) if os.path.exists(nm_path)
                          else mask.copy())
        if normal_loss:
            normals.append(np.load(os.path.join(sdps_dir, "outnpy",
                                                name + ".npy")))
        if mask_valid:
            d = ndimage.binary_dilation(mask, iterations=2)
            e = ndimage.binary_erosion(mask, iterations=2)
            valids.append(~np.logical_xor(d, e))

    imgs = np.asarray(imgs, np.float32)
    masks = np.asarray(masks, np.float32)
    norm_mask = np.asarray(norm_masks, np.float32) > 0
    if mask_black and normal_loss:
        norm_mask &= ~(imgs < 0.1).all(-1)
    if white_background:
        imgs = imgs * masks[..., None] + (1.0 - masks[..., None])

    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    out = {"imgs": t(imgs), "masks": t(masks), "norm_mask": t(norm_mask),
           "poses": t(scene.pose_cv[views].astype(np.float32)),
           "K": t(np.asarray(scene.K, np.float32)),
           "views": np.asarray(views)}
    if normal_loss:
        out["normals"] = t(np.asarray(normals, np.float32))
    if mask_valid:
        out["mask_valid"] = t(np.asarray(valids))
    return out


def sample_stage1_batch(data: dict, view: torch.Tensor, n_points: int,
                        generator: torch.Generator,
                        normal_angle: float | None = 65.0) -> dict:
    """A ray batch of one view (view: a one-element index tensor on the
    data's device): random integer pixels with rgb / mask / normal gathers,
    the normal-angle cone gate, and the SDPS camera -> world normal
    rotation. Everything stays on the device."""
    dev = data["imgs"].device
    h, w = data["imgs"].shape[1:3]
    px = torch.randint(0, w, (n_points,), generator=generator, device=dev)
    py = torch.randint(0, h, (n_points,), generator=generator, device=dev)
    pick = lambda name: torch.index_select(data[name], 0, view)[0]
    pose = pick("poses")
    batch = {
        "pixels": torch.stack([px, py], dim=-1).float(),
        "rgb_gt": pick("imgs")[py, px],
        "camera_mat": data["K"],
        "world_mat": pose,
        "mask_gt": pick("masks")[py, px],
    }
    batch["mask_valid"] = (pick("mask_valid")[py, px] if "mask_valid" in data
                           else torch.ones((n_points,), dtype=torch.bool,
                                           device=dev))
    if "normals" in data:
        n_cam = pick("normals")[py, px]                  # SDPS camera frame
        nm = pick("norm_mask")[py, px]
        if normal_angle is not None:
            nm = nm & (n_cam[..., -1] >= math.cos(math.radians(normal_angle)))
        flip = torch.tensor([1.0, -1.0, -1.0], device=dev)
        batch["normal_gt"] = torch.einsum("ij,nj->ni", pose[:3, :3] * flip,
                                          n_cam)
        batch["norm_mask"] = nm
    else:
        batch["norm_mask"] = torch.zeros((n_points,), dtype=torch.bool,
                                         device=dev)
        batch["normal_gt"] = torch.zeros((n_points, 3), device=dev)
    return batch
