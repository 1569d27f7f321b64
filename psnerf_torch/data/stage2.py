"""Stage-2 data (counterpart of psnerf_tpu/data/stage2.py): multi-light
images plus the stage-1 shape export, as tensors on one device.

Images stay as their 8-bit bytes on the device when every source is 8-bit
("auto"/"u8"); decode_imgs divides by 255 on use, which is bit-exact with
loading them as float. Ragged per-view light counts are padded to the
largest count; light_count / light_mask mark the real lights.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from psnerf_torch.data.scene import (SceneParams, load_image, load_image_u8,
                                     load_mask)
from psnerf_torch.device import resolve_device


def decode_imgs(x: torch.Tensor) -> torch.Tensor:
    """uint8-stored images -> float32 in [0, 1]; float images pass through."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def load_stage2_data(
    scene: SceneParams,
    stage1_shape_path: str,
    split: str = "train",
    inten_normalize: str | None = "sdps",
    train_view: int | None = None,
    train_light: int | None = None,
    all_view: bool = False,
    vis_loss: bool = True,
    vis_plus: bool = True,
    image_store: str = "auto",
    device: str | torch.device = "cuda",
) -> dict:
    """Returns a dict of tensors on `device`:
      imgs [V, L, H*W, 3] (masked; uint8 when image_store resolves to "u8"),
      object_masks [V, H*W] bool, points/normals [V, H*W, 3],
      surface_mask [V, H*W] bool, visibility [V, L, H*W], gt_normal
      [V, H*W, 3], light_dirs [V, L, 3] world, light_mask [V, L], poses
      [V, 4, 4] OpenCV, K, vis_plus_dirs/vis_plus (when vis_plus);
    and host values: light_slt [V, L], light_count [V], pose_gl, views,
    img_res, light_row_offset, n_light_rows."""
    dev = resolve_device(device)
    views = scene.view_split(split, train_view, all_view)
    im_sub, _ = scene.img_subdir(inten_normalize, train_light)
    light_dirs, light_slt = scene.lights_world(views, train_light)
    if image_store not in ("auto", "u8", "f32"):
        raise ValueError(f"image_store must be auto|u8|f32, got {image_store!r}")
    use_u8 = image_store != "f32"

    masks, points, normals, smasks, gt_normals = [], [], [], [], []
    imgs, vis = [], []
    for v0, vi in enumerate(views):
        mask = load_mask(os.path.join(scene.basedir, "mask",
                                      f"view_{vi + 1:02d}.png"))
        masks.append(mask)
        h, w = mask.shape
        gt_path = os.path.join(scene.basedir, "normal", "npy",
                               f"view_{vi + 1:02d}.npy")
        if os.path.exists(gt_path):
            g = np.load(gt_path)
            if not scene.gt_normal_world:
                g = np.einsum("ij,hwj->hwi", scene.pose_gl[vi, :3, :3], g)
            gt_normals.append(g * (mask[..., None] > 0))
        else:
            gt_normals.append(np.zeros((h, w, 3), np.float32))
        for lst, sub in ((points, "points"), (smasks, "mask"),
                         (normals, "normal")):
            lst.append(np.load(os.path.join(stage1_shape_path, sub,
                                            f"view_{vi + 1:02d}.npy")))

        img_v = []
        for li in light_slt[v0]:
            p = os.path.join(scene.basedir, im_sub, f"view_{vi + 1:02d}",
                             f"{li + 1:03d}.png")
            img = load_image_u8(p) if use_u8 else None
            if img is None:
                if use_u8:  # non-8-bit source: demote everything to f32
                    if image_store == "u8":
                        raise ValueError(
                            f"image_store='u8' but {p!r} is not an 8-bit "
                            "image; use image_store='auto' to allow the "
                            "f32 fallback")
                    use_u8 = False
                    imgs = [a.astype(np.float32) / 255.0 for a in imgs]
                    img_v = [a.astype(np.float32) / 255.0 for a in img_v]
                img = load_image(p)
            img_v.append(img.reshape(-1, 3) * (mask.reshape(-1, 1) > 0))
        imgs.append(np.asarray(img_v, np.uint8 if use_u8 else np.float32))
        if vis_loss:
            vv = np.load(os.path.join(stage1_shape_path, "visibility",
                                      f"view_{vi + 1:02d}.npy"))
            vis.append(vv.reshape(vv.shape[0], -1).astype(np.float32))

    masks = np.asarray(masks, np.float32)
    v = len(views)
    llen = [len(s) for s in light_slt]
    l_max = max(llen)

    def pad_lights(arrs, fill=0.0, dtype=np.float32):
        """list of [L_v, ...] -> [V, l_max, ...] (padded with `fill`)."""
        out_arr = np.full((v, l_max) + tuple(np.shape(arrs[0])[1:]), fill,
                          dtype)
        for i, a in enumerate(arrs):
            out_arr[i, : len(a)] = a
        return out_arr

    light_mask = np.zeros((v, l_max), bool)
    for i, n_l in enumerate(llen):
        light_mask[i, :n_l] = True
    ld_pad = pad_lights(light_dirs)
    ld_pad[~light_mask] = (0.0, 0.0, 1.0)   # +z keeps normalization finite
    slt_pad = np.full((v, l_max), -1, np.int64)
    for i, s in enumerate(light_slt):
        slt_pad[i, : len(s)] = s

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    out = {
        "imgs": t(pad_lights(imgs, dtype=np.uint8 if use_u8 else np.float32)),
        "object_masks": t(masks.reshape(v, -1) > 0),
        "gt_normal": t(np.asarray(gt_normals, np.float32).reshape(v, -1, 3)),
        "points": t(np.asarray(points, np.float32).reshape(v, -1, 3)),
        "normals": t(np.asarray(normals, np.float32).reshape(v, -1, 3)),
        "surface_mask": t(np.asarray(smasks).reshape(v, -1).astype(bool)),
        "light_dirs": t(ld_pad),
        "light_slt": slt_pad,
        "light_count": np.asarray(llen),
        "light_mask": t(light_mask),
        "poses": t(scene.pose_cv[views]),
        "pose_gl": scene.pose_gl[views],
        "K": t(scene.K),
        "views": np.asarray(views),
        "img_res": masks.shape[-2:],
    }
    if vis_loss:
        out["visibility"] = t(pad_lights(vis))
    if vis_loss and vis_plus:
        vp_dir = os.path.join(stage1_shape_path, "vis_plus")
        with open(os.path.join(vp_dir, "light_dir.json")) as f:
            vp_lights = json.load(f)
        vpd, vpv = [], []
        for vi in views:
            vpd.append(np.asarray(vp_lights[f"view_{vi + 1:02d}"], np.float32))
            arr = np.load(os.path.join(vp_dir, f"view_{vi + 1:02d}.npy"))
            vpv.append(arr.reshape(len(vpd[-1]), -1).astype(np.float32))
        out["vis_plus_dirs"] = t(np.asarray(vpd))
        out["vis_plus"] = t(np.asarray(vpv))
    out["light_row_offset"] = np.concatenate([[0], np.cumsum(llen)[:-1]])
    out["n_light_rows"] = int(np.sum(llen))
    return out
