"""Quality evaluation of a stage-2 eval output directory against the
dataset's ground truth (counterpart of psnerf_tpu/eval/evaluation.py):
PSNR, SSIM and normal MAE, with white-background compositing under
mask_pred & norm_mask and, for SDPS-normalized runs, a per-channel
least-squares rescale. Images are read with Pillow. LPIPS
(eval/lpips_torch.py) runs on `device` when weights are given (the
argument or LPIPS_WEIGHTS); without them the result carries `lpips: null`
and the JAX package's status string, and no device is touched.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

import torch

from psnerf_torch.data.scene import imread
from psnerf_torch.eval.lpips_torch import LPIPS
from psnerf_torch.eval.metrics import mae, psnr, scale_img, ssim, white_bg

LPIPS_UNAVAILABLE = ("unavailable: set LPIPS_WEIGHTS "
                     "(see tools/export_lpips_npz.py)")


def evaluate_outputs(data_path: str, test_out_path: str,
                     inten_normalize: str | None = None,
                     train_all_view: bool = False,
                     train_light: int | None = None,
                     lpips_weights: str | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """{psnr, ssim (means over every test view and light), lpips (the mean
    x 100, or None without weights), lpips_status, normal_mae (mean over
    views, when the dataset has ground-truth normals)} of the eval tree
    under test_out_path (rgb/img, mask/img, normal/npy as
    Stage2Runner.evaluate writes them)."""
    with open(os.path.join(data_path, "params.json")) as f:
        para = json.load(f)
    test_slt = (np.arange(para["n_view"]) if train_all_view
                else np.asarray(para["view_test"]))
    poses = np.asarray(para["pose_c2w"], np.float32)
    im_sub = "img_intnorm_gt" if inten_normalize is not None else "img"

    if para["light_is_same"]:
        n_light = len(para["light_direction"])
        if train_all_view and train_light is not None:
            n_light = train_light
        light_slt = [np.arange(n_light)] * len(test_slt)
    else:
        light_slt = [np.arange(len(para["light_direction"][vi]))
                     for vi in test_slt]

    lpips_fn = LPIPS(lpips_weights, device=device)
    img_data = defaultdict(list)
    normal_data = []
    for vidx, vi in enumerate(test_slt):
        name = f"view_{vi + 1:02d}"
        mask_gt = imread(os.path.join(data_path, "norm_mask", name + ".png"))
        mask_gt = (mask_gt[..., 0] if mask_gt.ndim == 3 else mask_gt) \
            .astype(bool)
        mask_pred = imread(os.path.join(test_out_path, "mask", "img",
                                        name + ".png")).astype(bool)
        mask = mask_pred & mask_gt

        gt_normal_dir = os.path.join(data_path, "normal")
        if os.path.exists(gt_normal_dir):
            normal_gt = np.load(os.path.join(gt_normal_dir, "npy",
                                             name + ".npy"))
            if not para["gt_normal_world"]:
                normal_gt = np.einsum("ij,hwj->hwi", poses[vi, :3, :3],
                                      normal_gt)
            normal_pred = np.load(os.path.join(test_out_path, "normal", "npy",
                                               name + ".npy"))
            normal_data.append(mae(normal_pred, normal_gt, mask)[0])

        for li in light_slt[vidx]:
            img_gt = np.asarray(imread(os.path.join(
                data_path, im_sub, name, f"{li + 1:03d}.png")),
                np.float32)[..., :3] / 255.0
            img_gt = white_bg(img_gt, mask_gt)
            img_pred = np.asarray(imread(os.path.join(
                test_out_path, "rgb", "img", name, f"{li + 1:03d}.png")),
                np.float32)[..., :3] / 255.0
            if inten_normalize == "sdps":
                img_pred = scale_img(img_pred, img_gt, mask)
            a, b = white_bg(img_pred, mask), white_bg(img_gt, mask)
            img_data["psnr"].append(psnr(a, b, mask))
            img_data["ssim"].append(ssim(a, b))
            if lpips_fn.available:
                img_data["lpips"].append(lpips_fn(a, b))

    out = {k: float(np.mean(v)) for k, v in img_data.items()}
    if "lpips" in out:
        out["lpips"] *= 100
        out["lpips_status"] = "computed"
    else:
        out["lpips"] = None
        out["lpips_status"] = LPIPS_UNAVAILABLE
    if normal_data:
        out["normal_mae"] = float(np.mean(normal_data))
    return out
