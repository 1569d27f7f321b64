"""SDPS-Net inference over a dataset -> sdps_out* directory (counterpart
of psnerf_tpu/preprocess/runner.py; PNGs through Pillow).

Reference: preprocessing/test.py + test_utils.py:18-92 +
datasets/UPS_Custom_Dataset.py:26-107. Per view: mask-crop (15 px pad,
then pad to a multiple of 4), LCNet at the 128x128 canonical resolution
for light estimation, NENet at the cropped resolution for normals,
re-embed the outputs into the full frame (sdps_view, on images a caller
holds), save outnpy/view_XX.npy + outimg/view_XX.png, and per dataset
light_direction_pred.npy + light_intensity_pred.npy (run_sdps).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from psnerf_torch.data.scene import imread, imwrite
from psnerf_torch.utils import profiling


def resize_bilinear_align(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Bilinear resize with align_corners=True (torch interpolate semantics
    used by LCNet.prepareInputs, LCNet.py:88). img: [H, W, C]."""
    h, w = img.shape[:2]
    ys = np.linspace(0, h - 1, th)
    xs = np.linspace(0, w - 1, tw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def _crop_and_pad(img, mask, pad=15, k=4):
    h, w = mask.shape
    mi, mj = np.where(mask > 0.5)
    crop = (max(0, mi.min() - pad), max(0, mj.min() - pad),
            min(h, mi.max() + pad), min(w, mj.max() + pad))
    img = img[crop[0]:crop[2], crop[1]:crop[3]]
    mask = mask[crop[0]:crop[2], crop[1]:crop[3]]
    # pms_transforms.imgSizeToFactorOfK (pms_transforms.py:24-30), quirk
    # included: when EITHER dim is unaligned, BOTH are padded by
    # k - dim % k, so an aligned dim gains k rows or columns. The padding
    # feeds LCNet's 128x128 rescale, so the light estimates depend on it.
    if img.shape[0] % k or img.shape[1] % k:
        ph = k - img.shape[0] % k
        pw = k - img.shape[1] % k
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        mask = np.pad(mask, ((0, ph), (0, pw)))
    return img, mask, crop


def read_view(data_dir: str, view: str, img_root: str = "img",
              light_slt=None):
    """The light images of one view as float32 [L, H, W, 3] in [0, 1],
    zero outside the norm_mask, and that mask [H, W] in [0, 1]; files in
    sorted order, the `light_slt` indices of them if given."""
    img_files = sorted(os.listdir(os.path.join(data_dir, img_root, view)))
    if light_slt is not None:
        img_files = [img_files[li] for li in light_slt]
    imgs = np.stack([
        np.asarray(imread(os.path.join(data_dir, img_root, view, f)),
                   np.float32)[..., :3] / 255.0
        for f in img_files])
    mask = np.asarray(imread(os.path.join(data_dir, "norm_mask",
                                          f"{view}.png")), np.float32)
    if mask.ndim == 3:
        mask = mask[..., 0]
    mask = mask / 255.0
    return imgs * (mask[None, ..., None] > 0.5), mask


def sdps_inputs(imgs: np.ndarray, mask: np.ndarray, test_hw=(128, 128)):
    """One view's network inputs: (cropped [L, h, w, 3] and its mask [h,
    w] for NENet, the crop box, LCNet's images [L, th, tw, 3] and mask
    [th, tw] at the canonical size, float32)."""
    per_light = []
    for li in range(imgs.shape[0]):
        ci, cmask, crop = _crop_and_pad(imgs[li], mask)
        per_light.append(ci)
    cropped = np.stack(per_light)
    th, tw = test_hw
    imgs_lc = np.stack([resize_bilinear_align(im, th, tw) for im in cropped])
    mask_lc = resize_bilinear_align(cmask[..., None], th, tw)[..., 0]
    return (cropped, cmask, crop, imgs_lc.astype(np.float32),
            mask_lc.astype(np.float32))


def sdps_view(lcnet, nenet, imgs: np.ndarray, mask: np.ndarray,
              test_hw: tuple = (128, 128)) -> dict:
    """LCNet and NENet on one view's light images [L, H, W, 3] and mask [H,
    W], as read_view returns them, on the device the nets' parameters are
    on: the mask crop and pad, LCNet at test_hw for the lights (read back
    before NENet runs), NENet at the padded crop for the normals, read back
    and re-embedded into the full frame (test_utils.py:56-67). Returns
    {"dirs" [L, 3] (camera frame), "intens" [L], "normal" [H, W, 3] (zero
    outside the crop, masked inside it), "crop" (top, left, bottom,
    right), "timings" (this view's host seconds as run_sdps describes
    them: "crop_s", "lcnet_s", "nenet_s"; and "crop_hw", NENet's padded
    crop)}.

    Spans: sdps.view (the root) over sdps.prepare (the crop, the pad, the
    resize, the uploads), sdps.lcnet (LCNet and the lights' read-back, which
    waits for it), sdps.nenet (NENet's enqueue) and sdps.readback (the
    normals' read-back, which waits for NENet, and the re-embedding).
    Counters: sdps.lcnet_px (lights x test_hw pixels) and sdps.nenet_px
    (lights x padded crop pixels)."""
    span = profiling.span
    dev = next(lcnet.parameters()).device
    h0, w0 = mask.shape
    with span("sdps.view"):
        with span("sdps.prepare") as prep:
            cropped, cmask, crop, imgs_lc, mask_lc = sdps_inputs(imgs, mask,
                                                                 test_hw)
            x_lc = torch.as_tensor(imgs_lc.transpose(0, 3, 1, 2), device=dev)
            m_lc = torch.as_tensor(mask_lc[None], device=dev)
            x_ne = torch.as_tensor(cropped.transpose(0, 3, 1, 2), device=dev)
        n_l = cropped.shape[0]
        profiling.count("sdps.lcnet_px", n_l * test_hw[0] * test_hw[1])
        profiling.count("sdps.nenet_px",
                        n_l * cropped.shape[1] * cropped.shape[2])
        with torch.no_grad():
            # LCNet at the canonical resolution
            with span("sdps.lcnet") as lc:
                pred = lcnet(x_lc, m_lc)
                dirs = profiling.to_host(pred["dirs"])       # [L, 3]
                intens = profiling.to_host(pred["intens"])   # [L]
            # NENet at the cropped resolution
            with span("sdps.nenet") as ne:
                normal = nenet(x_ne, pred["dirs"], pred["intens"])
        with span("sdps.readback") as back:
            normal = profiling.to_host(normal).transpose(1, 2, 0) \
                * cmask[..., None]
            norm0 = np.zeros((h0, w0, 3), np.float32)
            ch = crop[2] - crop[0]
            cw = crop[3] - crop[1]
            norm0[crop[0]:crop[0] + ch, crop[1]:crop[1] + cw] = \
                normal[:ch, :cw]
    timings = {"crop_s": prep.seconds, "lcnet_s": lc.seconds,
               "nenet_s": ne.seconds + back.seconds,
               "crop_hw": list(cropped.shape[1:3])}
    return {"dirs": dirs, "intens": intens, "normal": norm0, "crop": crop,
            "timings": timings}


def run_sdps(
    data_dir: str,
    lcnet,
    nenet,
    out_dir: str | None = None,
    train_light: int | None = None,
    light_intnorm_gt: bool = False,
    test_hw: tuple = (128, 128),
    timings: dict | None = None,
) -> str:
    """Runs the LCNet and NENet modules (psnerf_torch.preprocess.sdps) on
    the device their parameters are on, one view at a time through
    sdps_view; returns the output directory. `timings`, if given, gets
    per-view lists of host seconds ("read_s": the PNGs; "crop_s": the crops,
    LCNet's resize and the uploads; "lcnet_s": LCNet and the lights'
    read-back; "nenet_s": NENet, the normals' read-back and the
    re-embedding; "write_s") and the NENet crop sizes ("crop_hw"). Spans
    sdps.read and sdps.write beside sdps_view's."""
    with open(os.path.join(data_dir, "params.json")) as f:
        para = json.load(f)
    n_view = para["n_view"]
    light_is_same = para["light_is_same"]

    if out_dir is None:
        sub = "sdps_out"
        if light_intnorm_gt:
            sub += "_intnorm_gt"
        if light_is_same:
            n_l = (train_light if train_light is not None
                   else len(para["light_direction"]))
            sub += f"_l{n_l}"
        out_dir = os.path.join(data_dir, sub)
    os.makedirs(os.path.join(out_dir, "outnpy"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "outimg"), exist_ok=True)

    img_root = "img_intnorm_gt" if light_intnorm_gt else "img"
    lslt = (para[f"light_slt_{train_light}"]
            if light_is_same and train_light is not None else None)
    clock = {k: [] for k in ("read_s", "crop_s", "lcnet_s", "nenet_s",
                             "write_s", "crop_hw")}

    all_dirs, all_ints = [], []
    for vi in range(n_view):
        view = f"view_{vi + 1:02d}"
        with profiling.span("sdps.read") as sp:
            imgs, mask = read_view(data_dir, view, img_root, lslt)
        clock["read_s"].append(sp.seconds)
        r = sdps_view(lcnet, nenet, imgs, mask, test_hw)
        for key, value in r["timings"].items():
            clock[key].append(value)
        with profiling.span("sdps.write") as sp:
            norm0 = r["normal"]
            np.save(os.path.join(out_dir, "outnpy", f"{view}.npy"), norm0)
            vis = ((norm0 / 2 + 0.5) * 255).clip(0, 255).astype(np.uint8)
            imwrite(os.path.join(out_dir, "outimg", f"{view}.png"), vis)
        clock["write_s"].append(sp.seconds)

        all_dirs.append(r["dirs"])
        all_ints.append(r["intens"])

    # light_is_same=false: object arrays of per-view [L_v, ...]
    np.save(os.path.join(out_dir, "light_direction_pred.npy"),
            np.stack(all_dirs) if light_is_same
            else np.asarray(all_dirs, dtype=object))
    np.save(os.path.join(out_dir, "light_intensity_pred.npy"),
            np.stack(all_ints) if light_is_same
            else np.asarray(all_ints, dtype=object))
    if timings is not None:
        timings.update(clock)
    return out_dir
