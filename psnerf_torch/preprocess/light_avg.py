"""Light-averaged and intensity-normalized images (counterpart of
psnerf_tpu/preprocess/light_avg.py; reference light_avg.py:14-67; PNGs
through Pillow): per view, the mean over the (optionally intensity-
normalized) light images -> `img*/avg*/view_XX.png`; the normalized
per-light copies -> `img_intnorm_*/view_XX/NNN.png`."""

from __future__ import annotations

import json
import os

import numpy as np

from psnerf_torch.data.scene import imread, imwrite


def light_average(
    obj_dir: str,
    train_light: int | None = None,
    intnorm: bool = False,
    sdps: bool = False,
) -> str:
    """Three modes: plain averages under img/; intnorm=True with the GT
    `light_intensity` of params.json (-> img_intnorm_gt/); intnorm=True,
    sdps=True with SDPS's light_intensity_pred.npy (-> img_intnorm_sdps*/).
    Returns the directory written."""
    with open(os.path.join(obj_dir, "params.json")) as f:
        para = json.load(f)
    n_view = para["n_view"]
    light_is_same = para["light_is_same"]
    explicit_train_light = train_light is not None

    if train_light is None:
        if light_is_same:
            train_light = len(para["light_direction"])
            light_slt = [np.arange(train_light)] * n_view
            avgdir = f"avg_l{train_light}"
        else:
            light_slt = [np.arange(len(ll)) for ll in para["light_direction"]]
            avgdir = "avg"
    else:
        if not light_is_same:
            raise ValueError("train_light needs a light_is_same dataset")
        light_slt = [np.asarray(para[f"light_slt_{train_light}"])] * n_view
        avgdir = f"avg_l{train_light}"

    if intnorm:
        if sdps:
            sub = (f"sdps_out_l{train_light}" if light_is_same else "sdps_out")
            light_int = np.load(os.path.join(obj_dir, sub,
                                             "light_intensity_pred.npy"),
                                allow_pickle=True)
            normalizedir = os.path.join(
                obj_dir,
                f"img_intnorm_sdps_l{train_light}" if light_is_same
                else "img_intnorm_sdps")
            avgdir = "avg"
        else:
            if "light_intensity" not in para:
                raise KeyError("intnorm without sdps needs params.json's "
                               "light_intensity")
            if light_is_same:
                light_int = [np.asarray(para["light_intensity"])[light_slt[0]]
                             ] * n_view
            else:
                light_int = [np.asarray(ll) for ll in para["light_intensity"]]
            normalizedir = os.path.join(obj_dir, "img_intnorm_gt")
    else:
        normalizedir = os.path.join(obj_dir, "img")

    os.makedirs(os.path.join(normalizedir, avgdir), exist_ok=True)
    to8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.uint8)
    for vi in range(n_view):
        view = f"view_{vi + 1:02d}"
        mask = np.asarray(imread(os.path.join(obj_dir, "mask",
                                              view + ".png"))).astype(bool)
        if mask.ndim == 3:
            mask = mask[..., 0]
        if intnorm:
            # anchor: light 3 for the full same-light set, light 0 otherwise
            anchor = 3 if (light_is_same and not explicit_train_light) else 0
            relat = (np.asarray(light_int[vi])
                     / np.asarray(light_int[vi])[anchor])
            os.makedirs(os.path.join(normalizedir, view), exist_ok=True)
        acc = []
        for idx, li in enumerate(light_slt[vi]):
            img = np.asarray(imread(os.path.join(
                obj_dir, "img", view, f"{li + 1:03d}.png")),
                np.float64)[..., :3] / 255.0
            img = img * mask[..., None]
            if intnorm:
                img = img / relat[idx]
                imwrite(os.path.join(normalizedir, view, f"{li + 1:03d}.png"),
                        to8(img))
            acc.append(img)
        imwrite(os.path.join(normalizedir, avgdir, view + ".png"),
                to8(np.mean(acc, axis=0)))
    return normalizedir
