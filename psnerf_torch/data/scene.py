"""(A copy of psnerf_tpu/data/scene.py, reading and writing PNGs with
Pillow in place of imageio.) Dataset contract: params.json + image
directory layout (README.md:172-220).

Shared scene-level parsing for both stages:
  * K, pose_c2w (OpenGL), the OpenCV flip (columns 1:3 of R negated;
    stage1/dataloading/dataset.py:53-56, stage2/datasets/dataset.py:50-53)
  * view splits (view_train / view_test / view_slt_N / all)
  * light directions (+ cam->world rotation by the OpenGL pose rotation)
  * image subdirectory naming for intensity-normalized variants
    (img_intnorm_gt / img_intnorm_sdps / avg_lN, dataset.py:62-84)
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
from PIL import Image


@dataclasses.dataclass
class SceneParams:
    basedir: str
    n_view: int
    K: np.ndarray                 # [4,4] or [3,3] float32
    pose_gl: np.ndarray           # [V,4,4] camera-to-world, OpenGL
    pose_cv: np.ndarray           # [V,4,4] camera-to-world, OpenCV
    imhw: tuple
    light_is_same: bool
    light_direction: list         # per view [L,3] camera frame (raw json)
    gt_normal_world: bool
    raw: dict

    def view_split(self, split: str, train_view: int | None = None,
                   all_view: bool = False) -> np.ndarray:
        p = self.raw
        if all_view:
            return np.arange(self.n_view)
        if split == "train":
            return (np.array(p[f"view_slt_{train_view}"]) if train_view is not None
                    else np.array(p["view_train"]))
        if split == "test":
            return np.array(p["view_test"])
        if split == "all":
            tr = (np.array(p[f"view_slt_{train_view}"]) if train_view is not None
                  else np.array(p["view_train"]))
            # astype: an empty test list would otherwise upcast to float64
            out = np.concatenate(
                [tr, np.array(p["view_test"])]).astype(np.int64)
            out.sort()
            return out
        raise ValueError(f"unknown split {split!r}")

    def lights_world(self, views: np.ndarray, train_light: int | None = None):
        """Per selected view: light dirs rotated cam->world by the OpenGL pose
        rotation (stage2/datasets/dataset.py:70-76). Returns (list of [L,3],
        list of selected light indices)."""
        if self.light_is_same:
            dirs = np.asarray(self.raw["light_direction"], np.float32)
            n_light = len(dirs)
            slt = np.arange(n_light)
            if train_light is not None and train_light < n_light:
                slt = np.asarray(self.raw[f"light_slt_{train_light}"])
                dirs = dirs[slt]
            out = [
                np.einsum("ij,kj->ki", self.pose_gl[v, :3, :3], dirs)
                for v in views
            ]
            return out, [slt] * len(views)
        dirs_all = [np.asarray(self.raw["light_direction"][v], np.float32)
                    for v in views]
        out = [np.einsum("ij,kj->ki", self.pose_gl[v, :3, :3], d)
               for v, d in zip(views, dirs_all)]
        return out, [np.arange(len(d)) for d in dirs_all]

    def img_subdir(self, inten_normalize: str | None, train_light: int | None):
        """('img...' subdir, 'avg...' type) naming (stage1 dataset.py:62-84,
        stage2 dataset.py:81-86)."""
        im_sub, im_type = "img", "avg"
        if inten_normalize is not None:
            assert inten_normalize in ("gt", "sdps")
            im_sub += "_intnorm_" + inten_normalize
        if self.light_is_same:
            n_light = len(self.raw["light_direction"])
            tl = train_light if train_light is not None else n_light
            if inten_normalize == "sdps":
                im_sub += f"_l{tl}"
            else:
                im_type += f"_l{tl}"
        return im_sub, im_type

    def sdps_dir(self, inten_normalize: str | None, train_light: int | None):
        d = os.path.join(self.basedir, "sdps_out")
        if self.light_is_same:
            n_light = len(self.raw["light_direction"])
            tl = train_light if train_light is not None else n_light
            if inten_normalize == "gt":
                d += "_intnorm_gt"
            d += f"_l{tl}"
        return d


def load_scene_params(basedir: str) -> SceneParams:
    with open(os.path.join(basedir, "params.json")) as f:
        p = json.load(f)
    poses = np.asarray(p["pose_c2w"], np.float32)
    pose_cv = poses.copy()
    pose_cv[:, :3, 1:3] *= -1.0
    return SceneParams(
        basedir=basedir,
        n_view=p["n_view"],
        K=np.asarray(p["K"], np.float32),
        pose_gl=poses,
        pose_cv=pose_cv,
        imhw=tuple(p.get("imhw", ())),
        light_is_same=p["light_is_same"],
        light_direction=p.get("light_direction", []),
        gt_normal_world=p.get("gt_normal_world", True),
        raw=p,
    )


def imread(path: str) -> np.ndarray:
    """An image file as an array, as imageio.v2.imread gives it for PNG:
    palette images are expanded to RGB(A)."""
    if path.endswith(".exr"):
        raise ValueError(f"{path!r}: EXR images are not read by psnerf_torch")
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        return np.asarray(im)


def imwrite(path: str, arr: np.ndarray) -> None:
    """Write an 8-bit image; for PNG the bytes are those imageio.v2.imwrite
    writes (both go through Pillow's default PNG encoder)."""
    Image.fromarray(np.asarray(arr)).save(path)


def load_image(path: str) -> np.ndarray:
    return np.asarray(imread(path), np.float32)[..., :3] / 255.0


def load_image_u8(path: str) -> np.ndarray | None:
    """Raw 8-bit image bytes, or None when the source isn't 8-bit RGB(A).

    Keeping the bytes and dividing by 255 later (on device) reproduces
    load_image() bit-exactly — f32(u)/f32(255.0) is the same single IEEE
    division either way — at a quarter of the transfer/HBM cost."""
    if path.endswith(".exr"):
        return None
    img = imread(path)
    if img.dtype != np.uint8 or img.ndim != 3:
        return None
    return img[..., :3]


def load_mask(path: str) -> np.ndarray:
    m = np.asarray(imread(path), np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    return m / 255.0
