"""Stage-2 data (counterpart of psnerf_tpu/data/stage2.py): multi-light
images plus the stage-1 shape export, as tensors on one device, and the
training batch sampler.

Images stay as their 8-bit bytes on the device when every source is 8-bit
("auto"/"u8"); decode_imgs divides by 255 on use, which is bit-exact with
loading them as float. Ragged per-view light counts are padded to the
largest count; light_count / light_mask mark the real lights.

A training batch is a draw of indices (`draw_stage2_indices`: lights,
pixels and vis_plus pool rows, from a torch.Generator) and a gather at
those indices (`gather_stage2_batch`), so a test can gather at the JAX
sampler's own indices. The draws without replacement are Gumbel top-k, as
jax.random.choice(replace=False, p=...) draws them: a zero-weight item
comes after every weighted one, so a mask with fewer pixels than asked
still gives distinct pixels, all of the mask's first.
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
      [V, 4, 4] OpenCV, K, vis_plus_dirs/vis_plus (when vis_plus),
      light_row_offset [V] (each view's first row of the flat light table);
    and host values: light_slt [V, L], light_count [V], pose_gl, views,
    img_res, n_light_rows."""
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
    out["light_row_offset"] = t(np.concatenate([[0], np.cumsum(llen)[:-1]]))
    out["n_light_rows"] = int(np.sum(llen))
    return out


def gumbel_top_k(weights: torch.Tensor, k: int,
                 generator: torch.Generator) -> torch.Tensor:
    """k distinct indices drawn without replacement with probabilities in
    proportion to weights [n] (>= 0): the k largest of log w + Gumbel
    noise. Zero weights sort last, the lower index first among them."""
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    g = -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))
    keys = torch.log(weights.float()) + g
    return torch.sort(keys, descending=True, stable=True).indices[:k]


def _pick(data: dict, name: str, view: torch.Tensor) -> torch.Tensor:
    """data[name][view] for a one-element index tensor (no host read)."""
    return torch.index_select(data[name], 0, view)[0]


def draw_stage2_indices(data: dict, view: torch.Tensor, num_pixels: int,
                        light_bs: int, generator: torch.Generator,
                        sample_in_mask: bool = True,
                        vis_train_num: int | None = None) -> dict:
    """One batch's random indices into view `view` (a one-element index
    tensor on the data's device): lidx [light_bs] distinct real lights,
    pix [num_pixels] distinct pixels (inside the object mask first when
    sample_in_mask), and with vis_train_num, sidx [vis_train_num] distinct
    rows of the vis_plus pool (the view's vis_plus directions, then its real
    train lights). The draws follow psnerf_tpu/data/stage2.py:171-248."""
    lmask = _pick(data, "light_mask", view)
    out = {"lidx": gumbel_top_k(lmask, light_bs, generator)}
    total_px = data["imgs"].shape[2]
    if sample_in_mask:
        weights = _pick(data, "object_masks", view)
    else:
        weights = torch.ones((total_px,), device=lmask.device)
    out["pix"] = gumbel_top_k(weights, num_pixels, generator)
    if vis_train_num is not None:
        n_vp = data["vis_plus_dirs"].shape[1]
        pool = torch.cat([torch.ones((n_vp,), dtype=torch.bool,
                                     device=lmask.device), lmask])
        out["sidx"] = gumbel_top_k(pool, vis_train_num, generator)
    return out


def gather_stage2_batch(data: dict, view: torch.Tensor, lidx: torch.Tensor,
                        pix: torch.Tensor, sidx: torch.Tensor | None = None,
                        light_init_dirs: torch.Tensor | None = None) -> dict:
    """The training batch of view `view` at the given indices: uv [N, 2],
    pose, intrinsics, object_mask, points, normal, surface_mask [N],
    rgb_gt [L, N, 3], l_slt [L] (rows of the flat light table), lidx, pix,
    visibility [L, N] (with vis_loss data), and with sidx and
    light_init_dirs [V, L, 3] the vis_plus supervision light_vis_train
    [Lv, 3] and vis_train_gt [Lv, N] from the pool of the view's vis_plus
    directions and its initial train-light directions."""
    w = data["img_res"][1]
    row = lambda name: _pick(data, name, view)[pix]
    lp = (lidx[:, None], pix[None, :])
    batch = {
        "uv": torch.stack([pix % w, torch.div(pix, w, rounding_mode="floor")],
                          dim=-1).float(),
        "pose": _pick(data, "poses", view),
        "intrinsics": data["K"],
        "object_mask": row("object_masks"),
        "points": row("points"),
        "normal": row("normals"),
        "surface_mask": row("surface_mask"),
        "rgb_gt": decode_imgs(_pick(data, "imgs", view)[lp]),
        "l_slt": torch.index_select(data["light_row_offset"], 0, view) + lidx,
        "lidx": lidx,
        "pix": pix,
    }
    if "visibility" in data:
        batch["visibility"] = _pick(data, "visibility", view)[lp]
    if sidx is not None and light_init_dirs is not None:
        vp_dirs = _pick(data, "vis_plus_dirs", view)
        n_vp = vp_dirs.shape[0]
        vp = sidx < n_vp
        i_vp, i_tl = sidx.clamp(max=n_vp - 1), (sidx - n_vp).clamp(min=0)
        init = torch.index_select(light_init_dirs, 0, view)[0]
        batch["light_vis_train"] = torch.where(vp[:, None], vp_dirs[i_vp],
                                               init[i_tl])
        batch["vis_train_gt"] = torch.where(
            vp[:, None], _pick(data, "vis_plus", view)[i_vp[:, None],
                                                       pix[None, :]],
            _pick(data, "visibility", view)[i_tl[:, None], pix[None, :]])
    return batch


def sample_stage2_batch(data: dict, view: torch.Tensor, generator,
                        num_pixels: int, light_bs: int,
                        sample_in_mask: bool = True, vis_train_num: int = 16,
                        light_init_dirs: torch.Tensor | None = None) -> dict:
    """A draw and its gather: the batch of psnerf_tpu's sample_stage2_batch
    (with the vis_plus pool when the data has it and light_init_dirs is
    given)."""
    use_vp = "vis_plus" in data and light_init_dirs is not None
    idx = draw_stage2_indices(data, view, num_pixels, light_bs, generator,
                              sample_in_mask,
                              vis_train_num if use_vp else None)
    return gather_stage2_batch(data, view, idx["lidx"], idx["pix"],
                               idx.get("sidx"), light_init_dirs)
