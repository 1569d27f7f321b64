"""Synthetic DiLiGenT-MV-shaped scenes, made on the device from a seed.

A frozen torch form of the port's synthetic scene generator
(psnerf_torch/data/synthetic.py as it stood when this benchmark was
written), so that a later change to the program cannot change the data:
the same on-disk contract (params.json, mask/, norm_mask/, normal/npy/,
sdps_out_l<L>/ with the SDPS "predictions", the images) and the same
object, a union of spheres ray-traced analytically with exact cast
shadows, seen from a camera ring with a camera-biased light rig.

Changes from the copy: everything is computed in float32 on the device in
a few large calls; the images go where the published configs read them
(inten_normalize = sdps: img_intnorm_sdps_l<L>/view_XX/<light>.png and
img_intnorm_sdps_l<L>/avg/view_XX.png); the per-light images are written
only when a stage reads them (stage 2), on a few threads; the stage-1
shape export that stage 2 reads (points, normal, mask, visibility,
vis_plus) is written from the same analytic trace, the visibility only
for the views stage 2 trains on.

Nothing here imports the program.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

# The two-sphere "snowman" of the port's generator: the top sphere casts
# shadows onto the bottom one under the camera-biased lights.
SNOWMAN_SPHERES = (((0.0, 0.0, -0.30), 0.50), ((0.2, -0.2, 0.45), 0.35))


def _imwrite(path: str, arr: np.ndarray) -> None:
    Image.fromarray(arr).save(path, compress_level=1)


def _to8(x: torch.Tensor) -> np.ndarray:
    return (torch.clamp(x, 0, 1) * 255).to(torch.uint8).cpu().numpy()


def look_at(eye: np.ndarray) -> np.ndarray:
    """OpenGL c2w pose: camera at eye looking at the origin (z away from
    the target, x right, y up)."""
    fwd = eye / np.linalg.norm(eye)
    up = np.asarray([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.99:
        up = np.asarray([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, fwd, eye
    return pose


def camera_ring(n: int, cam_dist: float) -> np.ndarray:
    """[n, 4, 4] OpenGL c2w poses on a ring with elevation jitter."""
    poses = []
    for i in range(n):
        az = 2 * np.pi * i / n
        el = 0.35 + 0.15 * np.sin(2.1 * i)
        poses.append(look_at(cam_dist * np.asarray(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])))
    return np.asarray(poses)


def _intersect(o, d, center, radius):
    """First positive hit depth of rays o + t d (d unit) with one sphere;
    +inf where missed. Broadcasts o against d."""
    oc = o - center
    b = torch.sum(d * oc, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > 1e-6, t0, torch.where(t1 > 1e-6, t1, torch.inf))
    return torch.where(disc > 0, t, torch.inf)


def trace(pose_gl, K, hw, spheres, dev):
    """Ray-trace the sphere union from one camera: hit [H, W] bool, points,
    world normals and unit view rays [H, W, 3], sphere id [H, W]."""
    h, w = hw
    pose_cv = torch.as_tensor(pose_gl, device=dev).clone()
    pose_cv[:3, 1:3] *= -1.0
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    d_cam = torch.stack([(xs - K[0][2]) / K[0][0], (ys - K[1][2]) / K[1][1],
                         torch.ones_like(xs)], -1)
    d = torch.einsum("ij,hwj->hwi", pose_cv[:3, :3], d_cam)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = pose_cv[:3, 3]
    t_best = torch.full((h, w), torch.inf, device=dev)
    sid = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    for i, (c, r) in enumerate(spheres):
        t = _intersect(o, d, c, r)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        sid = torch.where(closer, i, sid)
    hit = torch.isfinite(t_best)
    pts = o + d * torch.where(hit, t_best, 0.0)[..., None]
    nrm = torch.zeros_like(pts)
    for i, (c, r) in enumerate(spheres):
        nrm = torch.where((sid == i)[..., None], (pts - c) / r, nrm)
    return hit, pts, nrm, d, sid


def visibility(pts, nrm, sid, dirs, spheres, eps=1e-4):
    """Exact shadowed visibility [L, ...] in {0, 1} of surface points toward
    directional lights dirs [L, 3] (surface -> light): l.n >= 0 and the
    shadow ray meets no other sphere."""
    vis = torch.einsum("li,...i->l...", dirs, nrm) >= 0.0
    origin = pts + nrm * eps
    for i, (c, r) in enumerate(spheres):
        for s in range(dirs.shape[0]):
            t = _intersect(origin, dirs[s].expand_as(origin), c, r)
            vis[s] &= ~(torch.isfinite(t) & (sid != i))
    return vis.float()


def unit_rows(g: torch.Generator, n: int, dev, bias=None, spread=1.0):
    x = torch.randn((n, 3), generator=g, device=dev) * spread
    if bias is not None:
        x = x + torch.as_tensor(bias, dtype=torch.float32, device=dev)
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def generate(outdir: str, spec: dict, seed: int, dev,
             light_images: bool, export_dir: str | None = None,
             n_vis_plus: int = 8) -> dict:
    """Write the scene of `spec` (the configuration's "dataset" block) to
    outdir; with export_dir also the analytic stage-1 shape export. The
    train views come first, then the test views. Returns the params dict
    plus "mask_share" (mean share of pixels on the object)."""
    n_train, n_test = spec["n_views_train"], spec["n_views_test"]
    total = n_train + n_test
    h, w = spec["hw"]
    n_l = spec["n_lights"]
    focal = spec["focal_px"]
    spheres = [(torch.tensor(c, dtype=torch.float32, device=dev), float(r))
               for c, r in SNOWMAN_SPHERES]
    g = torch.Generator(device=dev).manual_seed(seed)
    K = [[focal, 0, w / 2, 0], [0, focal, h / 2, 0], [0, 0, 1, 0],
         [0, 0, 0, 1]]
    poses = camera_ring(total, spec["cam_dist"])
    lights_cam = unit_rows(g, n_l, dev, (0, 0, 1.0), spec["light_spread"])
    params = {
        "n_view": total, "view_train": list(range(n_train)),
        "view_test": list(range(n_train, total)), "K": K,
        "pose_c2w": poses.tolist(), "imhw": [h, w], "light_is_same": True,
        "light_direction": lights_cam.cpu().numpy().tolist(),
        "gt_normal_world": False, "obj_name": "synth_snowman",
        "synthetic_spheres": [[*c.tolist(), r] for c, r in spheres]}
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "params.json"), "w") as f:
        json.dump(params, f)
    img_root = f"img_intnorm_sdps_l{n_l}"
    sdps = f"sdps_out_l{n_l}"
    for sub in ("mask", "norm_mask", "normal/npy", f"{sdps}/outnpy",
                f"{img_root}/avg"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)
    if export_dir:
        for sub in ("points", "normal", "mask", "visibility", "vis_plus"):
            os.makedirs(os.path.join(export_dir, sub), exist_ok=True)

    pool = ThreadPoolExecutor(max_workers=4)
    jobs, shares, vp_json = [], [], {}
    for vi in range(total):
        name = f"view_{vi + 1:02d}"
        pose = torch.as_tensor(poses[vi], device=dev)
        hit, pts, nrm, view_dir, sid = trace(poses[vi], K, (h, w), spheres,
                                             dev)
        shares.append(hit.float().mean().item())
        m8 = _to8(hit.float())
        jobs.append(pool.submit(_imwrite, os.path.join(
            outdir, "mask", name + ".png"), m8))
        jobs.append(pool.submit(_imwrite, os.path.join(
            outdir, "norm_mask", name + ".png"), m8))
        n_cam = torch.einsum("ji,hwj->hwi", pose[:3, :3], nrm) * hit[..., None]
        n_cam = n_cam.cpu().numpy()
        np.save(os.path.join(outdir, "normal", "npy", name + ".npy"), n_cam)
        np.save(os.path.join(outdir, sdps, "outnpy", name + ".npy"), n_cam)
        albedo = 0.45 + 0.25 * torch.stack(
            [torch.sin(4 * pts[..., 0]), torch.cos(4 * pts[..., 1]),
             torch.sin(4 * pts[..., 2])], -1)
        l_world = lights_cam @ pose[:3, :3].T                       # [L, 3]
        vis = visibility(pts, nrm, sid, l_world, spheres)           # [L,H,W]
        cos = torch.clamp_min(torch.einsum("hwi,li->lhw", nrm, l_world), 0)
        half = l_world[:, None, None] - view_dir[None]
        half = half / torch.clamp_min(torch.linalg.norm(
            half, dim=-1, keepdim=True), 1e-9)
        spec_ = 0.3 * torch.clamp_min(
            torch.sum(half * nrm[None], -1), 0.0) ** 32
        rgb = (albedo[None] + spec_[..., None]) * 1.2 * (cos * vis)[..., None]
        rgb = torch.clamp(rgb, 0, 1) * hit[None, ..., None]         # [L,H,W,3]
        avg = rgb.mean(0) + (~hit)[..., None].float()
        jobs.append(pool.submit(_imwrite, os.path.join(
            outdir, img_root, "avg", name + ".png"), _to8(avg)))
        if light_images:
            d = os.path.join(outdir, img_root, name)
            os.makedirs(d, exist_ok=True)
            rgb8 = _to8(rgb)
            for li in range(n_l):
                jobs.append(pool.submit(_imwrite, os.path.join(
                    d, f"{li + 1:03d}.png"), rgb8[li]))
        if export_dir:
            flat = lambda x: (x * hit[..., None]).reshape(-1, 3).cpu().numpy()
            np.save(os.path.join(export_dir, "points", name + ".npy"),
                    flat(pts))
            np.save(os.path.join(export_dir, "normal", name + ".npy"),
                    flat(nrm))
            np.save(os.path.join(export_dir, "mask", name + ".npy"),
                    hit.reshape(-1).cpu().numpy())
            if vi < n_train:
                v = torch.where(hit[None], vis, 1.0).reshape(n_l, -1)
                np.save(os.path.join(export_dir, "visibility", name + ".npy"),
                        v.cpu().numpy())
            vp = unit_rows(g, n_vis_plus, dev)
            vp_json[name] = vp.cpu().numpy().tolist()
            v = torch.where(hit[None], visibility(pts, nrm, sid, vp, spheres),
                            1.0).reshape(n_vis_plus, -1)
            np.save(os.path.join(export_dir, "vis_plus", name + ".npy"),
                    v.cpu().numpy())
    for j in jobs:
        j.result()
    pool.shutdown()
    if export_dir:
        with open(os.path.join(export_dir, "vis_plus", "light_dir.json"),
                  "w") as f:
            json.dump(vp_json, f)
    ld = lights_cam.cpu().numpy()
    np.save(os.path.join(outdir, sdps, "light_direction_pred.npy"),
            np.tile(ld[None], (total, 1, 1)).astype(np.float32))
    np.save(os.path.join(outdir, sdps, "light_intensity_pred.npy"),
            np.full((total, n_l), 1.2, np.float32))
    return dict(params, mask_share=float(np.mean(shares)))


def world_lights(params: dict) -> np.ndarray:
    """[V, L, 3] light directions of every view in the world frame."""
    ld = np.asarray(params["light_direction"], np.float32)
    poses = np.asarray(params["pose_c2w"], np.float32)
    return np.einsum("vij,lj->vli", poses[:, :3, :3], ld)

