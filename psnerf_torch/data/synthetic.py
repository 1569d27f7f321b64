"""(A numpy copy of psnerf_tpu/data/synthetic.py, writing PNGs with
Pillow; it writes byte-identical files for a seed.) Synthetic dataset
generator emitting the reference's on-disk contract
(README.md:172-220): params.json, img/<view>/<light>.png, mask/, norm_mask/,
normal/npy/, sdps_out*/ (outnpy normals + light preds), img*/avg*/ averages.

Scenes are unions of spheres, ray-traced analytically:
  * default: one Lambertian+specular sphere at the origin (convex — only
    attached shadows, vis = l.n >= 0);
  * `spheres=SNOWMAN_SPHERES` (or any list of (center, radius)): a NON-convex
    union with analytic CAST shadows — the signature effect of the pipeline
    (stage1/model/rendering.py:378-408 visibility marching; stage-2 visibility
    supervision, stage2/trainer.py:384-392). Shadow rays are intersected
    against every sphere in closed form, so images, per-view visibility
    exports, and vis_plus all carry exact shadowed ground truth.

Used by tests and pipeline smoke-runs — no external downloads.
"""

from __future__ import annotations

import json
import os

import numpy as np

from psnerf_torch.data.scene import imwrite

# A non-convex two-sphere "snowman": the top sphere casts shadows onto the
# bottom one (and vice versa) for the camera-biased light rig below.
SNOWMAN_SPHERES = (
    ((0.0, 0.0, -0.30), 0.50),
    ((0.2, -0.2, 0.45), 0.35),
)


def _look_at(eye: np.ndarray) -> np.ndarray:
    """OpenGL c2w pose: camera at eye, looking at the origin (z-axis points
    AWAY from the target, x right, y up)."""
    fwd = eye / np.linalg.norm(eye)          # OpenGL: -z is view dir
    up = np.asarray([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.99:
        up = np.asarray([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = up
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose


def _normalize_spheres(spheres, radius):
    if spheres is None:
        spheres = (((0.0, 0.0, 0.0), radius),)
    return [(np.asarray(c, np.float64), float(r)) for c, r in spheres]


def _intersect_sphere(o, d, center, radius):
    """First positive hit depth of rays (o[...,3], d[...,3] unit) with one
    sphere; +inf where missed. Broadcasts o against d."""
    oc = o - center
    b = np.sum(d * oc, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    disc = b**2 - c
    hit = disc > 0
    sq = np.sqrt(np.maximum(disc, 0))
    t0 = -b - sq
    t1 = -b + sq
    t = np.where(t0 > 1e-6, t0, np.where(t1 > 1e-6, t1, np.inf))
    return np.where(hit, t, np.inf)


def _trace_spheres(pose_cv, K, hw, spheres):
    """Ray-trace the sphere union: returns (hit mask [H,W], points [H,W,3],
    normals_world [H,W,3], view ray dirs [H,W,3], sphere id [H,W] int)."""
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    d_world = np.einsum("ij,hwj->hwi", pose_cv[:3, :3], d_cam)
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
    o = pose_cv[:3, 3]

    t_best = np.full((h, w), np.inf)
    sid = np.full((h, w), -1, dtype=np.int32)
    for i, (c, r) in enumerate(spheres):
        t = _intersect_sphere(o[None, None], d_world, c, r)
        closer = t < t_best
        t_best = np.where(closer, t, t_best)
        sid = np.where(closer, i, sid)

    hit = np.isfinite(t_best)
    t_safe = np.where(hit, t_best, 0.0)
    pts = o[None, None] + d_world * t_safe[..., None]
    nrm = np.zeros_like(pts)
    for i, (c, r) in enumerate(spheres):
        on_i = (sid == i)[..., None]
        nrm = np.where(on_i, (pts - c) / r, nrm)
    return hit, pts, nrm, d_world, sid


def analytic_visibility(pts, nrm, sid, light_dirs, spheres, eps=1e-4):
    """Exact shadowed visibility of surface points toward directional lights.

    pts/nrm: [..., 3] surface points and outward unit normals; sid: [...]
    index of the sphere each point lies on; light_dirs: [L, 3] unit dirs
    (surface -> light). Returns [L, ...] float in {0, 1}:
      1  iff  l . n >= 0  AND the shadow ray hits no OTHER sphere.
    (A ray leaving its own sphere with l . n >= 0 cannot re-enter it, so the
    own-sphere test reduces to the attached-shadow dot product.)
    """
    light_dirs = np.asarray(light_dirs, np.float64)
    vis = np.einsum("li,...i->l...", light_dirs, nrm) >= 0.0
    origin = pts + nrm * eps
    for i, (c, r) in enumerate(spheres):
        t = np.stack(
            [_intersect_sphere(origin, np.broadcast_to(ld, origin.shape), c, r)
             for ld in light_dirs], axis=0)  # [L, ...]
        occluded = np.isfinite(t) & (sid != i)[None]
        vis &= ~occluded
    return vis.astype(np.float32)


def generate_synthetic_scene(
    outdir: str,
    n_views: int = 4,
    n_test: int = 1,
    n_lights: int = 8,
    hw: tuple = (64, 64),
    radius: float = 0.6,
    cam_dist: float = 3.0,
    focal: float = 80.0,
    light_int: float = 1.2,
    seed: int = 0,
    specular: float = 0.3,
    spheres=None,
    light_spread: float = 0.35,
    ragged_lights: bool = False,
) -> dict:
    """Writes the dataset; returns the params dict.

    spheres: optional list of ((cx, cy, cz), r) — a non-convex union with
    analytic cast shadows (e.g. SNOWMAN_SPHERES). Default: one sphere of
    `radius` at the origin (the original convex scene).
    light_spread: std of the camera-frame light scatter around the optical
    axis; raise it (~0.9) on non-convex scenes so oblique lights cast
    camera-visible shadows.
    ragged_lights: emit a light_is_same=false dataset with DIFFERENT light
    counts per view (n_lights, n_lights-1, n_lights-2, cycling) — the
    reference's per-view light-list layout (stage2/datasets/dataset.py:117-151)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    total = n_views + n_test
    spheres = _normalize_spheres(spheres, radius)
    K = np.asarray(
        [[focal, 0, w / 2, 0], [0, focal, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32,
    )

    # camera ring with elevation jitter
    poses_gl = []
    for i in range(total):
        az = 2 * np.pi * i / total
        el = 0.35 + 0.15 * np.sin(2.1 * i)
        eye = cam_dist * np.asarray(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)]
        )
        poses_gl.append(_look_at(eye))
    poses_gl = np.asarray(poses_gl)

    # per-view light directions in CAMERA frame, pointing from surface toward
    # the light, biased toward the camera (-z in OpenGL camera coords means
    # "behind the camera" is +z... lights roughly along the optical axis with
    # offsets). light_is_same=True shares one rig; ragged_lights draws an
    # independent, differently-sized rig per view.
    def draw_lights(n):
        lc = (rng.normal(size=(n, 3)) * light_spread
              + np.asarray([0, 0, 1.0]))
        return lc / np.linalg.norm(lc, axis=-1, keepdims=True)

    if ragged_lights:
        assert n_lights >= 4, "ragged scenes need n_lights >= 4"
        counts = [n_lights - (vi % 3) for vi in range(total)]
        lights_per_view = [draw_lights(c) for c in counts]
        light_direction_json = [lv.tolist() for lv in lights_per_view]
    else:
        shared = draw_lights(n_lights)
        lights_per_view = [shared] * total
        light_direction_json = shared.tolist()

    params = {
        "n_view": total,
        "view_train": list(range(n_views)),
        "view_test": list(range(n_views, total)),
        "K": K.tolist(),
        "pose_c2w": poses_gl.tolist(),
        "imhw": [h, w],
        "light_is_same": not ragged_lights,
        "light_direction": light_direction_json,
        "gt_normal_world": False,
        "obj_name": "synth_sphere" if len(spheres) == 1 else "synth_snowman",
        # scene spec for write_stage1_exports / tests (not part of the
        # reference contract; readers must tolerate extra keys)
        "synthetic_spheres": [[*map(float, c), r] for c, r in spheres],
    }

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "params.json"), "w") as f:
        json.dump(params, f)

    # light_is_same=false scenes use the unsuffixed sdps_out / img/avg paths
    # (SceneParams.sdps_dir / img_subdir)
    sdps = f"sdps_out_l{n_lights}" if not ragged_lights else "sdps_out"
    for sub in ["mask", "norm_mask", "normal/npy", f"{sdps}/outnpy"]:
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)

    to8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)

    for vi in range(total):
        pose_gl = poses_gl[vi]
        pose_cv = pose_gl.copy()
        pose_cv[:3, 1:3] *= -1.0
        hit, pts, nrm, view_dir, sid = _trace_spheres(pose_cv, K, hw, spheres)

        imwrite(os.path.join(outdir, "mask", f"view_{vi + 1:02d}.png"),
                to8(hit.astype(np.float64)))
        imwrite(os.path.join(outdir, "norm_mask", f"view_{vi + 1:02d}.png"),
                to8(hit.astype(np.float64)))

        # normals: camera-frame (OpenGL rotation transpose), gt_normal_world=False
        n_cam = np.einsum("ji,hwj->hwi", pose_gl[:3, :3], nrm)
        np.save(os.path.join(outdir, "normal", "npy", f"view_{vi + 1:02d}.npy"),
                (n_cam * hit[..., None]).astype(np.float32))
        # SDPS "predictions" = GT normals (+ small noise)
        np.save(os.path.join(outdir, sdps, "outnpy", f"view_{vi + 1:02d}.npy"),
                (n_cam * hit[..., None]).astype(np.float32))

        # albedo pattern on the surface
        albedo = 0.45 + 0.25 * np.stack(
            [np.sin(4 * pts[..., 0]), np.cos(4 * pts[..., 1]),
             np.sin(4 * pts[..., 2])], -1)

        img_dir = os.path.join(outdir, "img", f"view_{vi + 1:02d}")
        avg_dir = os.path.join(
            outdir, "img", "avg" if ragged_lights else f"avg_l{n_lights}")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(avg_dir, exist_ok=True)
        acc = np.zeros((h, w, 3))
        lights_cam_v = lights_per_view[vi]
        n_l_v = len(lights_cam_v)
        l_world = np.einsum("ij,kj->ki", pose_gl[:3, :3], lights_cam_v)
        vis_all = analytic_visibility(pts, nrm, sid, l_world, spheres)  # [L,H,W]
        for li in range(n_l_v):
            cos = np.maximum(np.einsum("hwi,i->hw", nrm, l_world[li]), 0.0)
            half = l_world[li][None, None] - view_dir
            half /= np.maximum(np.linalg.norm(half, axis=-1, keepdims=True), 1e-9)
            spec = specular * np.maximum(
                np.einsum("hwi,hwi->hw", half, nrm), 0.0) ** 32
            shade = (cos * vis_all[li])[..., None]
            rgb = (albedo + spec[..., None]) * light_int * shade
            rgb = np.clip(rgb, 0, 1) * hit[..., None]
            imwrite(os.path.join(img_dir, f"{li + 1:03d}.png"), to8(rgb))
            acc += rgb
        avg = acc / n_l_v + (1.0 - hit[..., None])  # white background average
        imwrite(os.path.join(avg_dir, f"view_{vi + 1:02d}.png"), to8(avg))

    # SDPS light predictions: camera-frame dirs + intensities per view
    # (ragged: object arrays of per-view [L_v, ...], as the reference's
    # allow_pickle loads expect)
    if ragged_lights:
        dir_pred = np.empty(total, object)
        int_pred = np.empty(total, object)
        for vi in range(total):
            dir_pred[vi] = lights_per_view[vi].astype(np.float32)
            int_pred[vi] = np.full((len(lights_per_view[vi]),), light_int,
                                   np.float32)
    else:
        dir_pred = np.tile(
            lights_per_view[0][None], (total, 1, 1)).astype(np.float32)
        int_pred = np.full((total, n_lights), light_int, np.float32)
    np.save(os.path.join(outdir, sdps, "light_direction_pred.npy"), dir_pred)
    np.save(os.path.join(outdir, sdps, "light_intensity_pred.npy"), int_pred)
    return params


def write_stage1_exports(
    scene_dir: str,
    export_dir: str,
    n_vis_plus: int = 8,
    seed: int = 1,
) -> None:
    """Emit analytic ground-truth versions of the stage-1 shape exports
    (points/normal/mask/visibility/vis_plus per view; the contract of
    stage1/shape_extract.py:148-163) so stage-2 can run standalone.

    Visibility is the exact shadowed form (attached + cast shadows against
    every sphere of the scene; see analytic_visibility). For the default
    single-sphere scene it reduces to the convex closed form l . n >= 0.
    """
    rng = np.random.default_rng(seed)
    with open(os.path.join(scene_dir, "params.json")) as f:
        params = json.load(f)
    K = np.asarray(params["K"], np.float32)
    poses_gl = np.asarray(params["pose_c2w"], np.float32)
    h, w = params["imhw"]
    if params.get("light_is_same", True):
        lights_per_view = [np.asarray(params["light_direction"], np.float32)
                           ] * params["n_view"]
    else:  # ragged per-view light lists
        lights_per_view = [np.asarray(ld, np.float32)
                           for ld in params["light_direction"]]
    spheres = _normalize_spheres(
        [(s[:3], s[3]) for s in params.get("synthetic_spheres", [])] or None,
        0.6,
    )

    for sub in ["points", "normal", "mask", "visibility", "vis_plus"]:
        os.makedirs(os.path.join(export_dir, sub), exist_ok=True)

    vp_json = {}
    for vi in range(params["n_view"]):
        pose_gl = poses_gl[vi]
        pose_cv = pose_gl.copy()
        pose_cv[:3, 1:3] *= -1.0
        hit, pts, nrm, _, sid = _trace_spheres(pose_cv, K, (h, w), spheres)
        pts_flat = (pts * hit[..., None]).reshape(-1, 3).astype(np.float32)
        nrm_flat = (nrm * hit[..., None]).reshape(-1, 3).astype(np.float32)
        np.save(os.path.join(export_dir, "points", f"view_{vi + 1:02d}.npy"), pts_flat)
        np.save(os.path.join(export_dir, "normal", f"view_{vi + 1:02d}.npy"), nrm_flat)
        np.save(os.path.join(export_dir, "mask", f"view_{vi + 1:02d}.npy"),
                hit.reshape(-1))
        l_world = np.einsum("ij,kj->ki", pose_gl[:3, :3], lights_per_view[vi])
        hit_flat = hit.reshape(-1)
        vis = analytic_visibility(pts, nrm, sid, l_world, spheres)
        # ones outside the mask (the renderer's fill convention,
        # render_shape_extract / rendering.py:376)
        vis = np.where(hit_flat[None], vis.reshape(len(l_world), -1), 1.0)
        vis = vis.astype(np.float32)
        np.save(os.path.join(export_dir, "visibility", f"view_{vi + 1:02d}.npy"), vis)

        vp = rng.normal(size=(n_vis_plus, 3))
        vp /= np.linalg.norm(vp, axis=-1, keepdims=True)
        vp_json[f"view_{vi + 1:02d}"] = vp.tolist()
        vis_p = analytic_visibility(pts, nrm, sid, vp, spheres)
        vis_p = np.where(hit_flat[None], vis_p.reshape(n_vis_plus, -1), 1.0)
        vis_p = vis_p.astype(np.float32)
        np.save(os.path.join(export_dir, "vis_plus", f"view_{vi + 1:02d}.npy"), vis_p)

    with open(os.path.join(export_dir, "vis_plus", "light_dir.json"), "w") as f:
        json.dump(vp_json, f)
