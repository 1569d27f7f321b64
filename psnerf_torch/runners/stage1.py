"""Stage-1 runner (counterpart of psnerf_tpu/runners/stage1.py): training,
full-image eval and the shape export for stage 2.

Trains the occupancy field step by step on its device. On a CUDA device the
march's occupancy queries go through the fused_occ kernel and the
integration batch through the fused_radiance kernels by default, in the
field's operand form (f32 for the default field, bf16 for a bf16 field).
Losses stay on the device between logs: the only reads back to the host are
at log time.

The eval render and the export march every pixel through fused_occ (the
export also every surface point toward every light); their integration
pass stays plain PyTorch, as in the JAX package. Images are processed
row-major (pixel n -> x = n % w, y = n // w). Each full image queues all of
its tiles on the device and reads the results back once. The export runs
the faithful protocol only; mesh extraction comes with a later slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from psnerf_torch.config import Stage1Config, milestones_epochs_to_iters
from psnerf_torch.data.scene import imwrite, load_scene_params
from psnerf_torch.data.stage1 import load_stage1_data, sample_stage1_batch
from psnerf_torch.device import resolve_device
from psnerf_torch.fields.occupancy import init_occupancy_field, occ_alpha
from psnerf_torch.ops.fps import farthest_point_sampling_np
from psnerf_torch.ops.fused_occ import make_fused_occ_fn
from psnerf_torch.ops.fused_radiance import supports
from psnerf_torch.render.marching import light_visibility
from psnerf_torch.render.phong import phong_shade
from psnerf_torch.render.unisurf import (draw_unisurf_noise,
                                         render_shape_extract,
                                         render_unisurf)
from psnerf_torch.train.checkpoints import (latest_checkpoint,
                                            load_checkpoint, load_module,
                                            load_tree, save_checkpoint)
from psnerf_torch.train.logging import MetricLogger, _to8, stage1_vis_strip
from psnerf_torch.train.stage1 import make_stage1_train_step


def world_lights(scene, cfg: Stage1Config, views) -> list:
    """The SDPS-estimated light directions [L, 3] of each view, rotated
    from its camera frame into the world frame: the export's lights."""
    sdps_dir = scene.sdps_dir(cfg.inten_normalize, cfg.train_light)
    lp = np.load(os.path.join(sdps_dir, "light_direction_pred.npy"),
                 allow_pickle=True)[views]
    return [np.einsum("ij,kj->ki", scene.pose_gl[vi, :3, :3], lp[i])
            .astype(np.float32) for i, vi in enumerate(views)]


def _row_major_pixels(h: int, w: int, device) -> torch.Tensor:
    """Pixel coordinates [h * w, 2] (x, y), row-major."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(-1, 2).float()


class Stage1Runner:
    def __init__(self, cfg: Stage1Config, workdir: str, seed: int = 0,
                 resume: bool = True, use_fused_occ: bool | None = None,
                 use_fused_radiance: bool | None = None,
                 device: str | torch.device = "cuda"):
        """use_fused_occ / use_fused_radiance: None = on when the device is
        CUDA (the radiance kernels also need `supports(cfg.field)`: their
        layout takes the default OccFieldConfig() in either operand
        form)."""
        self.device = dev = resolve_device(device)
        on_card = dev.type == "cuda"
        if use_fused_occ is None:
            use_fused_occ = on_card
        if use_fused_radiance is None:
            use_fused_radiance = on_card and supports(cfg.field)
            if on_card and not use_fused_radiance:
                print("[stage1] fused radiance kernels off: they do not take "
                      "this architecture (see ops.fused_radiance.supports); "
                      "the plain route runs")
        elif use_fused_radiance and not supports(cfg.field):
            raise ValueError("the fused radiance kernels do not take this "
                             "field (see ops.fused_radiance.supports)")
        self.use_fused_occ = use_fused_occ
        self.use_fused_radiance = use_fused_radiance
        self.cfg = cfg
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.scene = load_scene_params(cfg.data_dir)
        self.data = load_stage1_data(
            self.scene, "train", cfg.inten_normalize, cfg.train_view,
            cfg.train_light, cfg.all_view, cfg.render.white_background,
            normal_loss=True, mask_valid=True, mask_black=cfg.mask_black,
            device=dev)
        self.n_views = len(self.data["views"])
        # milestones are epochs; one epoch is one pass over the views
        self.tcfg = dataclasses.replace(
            cfg.train, milestone_iters=milestones_epochs_to_iters(
                cfg.train.milestone_iters, self.n_views))
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.field = init_occupancy_field(
            cfg.field, generator=torch.Generator().manual_seed(seed),
            device=dev)
        init_opt, self.step_fn = make_stage1_train_step(
            cfg.field, cfg.render, self.tcfg, use_fused_occ=use_fused_occ,
            use_fused_radiance=use_fused_radiance)
        self.opt_state = init_opt(self.field)
        self.it = 0
        self.ckpt_dir = os.path.join(workdir, "checkpoints")
        if resume:
            ck = latest_checkpoint(self.ckpt_dir)
            if ck:
                flat, scalars = load_checkpoint(ck)
                load_module(self.field, flat, "params/")
                self.opt_state = load_tree(self.opt_state, flat, "opt/")
                self.it = int(scalars.get("it", 0))
                print(f"resumed from {ck} at it={self.it}")
        self.logger = MetricLogger(os.path.join(workdir, "metrics.jsonl"))

    def sample(self, use_outside: bool):
        """One step's view, ray batch and render noise, all drawn on the
        device from the runner's generator."""
        dev, gen = self.device, self.generator
        view = torch.randint(0, self.n_views, (1,), generator=gen, device=dev)
        n = self.tcfg.n_training_points
        batch = sample_stage1_batch(self.data, view, n, gen, normal_angle=65.0)
        r = self.cfg.render
        n_samples = r.num_points_in + (r.num_points_out if use_outside else 0)
        return batch, draw_unisurf_noise(n, n_samples, gen, dev)

    def _occ_fn(self):
        """The march's occupancy closure over the field's current weights:
        the fused_occ kernel's, or None (the renderers' plain route)."""
        if not self.use_fused_occ:
            return None
        return make_fused_occ_fn(self.field, self.cfg.field)

    def train(self, max_iters: int, log_every: int | None = None,
              ckpt_every: int | None = None, on_log=None,
              wall_budget_s: float | None = None,
              vis_every: int | None = None):
        """Train until `it` reaches max_iters, logging every log_every steps
        (a non-finite loss since the last log halts the run) and writing
        the rolling checkpoint every ckpt_every steps and at the end.
        vis_every: write the visualisation strip vis/it_<it>.png whenever
        `it` > 0 is a multiple of it (0 disables; default
        cfg.visualize_every). wall_budget_s: once this many seconds have
        passed, checkpoint and return (a later call resumes)."""
        cfg = self.cfg
        log_every = log_every or cfg.print_every
        ckpt_every = ckpt_every or cfg.checkpoint_every
        if vis_every is None:
            vis_every = cfg.visualize_every
        losses = []
        t_start = t0 = time.time()
        while self.it < max_iters:
            if vis_every and self.it > 0 and self.it % vis_every == 0:
                os.makedirs(os.path.join(self.workdir, "vis"), exist_ok=True)
                self.render_visdata(os.path.join(self.workdir, "vis",
                                                 f"it_{self.it}.png"))
            if (wall_budget_s is not None
                    and time.time() - t_start > wall_budget_s):
                self.save(self.it)
                print(f"[stage1] wall budget reached at it={self.it}; "
                      "checkpointed for resume")
                return self
            use_outside = self.it > self.tcfg.outside_after
            batch, noise = self.sample(use_outside)
            terms = self.step_fn(self.field, self.opt_state, batch, self.it,
                                 noise, use_outside=use_outside)
            losses.append(terms["loss"])
            self.it += 1
            if self.it % log_every == 0:
                vals = torch.stack(losses).cpu()
                terms = {k: float(v) for k, v in terms.items()}
                if not torch.isfinite(vals).all():
                    # the rolling checkpoint holds a pre-divergence state
                    bad = int(torch.nonzero(~torch.isfinite(vals))[0, 0])
                    raise FloatingPointError(
                        f"non-finite loss at it={self.it - len(losses) + bad + 1}"
                        f": {terms}")
                losses = []
                dt = time.time() - t0
                print(f"[stage1 it {self.it}] loss={terms['loss']:.4f} "
                      f"rgb={terms['fullrgb_loss']:.4f} "
                      f"grad={terms['grad_loss']:.4f} "
                      f"normal={terms.get('normal_loss', 0.0):.4f} "
                      f"lr={terms['lr']:.2e} {log_every / dt:.1f} it/s")
                self.logger.log(self.it, terms)
                if on_log:
                    on_log(self.it, terms)
                t0 = time.time()
            if self.it % ckpt_every == 0 or self.it == max_iters:
                self.save(self.it)
        return self

    def save(self, it: int) -> str:
        """Write the params, the optimizer state and `it` to the rolling
        checkpoint, and to a numbered one every backup_every steps."""
        tree = {"params": self.field, "opt": self.opt_state}
        path = os.path.join(self.ckpt_dir, "model.npz")
        save_checkpoint(path, tree, {"it": it})
        if it % self.cfg.backup_every == 0:
            save_checkpoint(os.path.join(self.ckpt_dir, f"model_{it}.npz"),
                            tree, {"it": it})
        return path

    # ---------------------------------------------------------------- eval
    @torch.no_grad()
    def render_view(self, view: int, tile: int = 4096, data=None) -> dict:
        """Full-image eval render of one view -> numpy {"rgb", "normal",
        "phong": [H, W, 3], "mask", "acc": [H, W]}. The phong panel shades
        the same march's surface with a light at the camera."""
        data = data or self.data
        cfg = self.cfg
        h, w = data["imgs"].shape[1:3]
        pix = _row_major_pixels(h, w, self.device)
        n = pix.shape[0]
        pix = torch.cat([pix, pix.new_zeros(((-n) % tile, 2))])
        pose = data["poses"][view]
        light = pose[:3, 3] / torch.linalg.norm(pose[:3, 3])
        occ_fn = self._occ_fn()
        chunks = []
        for s in range(0, pix.shape[0], tile):
            out = render_unisurf(
                self.field, cfg.field, cfg.render, pix[s:s + tile], data["K"],
                pose, it=1e5, noise=None, use_outside=True, train=False,
                occ_fn=occ_fn)
            chunks.append({
                "rgb": out["rgb"], "normal": out["normal_pred"],
                "mask": out["mask_pred"], "acc": out["acc_map"],
                "phong": phong_shade(out["normal_pred"], out["mask_pred"],
                                     light)})
        shapes = {"rgb": (h, w, 3), "normal": (h, w, 3), "mask": (h, w),
                  "acc": (h, w), "phong": (h, w, 3)}
        return {k: torch.cat([c[k] for c in chunks])[:n].reshape(shape)
                .cpu().numpy() for k, shape in shapes.items()}

    def eval_views(self, out_dir: str, split: str = "test",
                   tile: int = 4096) -> list:
        """Render every view of a split; write rgb, normal, mask, acc and
        phong PNGs, the normal .npy, and metrics.json with each view's PSNR
        against its image."""
        cfg = self.cfg
        data = load_stage1_data(
            self.scene, split, cfg.inten_normalize, cfg.train_view,
            cfg.train_light, False, cfg.render.white_background,
            normal_loss=True, mask_valid=False, device=self.device)
        subs = ("rgb", "normal", "mask", "acc", "phong")
        for sub in subs:
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        metrics = []
        for v, vi in enumerate(data["views"]):
            r = self.render_view(v, tile, data)
            name = f"view_{vi + 1:02d}"
            panels = {"rgb": r["rgb"], "normal": r["normal"] / 2 + 0.5,
                      "mask": r["mask"].astype(np.float64), "acc": r["acc"],
                      "phong": r["phong"]}
            for sub in subs:
                imwrite(os.path.join(out_dir, sub, name + ".png"),
                        _to8(panels[sub]))
            np.save(os.path.join(out_dir, "normal", name + ".npy"),
                    r["normal"])
            gt = data["imgs"][v].cpu().numpy()
            mse = float(np.mean((r["rgb"] - gt) ** 2))
            metrics.append({"view": int(vi),
                            "psnr": -10 * np.log10(mse + 1e-12)})
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        return metrics

    def render_visdata(self, out_path: str, views=(0, 1),
                       tile: int = 4096) -> np.ndarray:
        """The visualisation strip of each training view in `views` (gt |
        render | normal | SDPS normal | angular error | mask | acc | phong),
        stacked vertically, written to out_path."""
        rows = []
        for v in views:
            if v >= self.n_views:
                continue
            r = self.render_view(v, tile)
            gt_normal = None
            if "normals" in self.data:
                pose = self.data["poses"][v].cpu().numpy()
                flip = np.asarray([1.0, -1.0, -1.0])
                gt_normal = np.einsum("ij,hwj->hwi", pose[:3, :3] * flip,
                                      self.data["normals"][v].cpu().numpy())
            rows.append(stage1_vis_strip(
                r, self.data["imgs"][v].cpu().numpy(), gt_normal,
                self.data["masks"][v].cpu().numpy()))
        strip = np.concatenate(rows, axis=0)
        imwrite(out_path, strip)
        return strip

    # --------------------------------------------------------- shape export
    @torch.no_grad()
    def shape_extract(self, out_dir: str, visibility: bool = True,
                      vis_plus: bool = False, vis_plus_num: int = 256,
                      semisphere: bool = True, tile: int = 4096,
                      n_steps: int = 512, seed: int = 0,
                      vis_steps: int = 128) -> dict:
        """Export every view's surface points, normals and mask [H, W, ...]
        (points/, normal/, mask/ .npy) for stage 2; with `visibility`, the
        visibility toward each SDPS-estimated light (rotated into the world
        frame) of every pixel, 1 off the surface (visibility/); with
        `vis_plus`, also toward vis_plus_num farthest-point-sampled
        directions of 10,000 random ones from np.random.default_rng(seed)
        (on the half sphere facing the camera with `semisphere`), listed in
        vis_plus/light_dir.json.

        Faithful protocol: vis_steps samples on [0.1, 3.5] per light ray.
        Visibility runs only on the surface pixels, compacted into tiles,
        and is scattered back on the host. .npy writes run on one
        background thread. Returns the seconds of each leg summed over the
        views: warmup_s (the first march tile and one light), fps_s,
        march_s, vis_train_s, vis_plus_s (device legs, each ending in one
        read back), host_s (scatter and writes, on the thread) and
        host_tail_s (what the writes add after the last device leg)."""
        cfg = self.cfg
        dev = self.device
        data = load_stage1_data(
            self.scene, "all", cfg.inten_normalize, cfg.train_view,
            cfg.train_light, False, cfg.render.white_background,
            normal_loss=False, mask_valid=False, device=dev)
        h, w = data["imgs"].shape[1:3]
        pix = _row_major_pixels(h, w, dev)
        n = pix.shape[0]
        pix = torch.cat([pix, pix.new_zeros(((-n) % tile, 2))])
        subs = ["points", "normal", "mask"] + (
            ["visibility"] if visibility else []) + (
            ["vis_plus"] if vis_plus else [])
        for sub in subs:
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        light_pred = (world_lights(self.scene, cfg, data["views"])
                      if visibility else None)
        occ_fn = self._occ_fn()
        vis_occ = occ_fn or (lambda p: occ_alpha(self.field, p, cfg.field))
        march = lambda pix_tile, pose: render_shape_extract(
            self.field, cfg.field, cfg.render, pix_tile, data["K"], pose,
            n_steps=n_steps, occ_fn=occ_fn)
        vis = lambda pts, dirs: light_visibility(vis_occ, pts, dirs,
                                                 n_steps=vis_steps)

        timings = dict.fromkeys(("warmup_s", "fps_s", "march_s",
                                 "vis_train_s", "vis_plus_s", "host_s"), 0.0)
        poses_np = data["poses"].cpu().numpy()
        t0 = time.time()
        march(pix[:tile], data["poses"][0])
        if visibility:
            vis(pix.new_zeros((tile, 3)),
                torch.tensor([[0.0, 0.0, 1.0]], device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["warmup_s"] = time.time() - t0

        writer = ThreadPoolExecutor(max_workers=1)
        host_s = [0.0]
        pending_writes = []

        def submit_host(fn):
            def run():
                t = time.time()
                fn()
                host_s[0] += time.time() - t
            pending_writes.append(writer.submit(run))
            while len(pending_writes) > 4:   # bound the queued arrays
                pending_writes.pop(0).result()

        rng = np.random.default_rng(seed)
        vis_plus_json = {}
        for v, vi in enumerate(data["views"]):
            name = f"view_{vi + 1:02d}"
            segments = []                       # (dirs, timing key, subdir)
            if visibility:
                segments.append((light_pred[v], "vis_train_s", "visibility"))
                if vis_plus:
                    t0 = time.time()
                    cand = rng.normal(size=(10000, 3))
                    cand /= np.linalg.norm(cand, axis=-1, keepdims=True)
                    if semisphere:
                        cand = cand[(cand * poses_np[v][:3, 2]).sum(-1) < 0]
                    idx = farthest_point_sampling_np(
                        cand, vis_plus_num, start=int(rng.integers(len(cand))))
                    extra = cand[idx].astype(np.float32)
                    vis_plus_json[name] = extra.tolist()
                    timings["fps_s"] += time.time() - t0
                    segments.append((extra, "vis_plus_s", "vis_plus"))

            # pass 1: march and normals over all pixels, one read back
            t0 = time.time()
            pose = data["poses"][v]
            outs = [march(pix[s:s + tile], pose)
                    for s in range(0, pix.shape[0], tile)]
            pts_dev = torch.cat([o["points"] for o in outs])[:n]
            points, normal, mask = (
                torch.cat([o[k] for o in outs])[:n].cpu().numpy()
                for k in ("points", "normal", "mask"))
            points = points.reshape(h, w, 3)
            normal = normal.reshape(h, w, 3)
            mask = mask.reshape(h, w)
            timings["march_s"] += time.time() - t0

            def save_geo(points=points, normal=normal, mask=mask, name=name):
                for sub, arr in (("points", points), ("normal", normal),
                                 ("mask", mask)):
                    np.save(os.path.join(out_dir, sub, name + ".npy"), arr)

            submit_host(save_geo)
            if not visibility:
                continue
            # pass 2: visibility of the surface pixels only, compacted into
            # tiles (padded with pixel 0) and scattered back on the host;
            # off the surface the visibility is 1
            surf_idx = np.nonzero(mask.reshape(-1))[0]
            n_surf = len(surf_idx)
            vpad = (-n_surf) % tile if n_surf else tile
            idx_dev = torch.as_tensor(
                np.concatenate([surf_idx, np.zeros((vpad,), np.int64)]),
                device=dev)
            for dirs, tkey, sub in segments:
                t0 = time.time()
                ldir = torch.as_tensor(dirs, device=dev)
                vis_c = torch.cat(
                    [vis(pts_dev[idx_dev[s:s + tile]], ldir)
                     for s in range(0, n_surf + vpad, tile)],
                    dim=1)[:, :n_surf].cpu().numpy()
                timings[tkey] += time.time() - t0

                def scatter_save(vis_c=vis_c, n_l=len(dirs), sub=sub,
                                 name=name, surf_idx=surf_idx):
                    full = np.ones((n_l, n), np.float32)
                    full[:, surf_idx] = vis_c
                    np.save(os.path.join(out_dir, sub, name + ".npy"),
                            full.reshape(-1, h, w))

                submit_host(scatter_save)
        t0 = time.time()
        for f in pending_writes:
            f.result()                          # raise the writers' errors
        writer.shutdown(wait=True)
        timings["host_s"] = host_s[0]
        timings["host_tail_s"] = time.time() - t0
        if vis_plus:
            with open(os.path.join(out_dir, "vis_plus", "light_dir.json"),
                      "w") as f:
                json.dump(vis_plus_json, f, indent=4)
        print(f"[shape_extract] leg breakdown (s): {timings}")
        return timings
