"""Stage-2 runner (counterpart of psnerf_tpu/runners/stage2.py): joint
SVBRDF, normal, visibility and light training, and the eval modes.

Loads the scene, the stage-1 shape export and the light table, resumes the
newest checkpoint (params and optimizer state), trains step by step on its
device, and renders every test view under every light with the frame
renderer (on a CUDA device through the fused_vis kernels). Losses stay on
the device between logs: the only reads back to the host are at log time.
Envmap relighting and material edits come with a later slice.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from psnerf_torch.config import Stage2Config
from psnerf_torch.data.scene import imwrite, load_scene_params
from psnerf_torch.data.stage2 import (decode_imgs, load_stage2_data,
                                      sample_stage2_batch)
from psnerf_torch.device import resolve_device
from psnerf_torch.eval.frame import render_frame_stage2
from psnerf_torch.eval.metrics import mae, psnr
from psnerf_torch.fields.psnet import init_psnet
from psnerf_torch.render.shading import draw_psnet_noise
from psnerf_torch.train.checkpoints import (latest_checkpoint,
                                            load_checkpoint, load_tree,
                                            save_checkpoint)
from psnerf_torch.train.logging import MetricLogger
from psnerf_torch.train.stage2 import (init_stage2_params,
                                       light_direction_error_deg,
                                       make_stage2_train_step)

_to8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)


class Stage2Runner:
    def __init__(self, cfg: Stage2Config, workdir: str, seed: int = 0,
                 resume: bool = True, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        os.makedirs(workdir, exist_ok=True)
        self.scene = load_scene_params(cfg.data_dir)
        self.data = load_stage2_data(
            self.scene, cfg.stage1_shape_path, "train", cfg.inten_normalize,
            cfg.train_view, cfg.train_light, cfg.all_view,
            vis_loss=cfg.vis_loss, vis_plus=cfg.vis_plus,
            image_store=cfg.image_store, device=self.device)
        self.n_views = len(self.data["views"])
        self.light_count = np.asarray(self.data["light_count"])
        self.light_bs = min(cfg.light_bs, int(self.light_count.min()))
        total = self.data["imgs"].shape[2]
        self.num_pixels = min(total if cfg.train_all_pixels
                              else cfg.num_pixels, total)

        # ---- light table init (trainer.py:132-163) ----
        cnt = self.light_count
        slt = self.data["light_slt"]
        if cfg.train.light_train and cfg.light_init == "pred":
            sdps_dir = self.scene.sdps_dir(cfg.inten_normalize, cfg.train_light)
            lp = np.load(os.path.join(sdps_dir, "light_direction_pred.npy"),
                         allow_pickle=True)[self.data["views"]]
            dirs0 = np.concatenate([
                np.einsum("ij,kj->ki", self.data["pose_gl"][i, :3, :3],
                          np.asarray(lp[i])[slt[i, : cnt[i]]])
                for i in range(self.n_views)]).astype(np.float32)
        else:
            ld = self.data["light_dirs"].cpu().numpy()
            dirs0 = np.concatenate(
                [ld[i, : cnt[i]] for i in range(self.n_views)]
            ).astype(np.float32)
        if cfg.train.light_inten_train and cfg.light_inten_init == "pred":
            sdps_dir = self.scene.sdps_dir(cfg.inten_normalize, cfg.train_light)
            ip = np.load(os.path.join(sdps_dir, "light_intensity_pred.npy"),
                         allow_pickle=True)[self.data["views"]]
            ints0 = np.concatenate([
                np.asarray(ip[i])[slt[i, : cnt[i]]]
                for i in range(self.n_views)]).reshape(-1, 1).astype(np.float32)
        else:
            ints0 = np.full((len(dirs0), 1), cfg.net.light_int, np.float32)

        # the initial directions, unit and padded to [V, Lmax, 3] (+z on
        # padding), are the visibility net's supervision lights
        init_pad = np.zeros((self.n_views, int(cnt.max()), 3), np.float32)
        init_pad[..., 2] = 1.0
        off = 0
        for i in range(self.n_views):
            d = dirs0[off:off + cnt[i]]
            init_pad[i, : cnt[i]] = d / np.linalg.norm(d, axis=-1,
                                                       keepdims=True)
            off += cnt[i]
        self.light_init_dirs = torch.as_tensor(init_pad, device=self.device)
        # the dataset directions in the table's row order: the light error
        ld = self.data["light_dirs"].cpu().numpy()
        self._gt_dirs_flat = torch.as_tensor(
            np.concatenate([ld[i, : cnt[i]] for i in range(self.n_views)]),
            device=self.device)

        gen = torch.Generator().manual_seed(seed)
        model = init_psnet(cfg.net, generator=gen, device=self.device)
        self.params = init_stage2_params(model, dirs0, ints0, self.device)
        # milestones: epochs x views x light_bs iterations
        tcfg = cfg.train
        if cfg.sched_milestones_epochs:
            tcfg = dataclasses.replace(tcfg, milestone_iters=tuple(
                int(m) * self.n_views * self.light_bs
                for m in cfg.sched_milestones_epochs))
        self.tcfg = tcfg
        init_opt, self.step_fn = make_stage2_train_step(cfg.net, tcfg)
        self.opt_state = init_opt(self.params)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.it = 0
        self._eval_data_cache = {}
        self.ckpt_dir = os.path.join(workdir, "checkpoints")
        if resume:
            ck = latest_checkpoint(self.ckpt_dir)
            if ck:
                flat, scalars = load_checkpoint(ck)
                self.params = load_tree(self.params, flat, "params/")
                self.opt_state = load_tree(self.opt_state, flat, "opt/")
                self.it = int(scalars.get("it", 0))
                print(f"resumed from {ck} at it={self.it}")
        self.logger = MetricLogger(os.path.join(workdir, "metrics.jsonl"))

    # ------------------------------------------------------------- training
    def sample(self):
        """One step's batch and jitter draws, from the runner's generator on
        its device: a view, then the sampler's lights, pixels and vis_plus
        rows. Without vis_plus the visibility net is supervised on the
        initial directions of the step's lights."""
        cfg, dev, gen = self.cfg, self.device, self.generator
        view = torch.randint(0, self.n_views, (1,), generator=gen, device=dev)
        use_vp = cfg.vis_plus and "vis_plus" in self.data
        batch = sample_stage2_batch(
            self.data, view, gen, self.num_pixels, self.light_bs,
            sample_in_mask=cfg.sample_in_mask,
            vis_train_num=cfg.vis_train_num,
            light_init_dirs=self.light_init_dirs if use_vp else None)
        if not use_vp:
            init = torch.index_select(self.light_init_dirs, 0, view)[0]
            batch["light_vis_train"] = init[batch["lidx"]]
        return batch, draw_psnet_noise(self.num_pixels, gen, dev)

    def train(self, max_iters: int, log_every: int = 100,
              ckpt_every: int | None = None, on_log=None,
              wall_budget_s: float | None = None,
              plot_every: int | None = None):
        """Train until `it` reaches max_iters, logging every log_every steps
        (a non-finite loss since the last log halts the run, naming its
        iteration) and writing the rolling checkpoint every ckpt_every steps
        (default cfg.ckpt_freq) and at the end. plot_every: write the
        train/test comparison grid plots/it_<it>.png whenever `it` > 0 is a
        multiple of it. wall_budget_s: once this many seconds have passed,
        checkpoint and return (a later call resumes)."""
        ckpt_every = ckpt_every or self.cfg.ckpt_freq
        losses = []
        t_start = t0 = time.time()
        while self.it < max_iters:
            if (wall_budget_s is not None
                    and time.time() - t_start > wall_budget_s):
                self.save(self.it)
                print(f"[stage2] wall budget reached at it={self.it}; "
                      "checkpointed for resume")
                return self
            if plot_every and self.it > 0 and self.it % plot_every == 0:
                self.plot_to_disk(os.path.join(self.workdir, "plots",
                                               f"it_{self.it}.png"))
            batch, noise = self.sample()
            terms = self.step_fn(self.params, self.opt_state, batch, self.it,
                                 noise)
            losses.append(terms["loss"])
            self.it += 1
            if self.it % log_every == 0:
                vals = torch.stack(losses).cpu()
                terms = {k: float(v) for k, v in terms.items()}
                if not torch.isfinite(vals).all():
                    bad = self.it - len(losses) + 1 + int(
                        torch.nonzero(~torch.isfinite(vals))[0, 0])
                    raise FloatingPointError(
                        f"non-finite loss at it={bad}: {terms}")
                losses = []
                lderr = float(light_direction_error_deg(
                    self.params["light_dirs"], self._gt_dirs_flat))
                mse2psnr = lambda x: -10.0 * np.log(x + 1e-8) / np.log(10.0)
                dt = time.time() - t0
                print(f"[stage2 it {self.it}] loss={terms['loss']:.5f} "
                      f"rgb={terms['sg_rgb_loss']:.5f} "
                      f"psnr={mse2psnr(terms['sg_rgb_loss']):.2f} "
                      f"vis={terms.get('vis_loss', 0.0):.4f} "
                      f"normal={terms.get('normal_loss', 0.0):.4f} "
                      f"ld_err={lderr:.2f}deg {log_every / dt:.1f} it/s")
                terms["light_direction_error"] = lderr
                self.logger.log(self.it, terms)
                if on_log:
                    on_log(self.it, terms)
                t0 = time.time()
            if self.it % ckpt_every == 0 or self.it == max_iters:
                self.save(self.it)
        return self

    def save(self, it: int, backup_every_n_ckpts: int = 10) -> str:
        """Write the params, the optimizer state and `it` to the rolling
        checkpoint, and to a numbered one every ckpt_freq x
        backup_every_n_ckpts steps."""
        tree = {"params": self.params, "opt": self.opt_state}
        path = os.path.join(self.ckpt_dir, "model.npz")
        save_checkpoint(path, tree, {"it": it})
        if it > 0 and it % (self.cfg.ckpt_freq * backup_every_n_ckpts) == 0:
            save_checkpoint(os.path.join(self.ckpt_dir, f"model_{it}.npz"),
                            tree, {"it": it})
        return path

    def plot_to_disk(self, out_path: str, train_view: int = 0,
                     light: int = 0, tile: int = 4096) -> dict:
        """Train-view and test-view comparison grid (prediction | ground
        truth | normal, one row each) under one light, with each row's PSNR
        and normal MAE logged and returned."""
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        rows, stats = [], {}
        for split, view in (("train", train_view), ("test", 0)):
            try:
                data = self._eval_data(split)
            except FileNotFoundError:
                continue
            dirs, ints = self.trained_lights_for_view(data, view)
            r = self.render_view(data, view, dirs[:light + 1],
                                 ints[:light + 1], tile,
                                 outputs=("rgb", "normal_pred"))
            h, w = data["img_res"]
            pred = r["rgb"][light]
            gt = decode_imgs(data["imgs"][view][light]).cpu().numpy()
            gt = gt.reshape(h, w, 3) + (1.0 - r["mask"][..., None])
            normal = r.get("normal_pred",
                           r["normal_values"][None])[..., :3].reshape(h, w, 3)
            rows.append(np.concatenate([pred, gt, normal / 2 + 0.5], axis=1))
            m = r["mask"] & data["object_masks"][view].cpu().numpy() \
                .reshape(h, w)
            stats[f"{split}_psnr"] = round(psnr(pred, gt, m), 2)
            gt_n = data["gt_normal"][view].cpu().numpy().reshape(h, w, 3)
            if np.abs(gt_n).sum() > 0:
                stats[f"{split}_normal_mae"] = round(
                    mae(normal, gt_n, m)[0], 2)
        imwrite(out_path, _to8(np.concatenate(rows, axis=0)))
        self.logger.log(self.it, stats)
        print(f"[stage2 plot] {out_path} {stats}")
        return stats

    # ------------------------------------------------------------ rendering
    def _eval_data(self, split: str):
        if split == "train":
            return self.data
        cache = self._eval_data_cache
        if split not in cache:
            cache[split] = load_stage2_data(
                self.scene, self.cfg.stage1_shape_path, split,
                self.cfg.inten_normalize, self.cfg.train_view,
                self.cfg.train_light, self.cfg.all_view,
                vis_loss=False, vis_plus=False,
                image_store=self.cfg.image_store, device=self.device)
        return cache[split]

    @torch.no_grad()
    def render_view(self, data, view: int, light_dirs, light_ints,
                    tile: int = 4096, outputs=("rgb", "albedo", "rough",
                                               "visibility", "normal_pred"),
                    use_fused_vis: bool | None = None,
                    compact: bool | None = None):
        """All lights x all pixels of one view, as host arrays
        {name: [L, H, W, C] or [H, W, C]} plus mask and normal_values.

        use_fused_vis: route the visibility MLP through the CUDA kernels
        (auto: on when the device is CUDA and the net has visibility).
        compact: render only the surface-mask pixels (padded to the tile)
        and scatter the results back with the reference's fill values
        (auto: on when mask coverage < 0.6). Per-pixel math is independent,
        so outputs are identical."""
        cfg = self.cfg.net
        if use_fused_vis is None:
            use_fused_vis = self.device.type == "cuda" and cfg.visibility
        dev = self.device
        h, w = data["img_res"]
        n = h * w
        mask_np = data["surface_mask"][view].cpu().numpy().reshape(-1) > 0
        if compact is None:
            compact = mask_np.mean() < 0.6
        ys, xs = np.mgrid[0:h, 0:w]
        uv = torch.as_tensor(np.stack([xs, ys], -1).reshape(-1, 2)
                             .astype(np.float32), device=dev)

        if compact:
            sel = np.where(mask_np)[0]
            n_out = sel.shape[0]
            pad = (-n_out) % tile
            sel_dev = torch.as_tensor(
                np.concatenate([sel, np.zeros((pad,), sel.dtype)]), device=dev)
            gather = lambda x, fill=None: x[sel_dev]
            mask_in = torch.ones((n_out + pad,), dtype=torch.bool, device=dev)
        else:
            n_out = n
            pad = (-n) % tile

            def gather(x, fill=0.0):
                if pad == 0:
                    return x
                tail = torch.full((pad,) + tuple(x.shape[1:]), fill,
                                  dtype=x.dtype, device=x.device)
                return torch.cat([x, tail], dim=0)

            mask_in = gather(data["surface_mask"][view], False)

        avail = {"rgb", "rgb_sum", "albedo", "rough", "sg_weight",
                 "visibility"}
        if cfg.normal_mlp:
            avail.add("normal_pred")
        if not cfg.visibility:
            avail.discard("visibility")
        outs = tuple(o for o in outputs if o in avail)
        f32 = torch.float32
        out = render_frame_stage2(
            self.params["model"], cfg, gather(uv), data["poses"][view],
            data["K"], gather(data["points"][view]),
            gather(data["normals"][view]), mask_in,
            torch.as_tensor(np.asarray(light_dirs), dtype=f32, device=dev),
            torch.as_tensor(np.asarray(light_ints), dtype=f32, device=dev),
            tile=tile, outputs=outs, use_fused_vis=use_fused_vis)
        res = {}
        # reference fill values outside the surface mask: ones everywhere
        # except sg_weight; rgb_sum's per-light ones sum to L
        fills = {"sg_weight": 0.0, "rgb_sum": float(len(light_dirs))}
        for k, v in out.items():
            v = v.cpu().numpy()
            if compact:
                full_shape = ((v.shape[0], n) + v.shape[2:] if v.ndim == 3
                              else (n,) + v.shape[1:])
                full = np.full(full_shape, fills.get(k, 1.0), v.dtype)
                if v.ndim == 3:
                    full[:, sel] = v[:, :n_out]
                else:
                    full[sel] = v[:n_out]
                v = full
            if v.ndim == 3:
                res[k] = v[:, :n].reshape(v.shape[0], h, w, -1)
            else:
                res[k] = v[:n].reshape(h, w, -1)
        res["mask"] = mask_np.reshape(h, w)
        res["normal_values"] = data["normals"][view].cpu().numpy().reshape(
            h, w, 3)
        return res

    def trained_lights_for_view(self, data, view: int):
        """Trained light-table rows for a view (the dataset dirs when the
        split's view was not trained)."""
        cfg = self.cfg
        vi = data["views"][view]
        if cfg.train.light_train and vi in set(self.data["views"].tolist()):
            local = int(np.where(self.data["views"] == vi)[0][0])
            off = int(self.data["light_row_offset"][local])
            ln = int(self.data["light_count"][local])
            dirs = self.params["light_dirs"][off:off + ln].cpu().numpy()
            dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
            ints = self.params["light_ints"][off:off + ln, 0].cpu().numpy()
            return dirs, ints
        ln = int(data["light_count"][view])
        dirs = data["light_dirs"][view][:ln].cpu().numpy()
        ints = np.full((dirs.shape[0],), cfg.net.light_int, np.float32)
        return dirs, ints

    # ----------------------------------------------------------- eval modes
    def evaluate(self, out_dir: str, split: str = "test", tile: int = 4096,
                 save_npy: bool = True):
        """Standard eval: per view, every light (the reference's
        stage2/eval.py output tree: rgb/img/view_XX/LLL.png, mask/img,
        normal/npy, ...)."""
        data = self._eval_data(split)
        for sub in ["rgb", "normal", "albedo", "rough", "mask", "visibility"]:
            os.makedirs(os.path.join(out_dir, sub, "img"), exist_ok=True)
            os.makedirs(os.path.join(out_dir, sub, "npy"), exist_ok=True)
        for v, vi in enumerate(data["views"]):
            dirs, ints = self.trained_lights_for_view(data, v)
            r = self.render_view(data, v, dirs, ints, tile)
            name = f"view_{vi + 1:02d}"
            for key, sub in (("rgb", "rgb"), ("visibility", "visibility"),
                             ("rough", "rough")):
                if key not in r:
                    continue
                d = os.path.join(out_dir, sub, "img", name)
                os.makedirs(d, exist_ok=True)
                for li in range(r[key].shape[0]):
                    img = r[key][li]
                    if key == "visibility":
                        img = np.repeat(img, 3, -1)
                    imwrite(os.path.join(d, f"{li + 1:03d}.png"),
                                    _to8(img))
            mask = r["mask"]
            imwrite(os.path.join(out_dir, "mask", "img", name + ".png"),
                            _to8(mask.astype(np.float64)))
            normal = (r.get("normal_pred", r["normal_values"])
                      .reshape(*mask.shape, 3) * mask[..., None])
            np.save(os.path.join(out_dir, "normal", "npy", name + ".npy"),
                    normal.astype(np.float32))
            imwrite(os.path.join(out_dir, "normal", "img",
                                         name + ".png"),
                            _to8(normal / 2 + 0.5))
            imwrite(os.path.join(out_dir, "albedo", "img",
                                         name + ".png"),
                            _to8(r["albedo"].reshape(*mask.shape, 3)))
            if save_npy:
                npy = lambda sub: os.path.join(out_dir, sub, "npy",
                                               name + ".npy")
                np.save(npy("rgb"), r["rgb"].astype(np.float32))
                np.save(npy("mask"), mask.astype(bool))
                np.save(npy("albedo"), r["albedo"].astype(np.float32))
                if "rough" in r:
                    np.save(npy("rough"), r["rough"].astype(np.float32))
                if "visibility" in r:
                    # the saved visibility artifact is clipped to [0, 1]
                    np.save(npy("visibility"),
                            r["visibility"][..., 0].clip(0, 1)
                            .astype(np.float32))
