"""Stage-2 runner (counterpart of psnerf_tpu/runners/stage2.py): joint
SVBRDF, normal, visibility and light training, and the eval modes.

Loads the scene, the stage-1 shape export and the light table, resumes the
newest checkpoint (params and optimizer state), trains step by step on its
device, and renders every test view under every light with the frame
renderer (on a CUDA device through the fused_vis kernels). Losses stay on
the device between logs: the only reads back to the host are at log time.

Relighting under an environment map (render_envmap) sums the light
kernel's per-pixel light sums over chunks of 128 envmap texels, each a
directional light with per-channel intensities; material edits
(edit_material) render the trained lights with an albedo or SG-basis
override, through the visibility kernel's precompute and plain shading.

Under a mesh (psnerf_torch.parallel, one process a device) every rank
holds the parameters, the light tables and the optimizer state whole,
draws each step's batch and jitter whole from its identically seeded
generator and trains on its block (its pixels; on a rays x lights mesh
also its lights), with one gradient all-reduce a step. render_view, and
with it evaluate, render_envmap and edit_material, splits each frame the
same way and gathers it on every rank. Only rank 0 writes files.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from psnerf_torch.config import Stage2Config
from psnerf_torch.core.spherical import gen_light_xyz, vis_light_probe
from psnerf_torch.data.envmap import load_envmap  # noqa: F401  (API)
from psnerf_torch.data.scene import imwrite, load_scene_params
from psnerf_torch.data.stage2 import (decode_imgs, load_stage2_data,
                                      sample_stage2_batch)
from psnerf_torch.device import resolve_device
from psnerf_torch.eval.frame import render_frame_stage2
from psnerf_torch.eval.metrics import mae, psnr
from psnerf_torch.fields.psnet import init_psnet
from psnerf_torch.parallel.mesh import (LIGHT_AXIS, RAY_AXIS, barrier,
                                        rank0_flag, rank_tile,
                                        replicate, say, shard_noise,
                                        shard_stage2_batch, writes)
from psnerf_torch.parallel.sharded_render import make_sharded_frame_renderer
from psnerf_torch.render.shading import draw_psnet_noise
from psnerf_torch.train.checkpoints import (latest_checkpoint,
                                            load_checkpoint, load_tree,
                                            save_checkpoint)
from psnerf_torch.train.logging import MetricLogger
from psnerf_torch.train.stage2 import (init_stage2_params,
                                       light_direction_error_deg,
                                       make_stage2_train_step)
from psnerf_torch.utils import profiling

_to8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)
ENV_CHUNK = 128      # envmap lights a render (the JAX package's chunking)


class Stage2Runner:
    def __init__(self, cfg: Stage2Config, workdir: str, seed: int = 0,
                 resume: bool = True, device: str | torch.device = "cuda",
                 mesh=None):
        """mesh: a mesh (psnerf_torch.parallel.make_mesh, or make_mesh_2d
        for rays x lights) to train and render data-parallel over its
        ranks, on mesh.device: num_pixels must be divisible by its ray
        ranks, and on a 2-D mesh light_bs by its light ranks."""
        self.cfg = cfg
        self.workdir = workdir
        self.mesh = mesh
        self.writes = writes(mesh)
        if mesh is not None:
            device = mesh.device
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
        if mesh is not None:
            for what, n, axis in (("num_pixels", self.num_pixels, RAY_AXIS),
                                  ("light_bs", self.light_bs, LIGHT_AXIS)):
                if n % mesh.shape[axis]:
                    raise ValueError(f"{what}={n} not divisible by the "
                                     f"mesh's {mesh.shape[axis]} {axis} "
                                     "ranks")

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
        init_opt, self.step_fn = make_stage2_train_step(cfg.net, tcfg, mesh)
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
                say(mesh, f"resumed from {ck} at it={self.it}")
        if mesh is not None:
            replicate(self.params, mesh)
            replicate(self.opt_state, mesh)
        self.logger = (MetricLogger(os.path.join(workdir, "metrics.jsonl"))
                       if self.writes else None)

    # ------------------------------------------------------------- training
    def sample(self):
        """One step's batch and jitter draws, from the runner's generator on
        its device: a view, then the sampler's lights, pixels and vis_plus
        rows. Without vis_plus the visibility net is supervised on the
        initial directions of the step's lights. Whole, on every rank of a
        mesh."""
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
        mesh = self.mesh
        while self.it < max_iters:
            if wall_budget_s is not None and rank0_flag(
                    time.time() - t_start > wall_budget_s, mesh,
                    self.device):
                with profiling.span("stage2.checkpoint"):
                    self.save(self.it)
                say(mesh, f"[stage2] wall budget reached at it={self.it}; "
                    "checkpointed for resume")
                return self
            with profiling.span("stage2.step"):
                if plot_every and self.it > 0 and self.it % plot_every == 0:
                    with profiling.span("stage2.plot"):
                        self.plot_to_disk(os.path.join(
                            self.workdir, "plots", f"it_{self.it}.png"))
                with profiling.span("stage2.sample"):
                    batch, noise = self.sample()
                    if mesh is not None:
                        batch = shard_stage2_batch(batch, mesh)
                        noise = shard_noise(noise, mesh)
                terms = self.step_fn(self.params, self.opt_state, batch,
                                     self.it, noise)
                losses.append(terms["loss"])
                self.it += 1
                if self.it % log_every == 0:
                    with profiling.span("stage2.log"):
                        self._log(losses, terms, log_every,
                                  time.time() - t0, on_log)
                    losses = []
                    t0 = time.time()
                if self.it % ckpt_every == 0 or self.it == max_iters:
                    with profiling.span("stage2.checkpoint"):
                        self.save(self.it)
        return self

    def _log(self, losses, terms, log_every, dt, on_log):
        """Read the losses since the last log back (a non-finite one halts
        the run, naming its iteration), print and log the step's terms and
        the light direction error."""
        vals = torch.stack(losses).cpu()
        terms = {k: float(v) for k, v in terms.items()}
        if not torch.isfinite(vals).all():
            bad = self.it - len(losses) + 1 + int(
                torch.nonzero(~torch.isfinite(vals))[0, 0])
            raise FloatingPointError(
                f"non-finite loss at it={bad}: {terms}")
        lderr = float(light_direction_error_deg(
            self.params["light_dirs"], self._gt_dirs_flat))
        mse2psnr = lambda x: -10.0 * np.log(x + 1e-8) / np.log(10.0)
        say(self.mesh, f"[stage2 it {self.it}] loss={terms['loss']:.5f} "
            f"rgb={terms['sg_rgb_loss']:.5f} "
            f"psnr={mse2psnr(terms['sg_rgb_loss']):.2f} "
            f"vis={terms.get('vis_loss', 0.0):.4f} "
            f"normal={terms.get('normal_loss', 0.0):.4f} "
            f"ld_err={lderr:.2f}deg {log_every / dt:.1f} it/s")
        terms["light_direction_error"] = lderr
        if self.logger:
            self.logger.log(self.it, terms)
        if on_log:
            on_log(self.it, terms)

    def save(self, it: int, backup_every_n_ckpts: int = 10) -> str:
        """Write the params, the optimizer state and `it` to the rolling
        checkpoint, and to a numbered one every ckpt_freq x
        backup_every_n_ckpts steps (rank 0 of a mesh writes; every rank
        returns once it has)."""
        tree = {"params": self.params, "opt": self.opt_state}
        path = os.path.join(self.ckpt_dir, "model.npz")
        if self.writes:
            save_checkpoint(path, tree, {"it": it})
            if it > 0 and it % (self.cfg.ckpt_freq
                                * backup_every_n_ckpts) == 0:
                save_checkpoint(os.path.join(self.ckpt_dir,
                                             f"model_{it}.npz"),
                                tree, {"it": it})
        barrier(self.mesh)
        return path

    def plot_to_disk(self, out_path: str, train_view: int = 0,
                     light: int = 0, tile: int = 4096) -> dict:
        """Train-view and test-view comparison grid (prediction | ground
        truth | normal, one row each) under one light, with each row's PSNR
        and normal MAE logged and returned (rank 0 of a mesh writes)."""
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
        if self.writes:
            os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                        exist_ok=True)
            imwrite(out_path, _to8(np.concatenate(rows, axis=0)))
            self.logger.log(self.it, stats)
        barrier(self.mesh)
        say(self.mesh, f"[stage2 plot] {out_path} {stats}")
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
    @profiling.spanned("render_view")
    def render_view(self, data, view: int, light_dirs, light_ints,
                    tile: int = 4096, outputs=("rgb", "albedo", "rough",
                                               "visibility", "normal_pred"),
                    use_fused_vis: bool | None = None,
                    compact: bool | None = None,
                    albedo_new=None, basis_new: int | None = None):
        """All lights x all pixels of one view, as host arrays
        {name: [L, H, W, C] or [H, W, C]} plus mask and normal_values.
        light_ints: [L] or per-channel [L, 3]. albedo_new / basis_new:
        material edits (render_frame_stage2).

        use_fused_vis: route the visibility MLP through the CUDA kernels
        (auto: on when the device is CUDA and the net has visibility).
        compact: render only the surface-mask pixels (padded to the tile)
        and scatter the results back with the reference's fill values
        (auto: on when mask coverage < 0.6). Per-pixel math is independent,
        so outputs are identical.

        Under a mesh each ray rank renders its block of the (padded)
        pixels in tiles of tile // ray ranks, and on a rays x lights mesh
        its block of the lights (their count must divide by the light
        ranks); every rank returns the whole frame."""
        cfg = self.cfg.net
        if use_fused_vis is None:
            use_fused_vis = self.device.type == "cuda" and cfg.visibility
        dev = self.device
        span = profiling.span
        h, w = data["img_res"]
        n = h * w

        with span("render_view.prepare"):
            mask_np = profiling.to_host(
                data["surface_mask"][view]).reshape(-1) > 0
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
                    np.concatenate([sel, np.zeros((pad,), sel.dtype)]),
                    device=dev)
                gather = lambda x, fill=None: x[sel_dev]
                mask_in = torch.ones((n_out + pad,), dtype=torch.bool,
                                     device=dev)
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
            args = (self.params["model"], gather(uv), data["poses"][view],
                    data["K"], gather(data["points"][view]),
                    gather(data["normals"][view]), mask_in,
                    torch.as_tensor(np.asarray(light_dirs), dtype=f32,
                                    device=dev),
                    torch.as_tensor(np.asarray(light_ints), dtype=f32,
                                    device=dev))
        kw = dict(outputs=outs, use_fused_vis=use_fused_vis,
                  albedo_new=albedo_new, basis_new=basis_new)
        mesh = self.mesh
        with span("render_view.frame"):
            if mesh is None:
                out = render_frame_stage2(args[0], cfg, *args[1:], tile=tile,
                                          **kw)
            else:
                out = make_sharded_frame_renderer(
                    cfg, mesh, tile=rank_tile(tile, mesh), **kw)(*args)
        res = {}
        # reference fill values outside the surface mask: ones everywhere
        # except sg_weight; rgb_sum's per-light ones sum to L
        fills = {"sg_weight": 0.0, "rgb_sum": float(len(light_dirs))}
        for k, v in out.items():
            with span("render_view.copy"):
                v = profiling.to_host(v)
            with span("render_view.scatter"):
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
        with span("render_view.copy"):
            res["normal_values"] = profiling.to_host(
                data["normals"][view]).reshape(h, w, 3)
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
        normal/npy, ...); rank 0 of a mesh writes."""
        data = self._eval_data(split)
        for sub in ["rgb", "normal", "albedo", "rough", "mask", "visibility"]:
            for kind in ("img", "npy") if self.writes else ():
                os.makedirs(os.path.join(out_dir, sub, kind), exist_ok=True)
        for v, vi in enumerate(data["views"]):
            dirs, ints = self.trained_lights_for_view(data, v)
            r = self.render_view(data, v, dirs, ints, tile)
            if not self.writes:
                continue
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
        barrier(self.mesh)

    def render_envmap(self, out_dir: str, envmap: np.ndarray,
                      split: str = "test", light_h: int = 16,
                      gamma: float = 1.0, envmap_scale: float = 1.0,
                      tile: int = 4096):
        """Relight every view of a split under a lat-long envmap [light_h,
        2 * light_h, 3] (stage2/eval.py:173-231): one directional light per
        texel with the texel's rgb (times envmap_scale) as per-channel
        intensity, the rgb summed over the lights in chunks of ENV_CHUNK
        (each chunk's sum on the device, one light-sum launch on the card;
        the chunks added on the host in order), clipped, gamma-mapped,
        white off the mask; writes rgb/img/view_XX.png and
        light_probe.png (rank 0 of a mesh writes)."""
        data = self._eval_data(split)
        lxyz, _ = gen_light_xyz(light_h, 2 * light_h, envmap_radius=1.0)
        dirs = lxyz.reshape(-1, 3)
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        texels = envmap.reshape(-1, 3).astype(np.float32) * envmap_scale
        if self.writes:
            os.makedirs(os.path.join(out_dir, "rgb", "img"), exist_ok=True)
            imwrite(os.path.join(out_dir, "light_probe.png"),
                    vis_light_probe(envmap * envmap_scale, light_h * 8))
        for v, vi in enumerate(data["views"]):
            acc = 0.0
            for s in range(0, len(dirs), ENV_CHUNK):
                r = self.render_view(data, v, dirs[s:s + ENV_CHUNK],
                                     texels[s:s + ENV_CHUNK], tile,
                                     outputs=("rgb_sum",))
                acc = acc + r["rgb_sum"]
            img = np.power(np.clip(acc, 0, 1), 1.0 / gamma)
            mask = r["mask"][..., None]
            img = img * mask + (1 - mask)
            if self.writes:
                imwrite(os.path.join(out_dir, "rgb", "img",
                                     f"view_{vi + 1:02d}.png"), _to8(img))
        barrier(self.mesh)
        return out_dir

    def edit_material(self, out_dir: str, split: str = "test",
                      albedo_new=None, basis_new: int | None = None,
                      tile: int = 4096):
        """Material editing (stage2/eval.py:233-312): an albedo override
        and/or a single-SG-basis swap, rendered under each view's trained
        lights through the tiled frame renderer; writes
        rgb/img/view_XX/LLL.png, one per light (rank 0 of a mesh)."""
        data = self._eval_data(split)
        if self.writes:
            os.makedirs(os.path.join(out_dir, "rgb", "img"), exist_ok=True)
        for v, vi in enumerate(data["views"]):
            dirs, ints = self.trained_lights_for_view(data, v)
            rgb = self.render_view(data, v, dirs, ints, tile=tile,
                                   outputs=("rgb",), albedo_new=albedo_new,
                                   basis_new=basis_new)["rgb"]
            if not self.writes:
                continue
            vdir = os.path.join(out_dir, "rgb", "img", f"view_{vi + 1:02d}")
            os.makedirs(vdir, exist_ok=True)
            for li in range(rgb.shape[0]):
                imwrite(os.path.join(vdir, f"{li + 1:03d}.png"),
                        _to8(rgb[li]))
        barrier(self.mesh)
        return out_dir
