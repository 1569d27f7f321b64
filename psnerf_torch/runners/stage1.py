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
its tiles on the device and reads the results back once. The export's
visibility runs the faithful, rescaled, mixed or grid-guided protocol.

Mesh extraction evaluates the MISE octree's query points through fused_occ
in batches of 2^20 points on the card (100,000 on the plain route), carves
the value grid by the training views' dilated silhouettes on the device,
marches it on the host, optionally refines the vertices against the field
and writes OBJ or PLY.

Under a mesh (psnerf_torch.parallel, one process a device) every rank
holds the field and the optimizer state whole, draws each step's batch and
noise whole from its identically seeded generator and trains on its block
of the rays (one gradient all-reduce a step); the eval render and the
export's march split each image's pixels over the ranks, the export's
visibility its surface points and lights over a rays x lights layout. Only
rank 0 writes files (checkpoints, metrics, images, exports); the mesh
extraction runs on rank 0 alone, as the JAX package's MISE takes no mesh.
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
from psnerf_torch.mesh.extractor import (build_value_grid,
                                         make_field_value_fn,
                                         march_value_grid)
from psnerf_torch.mesh.meshio import save_obj, save_ply
from psnerf_torch.mesh.refine import (make_mask_carver, pixel_to_ndc_camera,
                                      refine_mesh)
from psnerf_torch.ops.fps import farthest_point_sampling_np
from psnerf_torch.ops.fused_occ import make_fused_occ_fn
from psnerf_torch.ops.fused_radiance import supports
from psnerf_torch.parallel.mesh import (LIGHT_AXIS, RAY_AXIS, barrier,
                                        gather_rays, rank0_flag, rank0_only,
                                        rank_tile, ray_block, replicate, say,
                                        shard_noise, shard_stage1_batch,
                                        writes)
from psnerf_torch.parallel.sharded_export import (export_vis_mesh,
                                                  make_sharded_march_fn,
                                                  make_sharded_vis_fn)
from psnerf_torch.render.marching import (light_visibility,
                                          occupancy_guide_grid)
from psnerf_torch.render.phong import phong_shade
from psnerf_torch.render.unisurf import (draw_unisurf_noise,
                                         render_shape_extract,
                                         render_unisurf)
from psnerf_torch.train.checkpoints import (latest_checkpoint,
                                            load_checkpoint, load_module,
                                            load_tree, save_checkpoint)
from psnerf_torch.train.logging import MetricLogger, _to8, stage1_vis_strip
from psnerf_torch.train.stage1 import make_stage1_train_step
from psnerf_torch.utils import profiling

# light_visibility's and occupancy_guide_grid's defaults, which the export
# runs at
VIS_NEAR, VIS_FAR, GUIDE_BOX, GUIDE_DILATE = 0.1, 3.5, 1.1, 3

def world_lights(scene, cfg: Stage1Config, views) -> list:
    """The SDPS-estimated light directions [L, 3] of each view, rotated
    from its camera frame into the world frame: the export's lights."""
    sdps_dir = scene.sdps_dir(cfg.inten_normalize, cfg.train_light)
    lp = np.load(os.path.join(sdps_dir, "light_direction_pred.npy"),
                 allow_pickle=True)[views]
    return [np.einsum("ij,kj->ki", scene.pose_gl[vi, :3, :3], lp[i])
            .astype(np.float32) for i, vi in enumerate(views)]


def check_guide_calibration(res: int, coarse: int, dilate: int = GUIDE_DILATE,
                            box: float = GUIDE_BOX, lnear: float = VIS_NEAR,
                            lfar: float = VIS_FAR) -> None:
    """Raise ValueError unless the guided march's coarse probes, at most
    (lfar - lnear) / (coarse - 1) apart along a ray, are no farther apart
    than the dilated slab of a thin occluder in a res^3 guide grid is thick,
    (2 dilate + 1) * 2 box / res: else a thin occluder can fall between two
    probes. At the defaults (64, 16): 0.227 <= 0.241."""
    spacing = (lfar - lnear) / (coarse - 1)
    slab = (2 * dilate + 1) * 2 * box / res
    if not spacing <= slab:
        raise ValueError(
            f"guide_res={res} with guide_coarse={coarse} under-covers: probe "
            f"spacing {spacing:.3f} exceeds the dilated slab {slab:.3f}; "
            "raise guide_coarse or lower guide_res")


def _row_major_pixels(h: int, w: int, device) -> torch.Tensor:
    """Pixel coordinates [h * w, 2] (x, y), row-major."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(-1, 2).float()


class Stage1Runner:
    def __init__(self, cfg: Stage1Config, workdir: str, seed: int = 0,
                 resume: bool = True, use_fused_occ: bool | None = None,
                 use_fused_radiance: bool | None = None,
                 device: str | torch.device = "cuda", mesh=None):
        """use_fused_occ / use_fused_radiance: None = on when the device is
        CUDA (the radiance kernels also need `supports(cfg.field)`: their
        layout takes the default OccFieldConfig() in either operand
        form). mesh: a 1-D mesh (psnerf_torch.parallel.make_mesh) to train,
        render and export data-parallel over its ranks, on mesh.device;
        n_training_points must be divisible by the rank count."""
        if mesh is not None:
            if mesh.shape[LIGHT_AXIS] != 1:
                raise ValueError("Stage1Runner takes a 1-D (rays) mesh")
            if cfg.train.n_training_points % mesh.size:
                raise ValueError(
                    f"n_training_points={cfg.train.n_training_points} not "
                    f"divisible by the {mesh.size}-rank mesh")
            device = mesh.device
        self.mesh = mesh
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
            use_fused_radiance=use_fused_radiance, mesh=mesh)
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
                say(mesh, f"resumed from {ck} at it={self.it}")
        self.writes = writes(mesh)
        if mesh is not None:
            replicate(self.field, mesh)
            replicate(self.opt_state, mesh)
        self.logger = (MetricLogger(os.path.join(workdir, "metrics.jsonl"))
                       if self.writes else None)

    def sample(self, use_outside: bool):
        """One step's view, ray batch and render noise, all drawn on the
        device from the runner's generator (whole, on every rank of a
        mesh)."""
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
                self.render_visdata(os.path.join(self.workdir, "vis",
                                                 f"it_{self.it}.png"))
            if wall_budget_s is not None and rank0_flag(
                    time.time() - t_start > wall_budget_s, self.mesh,
                    self.device):
                with profiling.span("stage1.checkpoint"):
                    self.save(self.it)
                say(self.mesh, f"[stage1] wall budget reached at "
                    f"it={self.it}; checkpointed for resume")
                return self
            with profiling.span("stage1.step"):
                use_outside = self.it > self.tcfg.outside_after
                with profiling.span("stage1.sample"):
                    batch, noise = self.sample(use_outside)
                    if self.mesh is not None:
                        batch = shard_stage1_batch(batch, self.mesh)
                        noise = shard_noise(noise, self.mesh)
                terms = self.step_fn(self.field, self.opt_state, batch,
                                     self.it, noise, use_outside=use_outside)
                losses.append(terms["loss"])
                self.it += 1
                if self.it % log_every == 0:
                    with profiling.span("stage1.log"):
                        self._log(losses, terms, log_every,
                                  time.time() - t0, on_log)
                    losses = []
                    t0 = time.time()
                if self.it % ckpt_every == 0 or self.it == max_iters:
                    with profiling.span("stage1.checkpoint"):
                        self.save(self.it)
        return self

    def _log(self, losses, terms, log_every, dt, on_log):
        """Read the losses since the last log back (a non-finite one halts
        the run, naming its iteration), print and log the step's terms."""
        vals = torch.stack(losses).cpu()
        terms = {k: float(v) for k, v in terms.items()}
        if not torch.isfinite(vals).all():
            # the rolling checkpoint holds a pre-divergence state
            bad = int(torch.nonzero(~torch.isfinite(vals))[0, 0])
            raise FloatingPointError(
                f"non-finite loss at it={self.it - len(losses) + bad + 1}"
                f": {terms}")
        say(self.mesh, f"[stage1 it {self.it}] "
            f"loss={terms['loss']:.4f} "
            f"rgb={terms['fullrgb_loss']:.4f} "
            f"grad={terms['grad_loss']:.4f} "
            f"normal={terms.get('normal_loss', 0.0):.4f} "
            f"lr={terms['lr']:.2e} {log_every / dt:.1f} it/s")
        if self.logger:
            self.logger.log(self.it, terms)
        if on_log:
            on_log(self.it, terms)

    def save(self, it: int) -> str:
        """Write the params, the optimizer state and `it` to the rolling
        checkpoint, and to a numbered one every backup_every steps (rank 0
        of a mesh writes; every rank returns once it has)."""
        tree = {"params": self.field, "opt": self.opt_state}
        path = os.path.join(self.ckpt_dir, "model.npz")
        if self.writes:
            save_checkpoint(path, tree, {"it": it})
            if it % self.cfg.backup_every == 0:
                save_checkpoint(os.path.join(self.ckpt_dir,
                                             f"model_{it}.npz"),
                                tree, {"it": it})
        barrier(self.mesh)
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
        sub = rank_tile(tile, self.mesh)
        if self.mesh is not None:           # this rank's block of the pixels
            pix = ray_block(pix, self.mesh, 0, "pixels")
        chunks = []
        for s in range(0, pix.shape[0], sub):
            out = render_unisurf(
                self.field, cfg.field, cfg.render, pix[s:s + sub], data["K"],
                pose, it=1e5, noise=None, use_outside=True, train=False,
                occ_fn=occ_fn)
            chunks.append({
                "rgb": out["rgb"], "normal": out["normal_pred"],
                "mask": out["mask_pred"], "acc": out["acc_map"],
                "phong": phong_shade(out["normal_pred"], out["mask_pred"],
                                     light)})
        shapes = {"rgb": (h, w, 3), "normal": (h, w, 3), "mask": (h, w),
                  "acc": (h, w), "phong": (h, w, 3)}
        whole = lambda x: x if self.mesh is None else gather_rays(x,
                                                                  self.mesh)
        return {k: whole(torch.cat([c[k] for c in chunks]))[:n]
                .reshape(shape).cpu().numpy() for k, shape in shapes.items()}

    def eval_views(self, out_dir: str, split: str = "test",
                   tile: int = 4096) -> list:
        """Render every view of a split; write rgb, normal, mask, acc and
        phong PNGs, the normal .npy, and metrics.json with each view's PSNR
        against its image (rank 0 of a mesh writes)."""
        cfg = self.cfg
        data = load_stage1_data(
            self.scene, split, cfg.inten_normalize, cfg.train_view,
            cfg.train_light, False, cfg.render.white_background,
            normal_loss=True, mask_valid=False, device=self.device)
        subs = ("rgb", "normal", "mask", "acc", "phong")
        metrics = []
        for v, vi in enumerate(data["views"]):
            r = self.render_view(v, tile, data)
            gt = data["imgs"][v].cpu().numpy()
            mse = float(np.mean((r["rgb"] - gt) ** 2))
            metrics.append({"view": int(vi),
                            "psnr": -10 * np.log10(mse + 1e-12)})
            if not self.writes:
                continue
            name = f"view_{vi + 1:02d}"
            panels = {"rgb": r["rgb"], "normal": r["normal"] / 2 + 0.5,
                      "mask": r["mask"].astype(np.float64), "acc": r["acc"],
                      "phong": r["phong"]}
            for sub in subs:
                os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
                imwrite(os.path.join(out_dir, sub, name + ".png"),
                        _to8(panels[sub]))
            np.save(os.path.join(out_dir, "normal", name + ".npy"),
                    r["normal"])
        if self.writes:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
        barrier(self.mesh)
        return metrics

    def render_visdata(self, out_path: str, views=(0, 1),
                       tile: int = 4096) -> np.ndarray:
        """The visualisation strip of each training view in `views` (gt |
        render | normal | SDPS normal | angular error | mask | acc | phong),
        stacked vertically, written to out_path (by rank 0 of a mesh)."""
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
        if self.writes:
            os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                        exist_ok=True)
            imwrite(out_path, strip)
        barrier(self.mesh)
        return strip

    # --------------------------------------------------------- shape export
    @torch.no_grad()
    @profiling.spanned("shape_extract")
    def shape_extract(self, out_dir: str, visibility: bool = True,
                      vis_plus: bool = False, vis_plus_num: int = 256,
                      semisphere: bool = True, tile: int = 4096,
                      n_steps: int = 512, seed: int = 0,
                      vis_steps: int = 128, vis_rescale: bool = False,
                      vis_plus_steps: int | None = None,
                      vis_plus_rescale: bool | None = None,
                      light_chunk: int | None = None,
                      vis_plus_guided: bool = False,
                      guide_res: int = 64, guide_coarse: int = 16) -> dict:
        """Export every view's surface points, normals and mask [H, W, ...]
        (points/, normal/, mask/ .npy) for stage 2; with `visibility`, the
        visibility toward each SDPS-estimated light (rotated into the world
        frame) of every pixel, 1 off the surface (visibility/); with
        `vis_plus`, also toward vis_plus_num farthest-point-sampled
        directions of 10,000 random ones from np.random.default_rng(seed)
        (on the half sphere facing the camera with `semisphere`), listed in
        vis_plus/light_dir.json.

        The visibility protocol (render/marching.py light_visibility):
        vis_steps samples on [0.1, 3.5] per light ray (faithful), or with
        vis_rescale on [0.1, the ray's box exit]. vis_plus_steps and
        vis_plus_rescale set the vis_plus directions' protocol apart
        (default: the train lights'), so a mixed export keeps the faithful
        train-light visibility that stage 2 reads as ground truth and
        rescales only the vis_plus directions that supervise its visibility
        net. vis_plus_guided marches the vis_plus directions over the
        interval a guide_res^3 occupancy grid leaves (occupancy_guide_grid,
        built once per export through the same occupancy route; its probes
        at guide_coarse points a ray must be no farther apart than a
        dilated slab is thick, else ValueError), at vis_plus_steps = 16
        unless given. light_chunk: lights per occupancy call (default 1).
        Every call builds its protocols anew from its own arguments.

        Visibility runs only on the surface pixels, compacted into tiles
        (of at most the surface's pixel count, as the march's tiles are of
        at most the image's), and is scattered back on the host. .npy writes
        run on one background thread. Under a mesh the ranks split each
        march tile's pixels, and each visibility tile's points and the
        lights over export_vis_mesh's rays x lights layout (`tile` must be
        divisible by the rank count); rank 0 writes.

        The call is the root span `shape_extract`; its legs are spans
        `shape_extract.<leg>` (utils/profiling.py). Returns the seconds of
        each leg summed over the views, read from them: warmup_s (the first
        march tile and one light), guide_s (the grid), fps_s, march_s (the
        march and its read back), vis_train_s, vis_plus_s (device legs,
        each ending in one read back), host_s (scatter and writes, on the
        thread) and host_tail_s (the wait for the writes after the last
        device leg)."""
        cfg = self.cfg
        dev = self.device
        span = profiling.span
        guided = visibility and vis_plus and vis_plus_guided
        if guided:
            check_guide_calibration(guide_res, guide_coarse)
        if vis_plus_steps is None:
            vis_plus_steps = 16 if vis_plus_guided else vis_steps
        if vis_plus_rescale is None:
            vis_plus_rescale = vis_rescale
        with span("shape_extract.load"):
            data = load_stage1_data(
                self.scene, "all", cfg.inten_normalize, cfg.train_view,
                cfg.train_light, False, cfg.render.white_background,
                normal_loss=False, mask_valid=False, device=dev)
        h, w = data["imgs"].shape[1:3]
        pix = _row_major_pixels(h, w, dev)
        n = pix.shape[0]
        tile = min(tile, n)            # a small image pads no further
        rank_tile(tile, self.mesh)
        pix = torch.cat([pix, pix.new_zeros(((-n) % tile, 2))])
        subs = ["points", "normal", "mask"] + (
            ["visibility"] if visibility else []) + (
            ["vis_plus"] if vis_plus else [])
        for sub in subs:
            if self.writes:
                os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        light_pred = (world_lights(self.scene, cfg, data["views"])
                      if visibility else None)
        occ_fn = self._occ_fn()
        vis_occ = occ_fn or (lambda p: occ_alpha(self.field, p, cfg.field))
        chunk = 1 if light_chunk is None else light_chunk
        if self.mesh is None:
            march = lambda pix_tile, pose: render_shape_extract(
                self.field, cfg.field, cfg.render, pix_tile, data["K"], pose,
                n_steps=n_steps, occ_fn=occ_fn)
            vis = lambda pts, dirs, steps, rescale, guide=None: \
                light_visibility(vis_occ, pts, dirs, n_steps=steps,
                                 rescale=rescale, light_chunk=chunk,
                                 guide=guide, guide_coarse=guide_coarse)
        else:
            march, vis = self._sharded_export_fns(data["K"], n_steps, chunk,
                                                  guide_coarse)

        timings = dict.fromkeys(("warmup_s", "guide_s", "fps_s", "march_s",
                                 "vis_train_s", "vis_plus_s", "host_s"), 0.0)
        poses_np = profiling.to_host(data["poses"])
        with span("shape_extract.warmup") as leg:
            march(pix[:tile], data["poses"][0])
            if visibility:
                vis(pix.new_zeros((tile, 3)),
                    torch.tensor([[0.0, 0.0, 1.0]], device=dev), vis_steps,
                    vis_rescale)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        timings["warmup_s"] = leg.seconds
        guide = None
        if guided:
            with span("shape_extract.guide") as leg:
                guide = occupancy_guide_grid(vis_occ, res=guide_res,
                                             device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            timings["guide_s"] = leg.seconds

        writer = ThreadPoolExecutor(max_workers=1)
        pending_writes = []

        def submit_host(fn):
            cause = profiling.current()

            def run():
                with span("shape_extract.write", cause=cause) as leg:
                    fn()
                timings["host_s"] += leg.seconds     # the one writer thread
            pending_writes.append(writer.submit(run))
            if len(pending_writes) > 4:      # bound the queued arrays
                with span("shape_extract.write_wait"):
                    while len(pending_writes) > 4:
                        pending_writes.pop(0).result()

        rng = np.random.default_rng(seed)
        vis_plus_json = {}
        ray_ranks = 1 if self.mesh is None else export_vis_mesh(
            self.mesh).shape[RAY_AXIS]
        for v, vi in enumerate(data["views"]):
            name = f"view_{vi + 1:02d}"
            # (dirs, leg, subdir, protocol: steps, rescale, guide)
            segments = []
            if visibility:
                segments.append((light_pred[v], "vis_train", "visibility",
                                 (vis_steps, vis_rescale, None)))
                if vis_plus:
                    with span("shape_extract.fps") as leg:
                        cand = rng.normal(size=(10000, 3))
                        cand /= np.linalg.norm(cand, axis=-1, keepdims=True)
                        if semisphere:
                            cand = cand[(cand * poses_np[v][:3, 2]).sum(-1)
                                        < 0]
                        idx = farthest_point_sampling_np(
                            cand, vis_plus_num,
                            start=int(rng.integers(len(cand))))
                        extra = cand[idx].astype(np.float32)
                        vis_plus_json[name] = extra.tolist()
                    timings["fps_s"] += leg.seconds
                    segments.append((extra, "vis_plus", "vis_plus",
                                     (vis_plus_steps, vis_plus_rescale,
                                      guide)))

            # pass 1: march and normals over all pixels, one read back
            pose = data["poses"][v]
            with span("shape_extract.march") as leg:
                outs = [march(pix[s:s + tile], pose)
                        for s in range(0, pix.shape[0], tile)]
                pts_dev, nrm_dev, msk_dev = (
                    torch.cat([o[k] for o in outs])[:n]
                    for k in ("points", "normal", "mask"))
            with span("shape_extract.readback") as back:
                points, normal, mask = (profiling.to_host(x) for x in
                                        (pts_dev, nrm_dev, msk_dev))
            timings["march_s"] += leg.seconds + back.seconds
            points = points.reshape(h, w, 3)
            normal = normal.reshape(h, w, 3)
            mask = mask.reshape(h, w)

            def save_geo(points=points, normal=normal, mask=mask, name=name):
                for sub, arr in (("points", points), ("normal", normal),
                                 ("mask", mask)):
                    np.save(os.path.join(out_dir, sub, name + ".npy"), arr)

            if self.writes:
                submit_host(save_geo)
            if not visibility:
                continue
            # pass 2: visibility of the surface pixels only, compacted into
            # tiles (padded with pixel 0) and scattered back on the host;
            # off the surface the visibility is 1
            surf_idx = np.nonzero(mask.reshape(-1))[0]
            n_surf = len(surf_idx)
            vtile = -(-min(tile, max(n_surf, 1)) // ray_ranks) * ray_ranks
            vpad = (-n_surf) % vtile if n_surf else vtile
            idx_dev = torch.as_tensor(
                np.concatenate([surf_idx, np.zeros((vpad,), np.int64)]),
                device=dev)
            for dirs, leg_name, sub, proto in segments:
                with span("shape_extract." + leg_name) as leg:
                    ldir = torch.as_tensor(dirs, device=dev)
                    vis_c = profiling.to_host(torch.cat(
                        [vis(pts_dev[idx_dev[s:s + vtile]], ldir, *proto)
                         for s in range(0, n_surf + vpad, vtile)],
                        dim=1)[:, :n_surf])
                timings[leg_name + "_s"] += leg.seconds

                def scatter_save(vis_c=vis_c, n_l=len(dirs), sub=sub,
                                 name=name, surf_idx=surf_idx):
                    full = np.ones((n_l, n), np.float32)
                    full[:, surf_idx] = vis_c
                    np.save(os.path.join(out_dir, sub, name + ".npy"),
                            full.reshape(-1, h, w))

                if self.writes:
                    submit_host(scatter_save)
        with span("shape_extract.write_wait") as leg:
            for f in pending_writes:
                f.result()                      # raise the writers' errors
            writer.shutdown(wait=True)
        timings["host_tail_s"] = leg.seconds
        if vis_plus and self.writes:
            with open(os.path.join(out_dir, "vis_plus", "light_dir.json"),
                      "w") as f:
                json.dump(vis_plus_json, f, indent=4)
        barrier(self.mesh)
        say(self.mesh, f"[shape_extract] leg breakdown (s): {timings}")
        return timings

    def _sharded_export_fns(self, K, n_steps, light_chunk, guide_coarse):
        """The export's march(pix_tile, pose) and vis(points, dirs, steps,
        rescale, guide=None) over the mesh: the march splits each tile's
        pixels over the ranks, the visibility its points and (padded with
        copies of light 0, sliced off after) the lights over
        export_vis_mesh's layout. The fused_occ kernel runs on each rank
        when the runner takes it."""
        cfg = self.cfg
        builder = ((lambda f: make_fused_occ_fn(f, cfg.field))
                   if self.use_fused_occ else None)
        sharded_march = make_sharded_march_fn(cfg.field, cfg.render,
                                              self.mesh, n_steps, builder)
        march = lambda pix_tile, pose: sharded_march(self.field, pix_tile, K,
                                                     pose)
        mesh2 = export_vis_mesh(self.mesh)
        n_light = mesh2.shape[LIGHT_AXIS]
        fns = {}

        def vis(pts, dirs, steps, rescale, guide=None):
            key = (steps, rescale)
            if key not in fns:
                fns[key] = make_sharded_vis_fn(
                    cfg.field, mesh2, builder, vis_steps=steps,
                    vis_rescale=rescale, light_chunk=light_chunk,
                    guide_coarse=guide_coarse)
            L = dirs.shape[0]
            pad = dirs[:1].expand((-L) % n_light, 3)
            return fns[key](self.field, pts, torch.cat([dirs, pad]),
                            guide)[:L]

        return march, vis

    # ---------------------------------------------------------- mesh export
    @rank0_only
    def extract_mesh_to(self, path: str, resolution0: int | None = None,
                        upsampling: int | None = None,
                        mask_carve: bool = False,
                        clip_bottom: float | None = None,
                        dilate_radius: int = 12,
                        exterior_only: bool = False,
                        timings: dict | None = None):
        """Extract the field's mesh to `path` (.obj, else PLY) and return
        (verts, tris). mask_carve: carve the value grid by the training
        views' dilated silhouettes before marching (extracting.py:120-126);
        clip_bottom: drop everything below this world z
        (extracting.py:130-132); exterior_only: fill enclosed pockets first.
        timings: a dict that gets the seconds of each leg."""
        timings = {} if timings is None else timings
        value_grid, iso, box_size = self._build_value_grid(
            resolution0, upsampling, mask_carve, dilate_radius, clip_bottom,
            timings)
        verts, tris = march_value_grid(value_grid, iso, box_size,
                                       exterior_only=exterior_only,
                                       timings=timings)
        return self._finish_mesh(path, verts, tris, timings)

    @rank0_only
    def extract_mesh_both(self, path_raw: str, path_exterior: str,
                          resolution0: int | None = None,
                          upsampling: int | None = None,
                          mask_carve: bool = False,
                          dilate_radius: int = 12,
                          timings: dict | None = None):
        """Both protocols (raw, the reference's, and exterior-only) from ONE
        evaluated and carved grid: only the pocket fill and the marching
        are per protocol. Returns ((verts, tris), (verts_ext, tris_ext));
        timings gets the shared legs and each protocol's under "raw" and
        "exterior"."""
        timings = {} if timings is None else timings
        value_grid, iso, box_size = self._build_value_grid(
            resolution0, upsampling, mask_carve, dilate_radius, None, timings)
        t_raw, t_ext = timings.setdefault("raw", {}), \
            timings.setdefault("exterior", {})
        verts, tris = march_value_grid(value_grid, iso, box_size,
                                       timings=t_raw)
        v_ext, f_ext = march_value_grid(value_grid, iso, box_size,
                                        exterior_only=True, timings=t_ext)
        return (self._finish_mesh(path_raw, verts, tris, t_raw),
                self._finish_mesh(path_exterior, v_ext, f_ext, t_ext))

    def _build_value_grid(self, resolution0, upsampling, mask_carve,
                          dilate_radius, clip_bottom, timings):
        value_fn = make_field_value_fn(self.field, self.cfg.field,
                                       fused=self.use_fused_occ)
        points_batch = (1 << 20) if self.use_fused_occ else 100_000
        carver = None
        if mask_carve:
            # the carver projects with camera_mat @ w2c in the reference's
            # [-1, 1] screen convention (extracting.py:350-368); K is
            # pixel-space, so the pixel -> NDC map folds into it
            masks = self.data["masks"].cpu().numpy()
            w2c = np.linalg.inv(self.data["poses"].cpu().numpy())
            h, w = masks.shape[1:]
            carver = make_mask_carver(
                masks, np.broadcast_to(pixel_to_ndc_camera(
                    self.data["K"].cpu().numpy(), h, w),
                    (self.n_views, 4, 4)),
                w2c, dilate_radius=dilate_radius, device=self.device)
        return build_value_grid(
            value_fn,
            resolution0=resolution0 or self.cfg.extraction_resolution,
            upsampling_steps=(upsampling if upsampling is not None
                              else self.cfg.extraction_upsampling),
            points_batch=points_batch, mask_carve=carver,
            clip_bottom=clip_bottom, timings=timings)

    def _finish_mesh(self, path: str, verts, tris, timings: dict):
        t0 = time.perf_counter()
        if self.cfg.extraction_refinement > 0 and len(verts):
            # RMSprop vertex refinement against the occupancy iso level
            # (extracting.py:237-323)
            verts = refine_mesh(
                lambda p: occ_alpha(self.field, p, self.cfg.field), verts,
                tris, steps=self.cfg.extraction_refinement,
                device=self.device)
        t1 = time.perf_counter()
        (save_obj if path.endswith(".obj") else save_ply)(path, verts, tris)
        timings["refine_s"] = t1 - t0
        timings["write_s"] = time.perf_counter() - t1
        return verts, tris
