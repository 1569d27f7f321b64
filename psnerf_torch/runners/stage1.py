"""Stage-1 runner, training (counterpart of psnerf_tpu/runners/stage1.py
constructor, `train` and `save`).

Trains the occupancy field step by step on its device. On a CUDA device the
march's occupancy queries go through the fused_occ kernel and the
integration batch through the fused_radiance kernels by default. Losses
stay on the device between logs: the only reads back to the host are at
log time. Full-image eval, the shape export and mesh extraction come with
a later slice.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from psnerf_torch.config import Stage1Config, milestones_epochs_to_iters
from psnerf_torch.data.scene import load_scene_params
from psnerf_torch.data.stage1 import load_stage1_data, sample_stage1_batch
from psnerf_torch.device import resolve_device
from psnerf_torch.fields.occupancy import init_occupancy_field
from psnerf_torch.ops.fused_radiance import supports
from psnerf_torch.render.unisurf import draw_unisurf_noise
from psnerf_torch.train.checkpoints import (latest_checkpoint,
                                            load_checkpoint, load_module,
                                            load_tree, save_checkpoint)
from psnerf_torch.train.logging import MetricLogger
from psnerf_torch.train.stage1 import make_stage1_train_step


class Stage1Runner:
    def __init__(self, cfg: Stage1Config, workdir: str, seed: int = 0,
                 resume: bool = True, use_fused_occ: bool | None = None,
                 use_fused_radiance: bool | None = None,
                 device: str | torch.device = "cuda"):
        """use_fused_occ / use_fused_radiance: None = on when the device is
        CUDA (the radiance kernels also need `supports(cfg.field)`, which
        takes bf16 operands only)."""
        self.device = dev = resolve_device(device)
        on_card = dev.type == "cuda"
        if use_fused_occ is None:
            use_fused_occ = on_card
        if use_fused_radiance is None:
            use_fused_radiance = on_card and supports(cfg.field)
            if on_card and not use_fused_radiance:
                print("[stage1] fused radiance kernels off: they take bf16 "
                      "operands and this architecture only (compute_dtype="
                      f"{cfg.field.compute_dtype!r}); the plain route runs")
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

    def train(self, max_iters: int, log_every: int | None = None,
              ckpt_every: int | None = None, on_log=None):
        """Train until `it` reaches max_iters, logging every log_every steps
        (a non-finite loss since the last log halts the run) and writing
        the rolling checkpoint every ckpt_every steps and at the end."""
        cfg = self.cfg
        log_every = log_every or cfg.print_every
        ckpt_every = ckpt_every or cfg.checkpoint_every
        losses = []
        t0 = time.time()
        while self.it < max_iters:
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
