"""Rank functions of the port's data-parallel tests, run by
psnerf_torch.parallel.launch in spawned processes. This module imports
neither jax nor psnerf_tpu: every spawned rank imports it, and the tests
hand it numpy arrays and the port's own config objects.

run_jobs(mesh, jobs, shape=None) runs several checks in one spawn (a spawn
of four ranks costs seconds): jobs is a list of (name, function name,
kwargs), and the result is {name: that function's numpy results on this
rank}. shape (n_ray, n_light) runs them over a rays x lights mesh of the
same ranks instead of the launch's 1-D one.
"""

import numpy as np
import torch

from psnerf_torch.parallel import mesh as pm
from psnerf_torch.train.checkpoints import load_module


def run_jobs(mesh, jobs, shape=None):
    if shape is not None:
        mesh = pm.make_mesh_2d(*shape, mesh.device)
    return {name: globals()[fn](mesh, **kw) for name, fn, kw in jobs}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    a = np.array(tree)        # JAX's int32 indices as the port's int64
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def psnet(cfg, flat):
    from psnerf_torch.fields.psnet import init_psnet

    return load_module(init_psnet(cfg), flat)


def occ_field(cfg, flat):
    from psnerf_torch.fields.occupancy import init_occupancy_field

    return load_module(init_occupancy_field(cfg), flat)


def frame(mesh, cfg, flat, args, tile, outputs, **kw):
    """The sharded frame renderer on the whole frame's inputs; kw:
    use_fused_vis, albedo_new, basis_new."""
    from psnerf_torch.parallel.sharded_render import (
        make_sharded_frame_renderer)

    fn = make_sharded_frame_renderer(cfg, mesh, tile=tile, outputs=outputs,
                                     **kw)
    return _np(fn(psnet(cfg, flat), *_t(args)))


def stage2_params(cfg, flat, tables):
    from psnerf_torch.train.stage2 import init_stage2_params

    return init_stage2_params(psnet(cfg, flat), tables["light_dirs"],
                              tables["light_ints"])


def stage2_step(mesh, cfg, tcfg, flat, tables, batch, it, noise):
    """One stage-2 step on this rank's block of the batch: the terms, the
    gradients (loss_and_grads) and the params after the step."""
    from psnerf_torch.train.stage2 import make_stage2_train_step, model_params

    params = stage2_params(cfg, flat, tables)
    init, step = make_stage2_train_step(cfg, tcfg, mesh)
    b = pm.shard_stage2_batch(_t(batch), mesh)
    nz = pm.shard_noise(_t(noise), mesh)
    terms, grads = step.loss_and_grads(params, b, it, nz)
    opt = init(params)
    step(params, opt, b, it, nz)
    after = {f"model/{k}": v for k, v in model_params(params["model"]).items()}
    after.update({k: params[k] for k in ("light_dirs", "light_ints")})
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": _np(grads), "params": _np(after)}


def stage1_step(mesh, fcfg, rcfg, tcfg, flat, batch, noise, it,
                use_outside=True, fused=False):
    """One stage-1 step on this rank's block of the batch (the whole batch
    in one process when mesh is None): the loss, every leaf's (all-reduced)
    gradient and the params after the step. fused:
    the fused_occ and fused_radiance wrappers (their plain versions on the
    CPU)."""
    from psnerf_torch.train.stage1 import field_params, make_stage1_train_step

    field = occ_field(fcfg, flat)
    init, step = make_stage1_train_step(fcfg, rcfg, tcfg,
                                        use_fused_occ=fused,
                                        use_fused_radiance=fused, mesh=mesh)
    opt = init(field)
    batch, noise = _t(batch), _t(noise)
    if mesh is not None:
        batch = pm.shard_stage1_batch(batch, mesh)
        noise = pm.shard_noise(noise, mesh)
    terms = step(field, opt, batch, it, noise, use_outside=use_outside)
    params = field_params(field)
    return {"loss": float(terms["loss"]),
            "grads": _np({k: p.grad for k, p in params.items()}),
            "params": _np(params)}


def occ_logit(mesh, fcfg, flat, points):
    """fused_occ (its plain version on the CPU) on this rank's block of the
    points, gathered: K1 under a mesh."""
    from psnerf_torch.ops.fused_occ import make_fused_occ_fn

    occ = make_fused_occ_fn(occ_field(fcfg, flat), fcfg)
    return pm.gather_rays(occ(pm.ray_block(torch.as_tensor(points), mesh)),
                          mesh).numpy()


def radiance(mesh, fcfg, flat, points, dirs, w_rgb, w_a):
    """fused_radiance_and_alpha on this rank's block of the points, its
    outputs gathered and its weight gradients of sum(rgb * w_rgb) +
    sum(alpha * w_a) all-reduced, as the step reduces them."""
    from psnerf_torch.ops.fused_radiance import fused_radiance_and_alpha
    from psnerf_torch.train.stage1 import field_params

    field = occ_field(fcfg, flat)
    blk = lambda a: pm.ray_block(torch.as_tensor(a), mesh)
    rgb, alpha = fused_radiance_and_alpha(field, blk(points), blk(dirs),
                                          fcfg, compute="float32")
    (torch.sum(rgb * blk(w_rgb)) + torch.sum(alpha * blk(w_a))).backward()
    params = field_params(field)
    grads = [p.grad for p in params.values()]
    pm.all_reduce_grads(grads, mesh)
    return {"rgb": pm.gather_rays(rgb, mesh).numpy(),
            "alpha": pm.gather_rays(alpha, mesh).numpy(),
            "grads": {k: g.numpy() for k, g in zip(params, grads)}}


def export_fns(mesh, fcfg, rcfg, flat, pix, K, pose, lights, n_steps,
               vis_steps, tile, fused=False):
    """The sharded march over `pix` in tiles of `tile` pixels and the
    sharded visibility of its points toward `lights` over
    export_vis_mesh's layout."""
    from psnerf_torch.ops.fused_occ import make_fused_occ_fn
    from psnerf_torch.parallel import sharded_export as se

    field = occ_field(fcfg, flat)
    builder = (lambda f: make_fused_occ_fn(f, fcfg)) if fused else None
    march = se.make_sharded_march_fn(fcfg, rcfg, mesh, n_steps, builder)
    pix, K, pose = _t(pix), _t(K), _t(pose)
    parts = [march(field, pix[s:s + tile], K, pose)
             for s in range(0, pix.shape[0], tile)]
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    vis = se.make_sharded_vis_fn(fcfg, se.export_vis_mesh(mesh), builder,
                                 vis_steps=vis_steps)
    out["visibility"] = vis(field, out["points"], _t(lights))
    return _np(out)


def first_step_stage1(r):
    """The runner's next training step as its train loop runs it (on this
    rank's block under its mesh): the loss and every leaf's gradient,
    summed over the ranks."""
    from psnerf_torch.train.stage1 import field_params

    use_outside = r.it > r.tcfg.outside_after
    batch, noise = r.sample(use_outside)
    if r.mesh is not None:
        batch = pm.shard_stage1_batch(batch, r.mesh)
        noise = pm.shard_noise(noise, r.mesh)
    terms = r.step_fn(r.field, r.opt_state, batch, r.it, noise,
                      use_outside=use_outside)
    r.it += 1
    return {"loss": float(terms["loss"]),
            "grads": _np({k: p.grad for k, p in field_params(r.field)
                          .items()})}


def stage1_runner(mesh, cfg, workdir, steps, export=None, tile=256,
                  first=False):
    """Stage1Runner(mesh=...) trained `steps` steps from its seed: its
    params and render_view of view 0; with first, the first step's loss
    and gradients (first_step_stage1); with export (shape_extract's
    keyword arguments) the export written to workdir/export."""
    from psnerf_torch.runners.stage1 import Stage1Runner
    from psnerf_torch.train.stage1 import field_params

    r = Stage1Runner(cfg, workdir, resume=False, device="cpu", mesh=mesh)
    first = first_step_stage1(r) if first else None
    r.train(steps, log_every=1000)
    out = {"params": _np(field_params(r.field)), "it": r.it,
           "first": first}
    if export is not None:
        r.shape_extract(f"{workdir}/export", tile=tile, **export)
    out["view"] = r.render_view(0, tile=tile)
    return out


def stage2_runner(mesh, cfg, workdir, steps, tile=64, outputs=("rgb",),
                  envmap=None, light_h=2):
    """Stage2Runner(mesh=...) trained `steps` steps from its seed: its
    params, render_view of training view 0 under its trained lights, and
    with envmap an render_envmap of the test split into workdir/env."""
    from psnerf_torch.runners.stage2 import Stage2Runner
    from psnerf_torch.train.stage2 import model_params

    r = Stage2Runner(cfg, workdir, resume=False, device="cpu", mesh=mesh)
    r.train(steps, log_every=1000)
    params = {f"model/{k}": v
              for k, v in model_params(r.params["model"]).items()}
    params.update({k: r.params[k] for k in ("light_dirs", "light_ints")})
    dirs, ints = r.trained_lights_for_view(r.data, 0)
    out = {"params": _np(params),
           "view": r.render_view(r.data, 0, dirs, ints, tile=tile,
                                 outputs=outputs)}
    if envmap is not None:
        r.render_envmap(f"{workdir}/env", envmap, light_h=light_h, tile=tile)
    return out
