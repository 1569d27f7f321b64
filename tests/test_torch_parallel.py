"""The port's data-parallel paths (psnerf_torch.parallel) on the CPU: the
counterparts of tests/test_parallel.py. Every sharded case runs in spawned
gloo ranks (tests/torch_dist_workers.py), four on a 1-D mesh, 2 x 2 on a
rays x lights mesh, several cases to a spawn, and is held

  (a) against the JAX package's sharded function on conftest's 8-device
      host mesh, on the same numpy inputs and the same parameters (the JAX
      init, carried into the port by train/checkpoints.load_module), and
  (b) against the port's single-process result,

at tests/test_parallel.py's bars: frames 1e-5 abs; the stage-2 step's
loss 1e-5 relative and its params 1e-5 abs; the stage-1 step's loss 1e-4
relative. Port against JAX, the params after a step are held as
tests/test_torch_stage1_train.py holds them (Adam's first step is about
lr * sign(g), so a gradient that rounds near 0 moves a leaf by up to 2 lr
in either package: 1e-5 where |g| > 1e-6, else 5e-4). The runners draw
from torch generators, which JAX's key schedule cannot feed, so the
runner cases hold the port's mesh runner against its single-process
runner only (rtol 2e-4, atol 2e-6 after 5 steps, as the JAX test holds its
own). A stage-2 step whose object masks differ between the shards shows
the loss's global denominators.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import PSNetConfig as JPSNetConfig
from psnerf_tpu.fields import init_psnet as jinit_psnet
from psnerf_tpu.parallel import make_mesh as jmesh
from psnerf_tpu.parallel import replicate as jreplicate
from psnerf_tpu.parallel import shard_stage1_batch as jshard1
from psnerf_tpu.parallel import shard_stage2_batch as jshard2
from psnerf_tpu.parallel.mesh import make_mesh_2d as jmesh_2d
from psnerf_tpu.parallel.mesh import shard_stage2_batch_2d as jshard2_2d
from psnerf_tpu.parallel.sharded_render import (
    make_sharded_frame_renderer as jsharded,
    make_sharded_frame_renderer_2d as jsharded_2d)
from psnerf_torch.config import Stage1Config, Stage2Config
from psnerf_torch.data.synthetic import generate_synthetic_scene
from psnerf_torch.eval.frame import render_frame_stage2
from psnerf_torch.fields.occupancy import OccFieldConfig
from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.parallel.launch import launch
from psnerf_torch.render.unisurf import UnisurfConfig
from psnerf_torch.runners.stage1 import Stage1Runner
from psnerf_torch.runners.stage2 import Stage2Runner
from psnerf_torch.train import losses, stage1, stage2
from torch_dist_workers import run_jobs
from torch_helpers import flatten_jax, port_config, port_psnet, t

torch.set_num_threads(1)
SPAWN_S = 240            # a spawn's time limit: a lost rank fails, not hangs
JCFG = JPSNetConfig(mlp_width=32, sg_mlp_width=16, normal_mlp_width=32,
                    vis_mlp_width=32, vis_mlp_depth=4, vis_mlp_skip_at=2,
                    xyz_jitter_std=0)
CFG = port_config(JCFG, PSNetConfig)


def _frame_inputs(n, l):
    """tests/test_parallel.py's frame inputs, as numpy."""
    params = jinit_psnet(jax.random.PRNGKey(0), JCFG)
    pts = jax.random.normal(jax.random.PRNGKey(1), (n, 3)) * 0.3
    nrm = jax.random.normal(jax.random.PRNGKey(2), (n, 3))
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    msk = jnp.ones((n,), bool)
    xs = jnp.arange(n) % 32
    uv = jnp.stack([xs, jnp.arange(n) // 32], -1).astype(jnp.float32)
    pose = jnp.eye(4).at[:3, 3].set(jnp.asarray([0.0, 0.0, -3.0]))
    K = jnp.asarray([[80.0, 0, 16, 0], [0, 80.0, 16, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1.0]])
    ld = jax.random.normal(jax.random.PRNGKey(3), (l, 3))
    ld = ld / jnp.linalg.norm(ld, axis=-1, keepdims=True)
    li = jnp.full((l,), 1.0)
    return params, [np.asarray(a) for a in (uv, pose, K, pts, nrm, msk, ld,
                                            li)]


def _jax_sharded(make, mesh, params, args, **kw):
    render = make(JCFG, mesh, tile=64, **kw)
    with mesh:
        out = render(jreplicate(params, mesh), *map(jnp.asarray, args))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_single(params, args, **kw):
    out = render_frame_stage2(port_psnet(params, JCFG), CFG,
                              *map(t, args), tile=64, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _frame_job(name, params, args, **kw):
    return (name, "frame", dict(cfg=CFG, flat=flatten_jax(params),
                                args=args, tile=64, **kw))


# ----------------------------------------------------------- stage-2 steps

def _stage2_setup():
    """tests/test_parallel.py's stage-2 step: its params, batch (from
    tests/test_train.py) and the jitter draws of its key."""
    from psnerf_tpu.train import Stage2TrainConfig as JT
    from psnerf_tpu.train.stage2 import init_stage2_params
    from tests.test_train import _stage2_batch

    jt = JT(milestone_iters=(), train_order=False)
    model = jinit_psnet(jax.random.PRNGKey(0), JCFG)
    dirs0 = jax.random.normal(jax.random.PRNGKey(3), (12, 3))
    dirs0 = dirs0 / jnp.linalg.norm(dirs0, axis=-1, keepdims=True)
    params = init_stage2_params(model, dirs0, jnp.full((12, 1), 1.0))
    batch = _stage2_batch(n=64, l=4)
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    noise = {"xyz": np.asarray(jax.random.normal(k1, (64, 3))),
             "normal": np.asarray(jax.random.normal(k2, (64, 3)))}
    return jt, params, batch, key, noise


def _jax_stage2_step(jt, params, batch, key, mesh=None, shard=None):
    from psnerf_tpu.train import make_stage2_train_step

    init, step = make_stage2_train_step(JCFG, jt)
    opt = init(params)
    if mesh is None:
        p, _, terms = step(params, opt, batch, 10.0, key)
    else:
        with mesh:
            p, _, terms = step(jreplicate(params, mesh),
                               jreplicate(opt, mesh), shard(batch, mesh),
                               10.0, key)
    return float(terms["loss"]), flatten_jax(p)


def _stage2_job(name, jt, params, batch, noise):
    tcfg = stage2.Stage2TrainConfig(milestone_iters=(), train_order=False,
                                    weights=losses.Stage2LossWeights())
    assert jt.warmup_iters == tcfg.warmup_iters
    tables = {k: np.asarray(params[k]) for k in ("light_dirs",
                                                 "light_ints")}
    return (name, "stage2_step", dict(
        cfg=CFG, tcfg=tcfg, flat=flatten_jax(params["model"]),
        tables=tables, batch={k: np.asarray(v) for k, v in batch.items()},
        it=10, noise=noise))


def _port_stage2_single(job):
    from torch_dist_workers import _t, stage2_params

    kw = job[2]
    params = stage2_params(kw["cfg"], kw["flat"], kw["tables"])
    init, step = stage2.make_stage2_train_step(kw["cfg"], kw["tcfg"])
    b, nz = _t(kw["batch"]), _t(kw["noise"])
    terms, grads = step.loss_and_grads(params, b, kw["it"], nz)
    step(params, init(params), b, kw["it"], nz)
    after = {f"model/{k}": v.detach().numpy().copy()
             for k, v in stage2.model_params(params["model"]).items()}
    after.update({k: params[k].numpy().copy()
                  for k in ("light_dirs", "light_ints")})
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": {k: g.numpy() for k, g in grads.items()},
            "params": after}


def _uneven_masks(batch, world=4):
    """The batch with object masks that differ between the 4 shards: all
    of shard 0, half of shard 1, none of shard 2, a quarter of shard 3."""
    n = batch["object_mask"].shape[0]
    b = n // world
    keep = np.zeros(n, bool)
    for r, share in enumerate((1.0, 0.5, 0.0, 0.25)):
        keep[r * b:r * b + int(share * b)] = True
    return dict(batch, object_mask=jnp.asarray(keep))


# ----------------------------------------------------------- stage-1 step

def _stage1_setup():
    """tests/test_parallel.py's stage-1 step, with the draws of its key
    (render_unisurf's phase, stratified and jitter noise) as numpy."""
    from psnerf_tpu.fields import OccFieldConfig as JOcc
    from psnerf_tpu.fields import init_occupancy_field
    from psnerf_tpu.render import UnisurfConfig as JU
    from psnerf_tpu.train import Stage1TrainConfig as JT1
    from tests.test_train import _stage1_batch

    fcfg = JOcc(num_layers=4, hidden_dim=64, feat_size=64, octaves_pe=4,
                octaves_pe_views=2)
    rcfg = JU(near=1.0, far=5.0, radius=2.0, num_points_in=8,
              num_points_out=4, ray_marching_steps=32)
    tcfg = JT1(n_training_points=64, milestone_iters=())
    params = init_occupancy_field(jax.random.PRNGKey(0), fcfg)
    batch = _stage1_batch(n=64)
    key = jax.random.PRNGKey(0)
    k_phase, k_n1, k_n2, k_jit = jax.random.split(key, 4)
    u = lambda k, shape: np.asarray(jax.random.uniform(k, shape))
    noise = {"phase": u(k_phase, ()), "hit": u(k_n1, (64, 12)),
             "miss": u(k_n2, (64, 12)), "jitter": u(k_jit, (64, 3))}
    return fcfg, rcfg, tcfg, params, batch, key, noise


def _stage1_port_kw(fcfg, rcfg, params, batch, noise):
    return dict(
        fcfg=port_config(fcfg, OccFieldConfig),
        rcfg=port_config(rcfg, UnisurfConfig),
        tcfg=stage1.Stage1TrainConfig(n_training_points=64,
                                      milestone_iters=(),
                                      weights=losses.Stage1LossWeights()),
        flat=flatten_jax(params),
        batch={k: np.asarray(v) for k, v in batch.items()}, noise=noise,
        it=6000)


def _port_stage1_single(kw):
    from torch_dist_workers import occ_field

    field = occ_field(kw["fcfg"], kw["flat"])
    init, step = stage1.make_stage1_train_step(kw["fcfg"], kw["rcfg"],
                                               kw["tcfg"])
    terms = step(field, init(field), {k: t(v) for k, v in
                                      kw["batch"].items()},
                 kw["it"], {k: t(v) for k, v in kw["noise"].items()})
    params = stage1.field_params(field)
    return {"loss": float(terms["loss"]),
            "params": {k: p.detach().numpy().copy()
                       for k, p in params.items()}}


# --------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def one_d():
    """The 1-D cases: JAX on an 8-device mesh, the port on 4 ranks."""
    fparams, fargs = _frame_inputs(8 * 64, 3)
    albedo_new = np.asarray([0.8, 0.15, 0.1], np.float32)
    jt, s2p, s2b, s2key, s2noise = _stage2_setup()
    uneven = _uneven_masks(s2b)
    fcfg, rcfg, tcfg1, s1p, s1b, s1key, s1noise = _stage1_setup()
    s1kw = _stage1_port_kw(fcfg, rcfg, s1p, s1b, s1noise)
    jobs = [
        _frame_job("frame", fparams, fargs, outputs=("rgb", "albedo")),
        _frame_job("edit", fparams, fargs, outputs=("rgb",),
                   albedo_new=albedo_new, basis_new=2),
        _stage2_job("stage2", jt, s2p, s2b, s2noise),
        _stage2_job("uneven", jt, s2p, uneven, s2noise),
        ("stage1", "stage1_step", s1kw),
    ]
    ranks = launch(run_jobs, 4, jobs, device="cpu", timeout=SPAWN_S)

    from psnerf_tpu.train import make_stage1_train_step as jmake1

    mesh = jmesh(8)
    init1, step1 = jmake1(fcfg, rcfg, tcfg1)
    with mesh:
        p1, _, terms1 = step1(jreplicate(s1p, mesh),
                              jreplicate(init1(s1p), mesh),
                              jshard1(s1b, mesh), 6000.0, s1key,
                              use_outside=True)
    return {
        "ranks": ranks, "jobs": {j[0]: j for j in jobs},
        "frame_args": (fparams, fargs), "albedo_new": albedo_new,
        "stage2": (jt, s2p, s2b, s2key, uneven),
        "jax_stage1": (float(terms1["loss"]), flatten_jax(p1)),
        "stage1_kw": s1kw,
    }


@pytest.fixture(scope="module")
def two_d():
    """The rays x lights cases: JAX on a 4 x 2 mesh, the port on 2 x 2."""
    fparams, fargs = _frame_inputs(4 * 64, 4)
    _, eargs = _frame_inputs(4 * 64, 6)
    eargs[-1] = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (6, 3),
                                              maxval=0.1))
    albedo_new = np.asarray([0.8, 0.2, 0.1], np.float32)
    jt, s2p, s2b, s2key, s2noise = _stage2_setup()
    jobs = [
        _frame_job("frame", fparams, fargs, outputs=("rgb", "visibility")),
        _frame_job("envmap", fparams, eargs, outputs=("rgb_sum",)),
        _frame_job("edit", fparams, fargs, outputs=("rgb",),
                   albedo_new=albedo_new, basis_new=3),
        _stage2_job("stage2", jt, s2p, s2b, s2noise),
    ]
    ranks = launch(run_jobs, 4, jobs, (2, 2), device="cpu", timeout=SPAWN_S)
    return {"ranks": ranks, "jobs": {j[0]: j for j in jobs},
            "args": {"frame": fargs, "envmap": eargs, "edit": fargs},
            "params": fparams, "albedo_new": albedo_new,
            "stage2": (jt, s2p, s2b, s2key)}


def _same_on_every_rank(ranks, name):
    """Every rank returns the whole result: rank 0's equals every other's
    bit for bit."""
    flat = lambda d, p="": (
        {k2: v2 for k, v in d.items() for k2, v2 in flat(v, f"{p}{k}/")
         .items()} if isinstance(d, dict) else {p: np.asarray(d)})
    ref = flat(ranks[0][name])
    for r in ranks[1:]:
        got = flat(r[name])
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    return ranks[0][name]


def _check_frame(got, jax_ref, single):
    assert got.keys() == jax_ref.keys() == single.keys()
    for k in got:
        assert got[k].shape == jax_ref[k].shape
        np.testing.assert_allclose(got[k], jax_ref[k], atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k], single[k], atol=1e-5, err_msg=k)


def _check_step_against_jax(got_params, loss, jax_loss, jax_params, rtol,
                            grads=None):
    assert abs(loss - jax_loss) <= rtol * abs(jax_loss)
    assert got_params.keys() == jax_params.keys()
    for k, ref in jax_params.items():
        big = (np.abs(grads[k]) > 1e-6 if grads is not None
               else np.ones(ref.shape, bool))
        np.testing.assert_allclose(got_params[k][big], ref[big], rtol=0,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got_params[k], ref, rtol=0, atol=5e-4,
                                   err_msg=k)


def _check_step_against_single(got, single, rtol):
    assert got["terms"].keys() == single["terms"].keys()
    for k, v in single["terms"].items():
        assert abs(got["terms"][k] - v) <= rtol * abs(v) + 1e-12, k
    for k, v in single["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------------------ frames

def test_sharded_frame_matches_single_device(one_d):
    params, args = one_d["frame_args"]
    got = _same_on_every_rank(one_d["ranks"], "frame")
    _check_frame(got, _jax_sharded(jsharded, jmesh(8), params, args,
                                   outputs=("rgb", "albedo")),
                 _port_single(params, args, outputs=("rgb", "albedo")))


def test_edit_hooks_through_tiled_and_sharded_frame(one_d):
    params, args = one_d["frame_args"]
    kw = dict(outputs=("rgb",), albedo_new=one_d["albedo_new"], basis_new=2)
    got = _same_on_every_rank(one_d["ranks"], "edit")
    jkw = dict(kw, albedo_new=jnp.asarray(kw["albedo_new"]))
    _check_frame(got, _jax_sharded(jsharded, jmesh(8), params, args, **jkw),
                 _port_single(params, args, **kw))
    plain = _port_single(params, args, outputs=("rgb",))
    assert np.abs(got["rgb"] - plain["rgb"]).max() > 1e-3


def test_sharded_frame_2d_rays_x_lights(two_d):
    got = _same_on_every_rank(two_d["ranks"], "frame")
    args, outs = two_d["args"]["frame"], ("rgb", "visibility")
    _check_frame(got, _jax_sharded(jsharded_2d, jmesh_2d(4, 2),
                                   two_d["params"], args, outputs=outs),
                 _port_single(two_d["params"], args, outputs=outs))


def test_sharded_2d_envmap_sum_matches_single_device(two_d):
    got = _same_on_every_rank(two_d["ranks"], "envmap")
    args = two_d["args"]["envmap"]
    assert got["rgb_sum"].shape == (4 * 64, 3)
    _check_frame(got, _jax_sharded(jsharded_2d, jmesh_2d(4, 2),
                                   two_d["params"], args,
                                   outputs=("rgb_sum",)),
                 _port_single(two_d["params"], args, outputs=("rgb_sum",)))


def test_sharded_2d_edit_hooks_match_single_device(two_d):
    got = _same_on_every_rank(two_d["ranks"], "edit")
    args, alb = two_d["args"]["edit"], two_d["albedo_new"]
    _check_frame(got, _jax_sharded(jsharded_2d, jmesh_2d(4, 2),
                                   two_d["params"], args, outputs=("rgb",),
                                   albedo_new=jnp.asarray(alb), basis_new=3),
                 _port_single(two_d["params"], args, outputs=("rgb",),
                              albedo_new=alb, basis_new=3))
    plain = _port_single(two_d["params"], args, outputs=("rgb",))
    assert np.abs(got["rgb"] - plain["rgb"]).max() > 1e-3


# ------------------------------------------------------------- train steps

def _check_stage2(ctx, name, jax_mesh, jax_shard, batch):
    jt, params, _, key = ctx["stage2"][:4]
    got = _same_on_every_rank(ctx["ranks"], name)
    jloss, jparams = _jax_stage2_step(jt, params, batch, key, jax_mesh,
                                      jax_shard)
    grads = {k if k.startswith("light_") else f"model/{k}": g
             for k, g in got["grads"].items()}
    _check_step_against_jax(got["params"], got["terms"]["loss"], jloss,
                            jparams, 1e-5, grads)
    single = _port_stage2_single(ctx["jobs"][name])
    _check_step_against_single(got, single, 1e-5)
    for k, g in single["grads"].items():
        scale = np.abs(g).max() + 1e-8
        np.testing.assert_allclose(got["grads"][k] / scale, g / scale,
                                   rtol=0, atol=1e-5, err_msg=k)
    return got


def test_sharded_train_step_matches_single_device(one_d):
    _check_stage2(one_d, "stage2", jmesh(8), jshard2,
                  one_d["stage2"][2])


def test_sharded_train_step_2d_rays_x_lights_matches_single_device(two_d):
    _check_stage2(two_d, "stage2", jmesh_2d(4, 2), jshard2_2d,
                  two_d["stage2"][2])


def test_uneven_masks_take_global_denominators(one_d):
    """Object masks that differ between the shards (16, 8, 0 and 4 of each
    shard's 16 pixels): each rank's local sum over the global count sums
    to the single-device mean, loss and gradients alike."""
    uneven = one_d["stage2"][4]
    counts = np.asarray(uneven["object_mask"]).reshape(4, -1).sum(1)
    assert len(set(counts.tolist())) == 4
    got = _check_stage2(one_d, "uneven", jmesh(8), jshard2, uneven)
    # each shard's local mean would weight the shards equally instead
    assert got["terms"]["sg_rgb_loss"] > 0


def test_sharded_stage1_train_step_matches_single_device(one_d):
    got = _same_on_every_rank(one_d["ranks"], "stage1")
    jloss, jparams = one_d["jax_stage1"]
    _check_step_against_jax(got["params"], got["loss"], jloss, jparams,
                            1e-4, got["grads"])
    single = _port_stage1_single(one_d["stage1_kw"])
    assert abs(got["loss"] - single["loss"]) <= 1e-4 * abs(single["loss"])
    for k, v in single["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)


# ----------------------------------------------------------------- runners

def _stage1_cfg(scene):
    return Stage1Config(
        field=OccFieldConfig(num_layers=4, hidden_dim=32, feat_size=32,
                             octaves_pe=2, octaves_pe_views=2, skips=(2,)),
        render=UnisurfConfig(near=1.2, far=5.0, radius=1.2,
                             interval_start=0.6, interval_end=0.05,
                             interval_decay=1e-3, num_points_in=8,
                             num_points_out=4, ray_marching_steps=16),
        train=stage1.Stage1TrainConfig(learning_rate=1e-3,
                                       milestone_iters=(),
                                       n_training_points=64, normal_after=0,
                                       weights=losses.Stage1LossWeights()),
        data_dir=scene, inten_normalize=None, checkpoint_every=100000,
        backup_every=100000, visualize_every=0)


def _stage2_cfg(scene, exports):
    return Stage2Config(
        net=PSNetConfig(mlp_width=16, mlp_depth=2, mlp_skip_at=-1,
                        sg_mlp_width=8, sg_mlp_depth=1, normal_mlp_width=16,
                        normal_mlp_depth=2, normal_mlp_skip_at=-1,
                        vis_mlp_width=16, vis_mlp_depth=2,
                        vis_mlp_skip_at=-1, n_freqs_xyz=2,
                        normal_n_freqs_xyz=2),
        train=stage2.Stage2TrainConfig(warmup_iters=2,
                                       weights=losses.Stage2LossWeights()),
        data_dir=scene, stage1_shape_path=exports, inten_normalize=None,
        light_bs=2, num_pixels=32, train_all_pixels=False, vis_train_num=2)


EXPORT = dict(visibility=True, vis_plus=True, vis_plus_num=4, n_steps=16)


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """tests/test_parallel.py's 24x24 runner scene: the single-process
    runners (stage 1 trained 5 steps and exported, stage 2 trained 5 steps
    on that export) and the same through 4 ranks in one spawn."""
    root = tmp_path_factory.mktemp("par_runners")
    scene = str(root / "scene")
    generate_synthetic_scene(scene, n_views=2, n_test=1, n_lights=3,
                             hw=(24, 24))
    cfg1 = _stage1_cfg(scene)
    r1 = Stage1Runner(cfg1, str(root / "s1"), resume=False, device="cpu")
    r1.train(5, log_every=1000)
    exports = str(root / "s1" / "export")
    r1.shape_extract(exports, tile=256, **EXPORT)
    view1 = r1.render_view(0, tile=256)
    cfg2 = _stage2_cfg(scene, exports)
    r2 = Stage2Runner(cfg2, str(root / "s2"), resume=False, device="cpu")
    r2.train(5, log_every=1000)
    dirs, ints = r2.trained_lights_for_view(r2.data, 0)
    view2 = r2.render_view(r2.data, 0, dirs, ints, tile=64,
                           outputs=("rgb", "albedo"))
    jobs = [("stage1", "stage1_runner",
             dict(cfg=cfg1, workdir=str(root / "m1"), steps=5,
                  export=EXPORT, tile=256)),
            ("stage2", "stage2_runner",
             dict(cfg=cfg2, workdir=str(root / "m2"), steps=5, tile=64,
                  outputs=("rgb", "albedo")))]
    ranks = launch(run_jobs, 4, jobs, device="cpu", timeout=SPAWN_S)
    return dict(root=root, r1=r1, r2=r2, view1=view1, view2=view2,
                exports=exports, ranks=ranks)


def _flat_stage2(r):
    out = {f"model/{k}": v.detach().numpy()
           for k, v in stage2.model_params(r.params["model"]).items()}
    out.update({k: r.params[k].numpy() for k in ("light_dirs",
                                                 "light_ints")})
    return out


def _close_params(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2e-6,
                                   err_msg=k)


def test_sharded_shape_extract_matches_single_device(runners):
    """The export's sharded march and 2 x 2 visibility write the npys of
    the single-process export; only rank 0 wrote them."""
    _same_on_every_rank(runners["ranks"], "stage1")
    mine = str(runners["root"] / "m1" / "export")
    single = runners["exports"]
    for sub in ("points", "normal", "mask", "visibility", "vis_plus"):
        for view in ("view_01", "view_02", "view_03"):
            a = np.load(os.path.join(single, sub, view + ".npy"))
            b = np.load(os.path.join(mine, sub, view + ".npy"))
            np.testing.assert_allclose(b, a, atol=1e-5,
                                       err_msg=f"{sub}/{view}")
    with open(os.path.join(mine, "vis_plus", "light_dir.json")) as f:
        with open(os.path.join(single, "vis_plus", "light_dir.json")) as g:
            assert f.read() == g.read()


def test_stage1_runner_mesh_training_matches_single_device(runners):
    got = _same_on_every_rank(runners["ranks"], "stage1")
    assert got["it"] == 5
    want = {k: p.detach().numpy()
            for k, p in stage1.field_params(runners["r1"].field).items()}
    _close_params(got["params"], want)
    for k, v in runners["view1"].items():     # the sharded eval render
        np.testing.assert_allclose(got["view"][k], v, atol=1e-5, err_msg=k)
    ck = runners["root"] / "m1" / "checkpoints" / "model.npz"
    assert ck.exists()


def test_stage2_runner_mesh_training_matches_single_device(runners):
    got = _same_on_every_rank(runners["ranks"], "stage2")
    _close_params(got["params"], _flat_stage2(runners["r2"]))
    for k in ("rgb", "albedo"):
        np.testing.assert_allclose(got["view"][k], runners["view2"][k],
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------- the one rank

@pytest.fixture
def no_collectives(monkeypatch):
    """torch.distributed's collectives raise, and so does torch.cat once
    armed (all_reduce_grads' flat buffer): a one-rank mesh calls none."""
    import torch.distributed as dist

    def refuse(*a, **kw):
        raise AssertionError("a collective on the one-rank mesh")

    for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    cat = torch.cat

    def arm_cat():
        monkeypatch.setattr(torch, "cat", refuse)
        return lambda: monkeypatch.setattr(torch, "cat", cat)

    return arm_cat


def _one_rank_case(name, mesh, arm_cat, capsys):
    """(what the helper returned, what it must return by identity)."""
    from psnerf_torch.parallel import mesh as pm
    from psnerf_torch.parallel.sharded_export import export_vis_mesh
    from psnerf_torch.parallel.sharded_render import (frame_block,
                                                      gather_frame)

    x = torch.arange(24.0).reshape(4, 6)
    if name == "writes":
        return pm.writes(mesh), True
    if name == "barrier":
        return pm.barrier(mesh), None
    if name == "say":
        pm.say(mesh, "one rank")
        return capsys.readouterr().out, "one rank\n"
    if name == "rank_tile":
        return pm.rank_tile(64, mesh), 64
    if name == "rank0_flag":
        return pm.rank0_flag(True, mesh, "cpu"), True
    if name == "world_sum":
        return pm.world_sum(x, mesh), x
    if name == "all_sum":
        return pm.all_sum(x, mesh.groups[pm.LIGHT_AXIS]), x
    if name == "any_over_lights":
        return pm.any_over_lights(x, mesh), x
    if name == "all_reduce_grads":
        grads = [x, x[0].clone()]
        want = [g.clone() for g in grads]
        restore = arm_cat()
        got = pm.all_reduce_grads(grads, mesh)
        restore()
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        return got, None
    if name == "replicate":
        tree = {"a": x, "b": {"c": x[0]}}
        return pm.replicate(tree, mesh), tree
    if name == "ray_block":
        return pm.ray_block(x, mesh, 1), x
    if name == "light_block":
        return pm.light_block(x, mesh), x
    if name == "gather_rays":
        return pm.gather_rays(x, mesh, 1), x
    if name == "gather_lights":
        return pm.gather_lights(x, mesh), x
    if name == "export_vis_mesh":
        return export_vis_mesh(mesh), mesh
    if name == "shard_stage1_batch":
        batch = {"pixels": x[:, :2], "rgb_gt": x[:, :3],
                 "camera_mat": torch.eye(4)}
        return pm.shard_stage1_batch(batch, mesh), batch
    if name in ("shard_stage2_batch", "shard_stage2_batch_2d"):
        batch = {"uv": x[:, :2], "object_mask": x[:, 0] > 3,
                 "rgb_gt": x[None, :, :3].expand(2, 4, 3),
                 "visibility": x[:2], "l_slt": torch.arange(2),
                 "light_vis_train": x[:2, :3], "pose": torch.eye(4)}
        return getattr(pm, name)(batch, mesh), batch
    if name == "shard_noise":
        noise = {"phase": x[0, 0], "hit": x}
        return pm.shard_noise(noise, mesh), noise
    if name == "frame_block":
        args = (x[:, :2], torch.eye(4), torch.eye(4), x[:, :3], x[:, 3:],
                x[:, 0] > 3, x[:2, :3], x[:2, 0])
        return frame_block(mesh, 2, *args), args
    if name == "gather_frame":
        out = {"rgb": x[None].expand(2, 4, 6), "albedo": x,
               "rgb_sum": x[:, :3], "rgb_cnl": x[None]}
        return gather_frame(out, CFG, mesh), out
    raise KeyError(name)


ONE_RANK_HELPERS = (
    "writes", "barrier", "say", "rank_tile", "rank0_flag", "world_sum",
    "all_sum", "any_over_lights", "all_reduce_grads", "replicate",
    "ray_block", "light_block", "gather_rays", "gather_lights",
    "export_vis_mesh", "shard_stage1_batch", "shard_stage2_batch",
    "shard_stage2_batch_2d", "shard_noise", "frame_block", "gather_frame")


@pytest.mark.parametrize("name", ONE_RANK_HELPERS)
def test_one_rank_mesh_helpers_return_their_inputs(name, no_collectives,
                                                  capsys):
    """On the one-rank mesh that mesh=None stands for, every layout,
    gather and collective helper returns its input tensors themselves,
    with torch.distributed uninitialised and its collectives refused."""
    from psnerf_torch.parallel.mesh import as_mesh

    assert not torch.distributed.is_initialized()
    mesh = as_mesh(None, "cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    got, want = _one_rank_case(name, mesh, no_collectives, capsys)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        assert all(got[k] is want[k] for k in want)
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        assert all(g is w for g, w in zip(got, want))
    elif isinstance(want, torch.Tensor) or name in ("replicate",
                                                    "export_vis_mesh"):
        assert got is want
    else:
        assert got == want


def test_one_device_runners_make_no_distributed_call(tmp_path,
                                                     no_collectives):
    """Stage1Runner(mesh=None) trains a step and exports, Stage2Runner
    (mesh=None) trains a step on that export and renders a view, on the
    CPU at toy size, with every collective refused: one device is the
    one-rank mesh, which never reaches torch.distributed."""
    scene = str(tmp_path / "scene")
    generate_synthetic_scene(scene, n_views=2, n_test=1, n_lights=3,
                             hw=(16, 16))
    r1 = Stage1Runner(_stage1_cfg(scene), str(tmp_path / "s1"),
                      resume=False, device="cpu")
    assert r1.mesh.size == 1 and r1.mesh.device == r1.device
    r1.train(1, log_every=1000)
    exports = str(tmp_path / "s1" / "export")
    r1.shape_extract(exports, tile=256, visibility=True, vis_plus=True,
                     vis_plus_num=4, n_steps=16, vis_steps=16)
    r2 = Stage2Runner(_stage2_cfg(scene, exports), str(tmp_path / "s2"),
                      resume=False, device="cpu")
    r2.train(1, log_every=1000)
    assert r1.it == r2.it == 1
    dirs, ints = r2.trained_lights_for_view(r2.data, 0)
    view = r2.render_view(r2.data, 0, dirs, ints, tile=64,
                          outputs=("rgb",))
    assert view["rgb"].shape == (len(dirs), 16, 16, 3)
    assert np.isfinite(view["rgb"]).all()
    assert not torch.distributed.is_initialized()
