"""The kernels' wrappers under a mesh, on the CPU (their plain versions):
the counterparts of tests/test_parallel_kernels.py. The JAX package runs
its Pallas kernels per device inside shard_map (interpret mode on
conftest's 8-device host mesh), the weight-gradient psum inside the
radiance kernel's custom vjp. The port runs each kernel on its rank's
block, with no collective inside, and the step all-reduces every leaf's
gradient once; four spawned gloo ranks hold that composition against the
JAX mesh forms at the JAX file's bars (K1 0.02; the radiance forward 1e-5,
its gradients 2e-4 of each leaf's max; the fused-vis frame 2e-2 and a mean
of 2e-3; the stage-1 step over both kernels a loss within 2e-3 and params
within 5e-4), and against the port's single-process result at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields.occupancy import OccFieldConfig as JOcc
from psnerf_tpu.fields.occupancy import init_occupancy_field
from psnerf_tpu.ops.fused_occ import make_fused_occ_fn as jocc_fn
from psnerf_tpu.ops.fused_radiance import fused_radiance_and_alpha as jrad
from psnerf_tpu.parallel import make_mesh as jmesh
from psnerf_tpu.parallel import replicate as jreplicate
from psnerf_torch.fields.occupancy import OccFieldConfig
from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.ops.fused_occ import make_fused_occ_fn
from psnerf_torch.ops.fused_radiance import fused_radiance_and_alpha
from psnerf_torch.parallel.launch import launch
from psnerf_torch.render.unisurf import UnisurfConfig
from psnerf_torch.train import losses, stage1
from torch_dist_workers import occ_field, run_jobs
from torch_helpers import flatten_jax, port_config, port_psnet, t

torch.set_num_threads(1)
SPAWN_S = 240
JCFG = JOcc()                       # the kernels' full bear architecture
CFG = port_config(JCFG, OccFieldConfig)
JPS = dict(mlp_width=32, sg_mlp_width=16, normal_mlp_width=32,
           vis_mlp_width=32, vis_mlp_depth=4, vis_mlp_skip_at=2,
           xyz_jitter_std=0)


def _points():
    params = init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    p = jax.random.normal(k1, (256, 3)) * 0.5
    rd = jax.random.normal(k2, (256, 3))
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    w_rgb = jax.random.normal(jax.random.PRNGKey(7), (256, 3))
    w_a = jax.random.normal(jax.random.PRNGKey(8), (256,))
    return params, *(np.asarray(a) for a in (p, rd, w_rgb, w_a))


def _frame_setup():
    from psnerf_tpu.fields import PSNetConfig as JPS_
    from psnerf_tpu.fields import init_psnet

    jcfg = JPS_(**JPS)
    n, l = 8 * 256, 4
    params = init_psnet(jax.random.PRNGKey(0), jcfg)
    pts = jax.random.normal(jax.random.PRNGKey(1), (n, 3)) * 0.3
    nrm = jax.random.normal(jax.random.PRNGKey(2), (n, 3))
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = jnp.stack([jnp.arange(n) % 32, jnp.arange(n) // 32],
                   -1).astype(jnp.float32)
    pose = jnp.eye(4).at[:3, 3].set(jnp.asarray([0.0, 0.0, -3.0]))
    K = jnp.asarray([[80.0, 0, 16, 0], [0, 80.0, 16, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1.0]])
    ld = jax.random.normal(jax.random.PRNGKey(3), (l, 3))
    ld = ld / jnp.linalg.norm(ld, axis=-1, keepdims=True)
    args = [np.asarray(a) for a in (uv, pose, K, pts, nrm,
                                    jnp.ones((n,), bool), ld,
                                    jnp.full((l,), 1.0))]
    return jcfg, params, args


def _stage1_setup():
    from psnerf_tpu.render.unisurf import UnisurfConfig as JU
    from tests.test_train import _stage1_batch

    rcfg = JU(near=1.0, far=5.0, radius=2.0, num_points_in=8,
              num_points_out=4, ray_marching_steps=32)
    key = jax.random.PRNGKey(5)
    k_phase, k_n1, k_n2, k_jit = jax.random.split(key, 4)
    u = lambda k, shape: np.asarray(jax.random.uniform(k, shape))
    noise = {"phase": u(k_phase, ()), "hit": u(k_n1, (64, 12)),
             "miss": u(k_n2, (64, 12)), "jitter": u(k_jit, (64, 3))}
    return rcfg, _stage1_batch(n=64), key, noise


@pytest.fixture(scope="module")
def ranks():
    params, p, rd, w_rgb, w_a = _points()
    flat = flatten_jax(params)
    jcfg_ps, ps_params, fargs = _frame_setup()
    rcfg, batch, key, noise = _stage1_setup()
    s1 = dict(fcfg=CFG, rcfg=port_config(rcfg, UnisurfConfig),
              tcfg=stage1.Stage1TrainConfig(
                  n_training_points=64, milestone_iters=(),
                  weights=losses.Stage1LossWeights()),
              flat=flat, batch={k: np.asarray(v) for k, v in batch.items()},
              noise=noise, it=100, fused=True)
    jobs = [
        ("occ", "occ_logit", dict(fcfg=CFG, flat=flat, points=p)),
        ("radiance", "radiance", dict(fcfg=CFG, flat=flat, points=p,
                                      dirs=rd, w_rgb=w_rgb, w_a=w_a)),
        ("frame", "frame", dict(cfg=PSNetConfig(**JPS),
                                flat=flatten_jax(ps_params), args=fargs,
                                tile=256, outputs=("rgb",),
                                use_fused_vis=True)),
        ("stage1", "stage1_step", s1),
    ]
    out = launch(run_jobs, 4, jobs, device="cpu", timeout=SPAWN_S)
    for r in out[1:]:             # every rank returns the whole result
        for name in ("occ", "frame"):
            np.testing.assert_equal(r[name], out[0][name])
    return dict(out=out[0], params=params, points=(p, rd, w_rgb, w_a),
                frame=(jcfg_ps, ps_params, fargs), stage1=(rcfg, batch, key),
                s1_kw=s1)


def test_fused_occ_under_mesh_matches_xla(ranks):
    params = ranks["params"]
    p = ranks["points"][0]
    got = ranks["out"]["occ"]
    assert got.shape == (256,)
    mesh = jmesh(8)
    want = jocc_fn(params, JCFG, tile=1024, interpret=True, mesh=mesh)(
        jnp.asarray(p))
    np.testing.assert_allclose(got, np.asarray(want), atol=0.02)
    field = occ_field(CFG, flatten_jax(params))
    single = make_fused_occ_fn(field, CFG)(t(p)).numpy()
    np.testing.assert_allclose(got, single, atol=1e-5)


def test_fused_radiance_under_mesh_forward(ranks):
    p, rd = ranks["points"][:2]
    got = ranks["out"]["radiance"]
    rgb, alpha = jrad(ranks["params"], jnp.asarray(p), jnp.asarray(rd),
                      JCFG, tile=128, interpret=True, compute="float32",
                      mesh=jmesh(8))
    np.testing.assert_allclose(got["rgb"], np.asarray(rgb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["alpha"], np.asarray(alpha), rtol=1e-5,
                               atol=1e-5)


def test_fused_radiance_under_mesh_backward(ranks):
    """Per-rank weight gradients, all-reduced as the step does, against
    the JAX kernel's psum inside its custom vjp, and against one process's
    gradients."""
    p, rd, w_rgb, w_a = ranks["points"]
    params = ranks["params"]
    mesh = jmesh(8)

    def loss(params):
        rgb, alpha = jrad(params, jnp.asarray(p), jnp.asarray(rd), JCFG,
                          tile=128, interpret=True, compute="float32",
                          mesh=mesh)
        return jnp.sum(rgb * w_rgb) + jnp.sum(alpha * w_a)

    want = flatten_jax(jax.grad(loss)(params))
    got = ranks["out"]["radiance"]["grads"]
    field = occ_field(CFG, flatten_jax(params))
    rgb, alpha = fused_radiance_and_alpha(field, t(p), t(rd), CFG,
                                          compute="float32")
    (torch.sum(rgb * t(w_rgb)) + torch.sum(alpha * t(w_a))).backward()
    single = {k: g.grad.numpy() for k, g in stage1.field_params(field)
              .items()}
    assert got.keys() == want.keys() == single.keys()
    for k, a in want.items():
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(got[k] / scale, a / scale, rtol=0,
                                   atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[k] / scale, single[k] / scale,
                                   rtol=0, atol=1e-5, err_msg=k)


def test_sharded_frame_renderer_with_fused_vis_shade(ranks):
    from psnerf_torch.eval.frame import render_frame_stage2
    from psnerf_tpu.eval.frame import render_frame_stage2 as jframe
    from psnerf_tpu.parallel.sharded_render import \
        make_sharded_frame_renderer

    jcfg, params, args = ranks["frame"]
    got = ranks["out"]["frame"]["rgb"]
    mesh = jmesh(8)
    render = make_sharded_frame_renderer(jcfg, mesh, tile=256,
                                         outputs=("rgb",), use_fused_vis=True,
                                         fused_interpret=True)
    with mesh:
        want = np.asarray(render(jreplicate(params, mesh),
                                 *map(jnp.asarray, args))["rgb"])
    plain = np.asarray(jframe(params, jcfg, *map(jnp.asarray, args),
                              tile=256, outputs=("rgb",))["rgb"])
    for ref in (want, plain):
        np.testing.assert_allclose(got, ref, atol=2e-2)
        assert np.abs(got - ref).mean() < 2e-3
    single = render_frame_stage2(port_psnet(params, jcfg), PSNetConfig(**JPS),
                                 *map(t, args), tile=256, outputs=("rgb",),
                                 use_fused_vis=True)["rgb"].numpy()
    np.testing.assert_allclose(got, single, atol=1e-5)


def test_stage1_train_step_with_sharded_kernels(ranks):
    """The stage-1 step with both kernels' wrappers on 4 ranks against the
    JAX step with both Pallas kernels under its mesh (interpret mode), and
    against the port's single-process step."""
    from psnerf_tpu.parallel import shard_stage1_batch
    from psnerf_tpu.train.stage1 import Stage1TrainConfig as JT1
    from psnerf_tpu.train.stage1 import make_stage1_train_step as jmake
    from torch_dist_workers import stage1_step

    rcfg, batch, key = ranks["stage1"]
    params = ranks["params"]
    got = ranks["out"]["stage1"]
    tcfg = JT1(n_training_points=64, milestone_iters=(), radiance_tile=128,
               occ_tile=1024, fused_interpret=True)
    mesh = jmesh(8)
    init, step = jmake(JCFG, rcfg, tcfg, use_fused_occ=True,
                       use_fused_radiance=True, mesh=mesh)
    with mesh:
        p_j, _, t_j = step(jreplicate(params, mesh),
                           jreplicate(init(params), mesh),
                           shard_stage1_batch(batch, mesh), 100.0, key,
                           use_outside=True)
    assert abs(got["loss"] - float(t_j["loss"])) < 2e-3
    p_j = flatten_jax(p_j)
    assert got["params"].keys() == p_j.keys()
    for k, v in p_j.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=5e-4,
                                   err_msg=k)
    single = stage1_step(None, **ranks["s1_kw"])
    assert abs(got["loss"] - single["loss"]) <= 1e-4 * abs(single["loss"])
    for k, v in single["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
