"""psnerf_torch's stage-1 training against psnerf_tpu's:
  * one make_stage1_train_step step at identical params, batch and noise on
    the plain routes: loss within 1e-5 relative, gradients within 1e-4 of
    each leaf's scale; after Adam, params within 1e-5 where |g| > 1e-6 and
    within 5e-4 everywhere (Adam divides by |g| + 1e-8, so sign noise in a
    near-zero gradient moves a param by up to lr);
  * the port's fused route (the kernels' plain versions, on the CPU)
    against JAX's plain route at tests/test_fused_radiance.py:145-149's
    bars (loss 2e-3, params 5e-4);
  * Stage1Runner(device="cpu") on a tiny synthetic scene: finite losses,
    metrics.jsonl, checkpoints crossing both ways, resume at the saved it.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.config import Stage1Config as JStage1Config
from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.render import unisurf as juni
from psnerf_tpu.train import losses as jlosses
from psnerf_tpu.train import stage1 as jstage1
from psnerf_torch.config import Stage1Config
from psnerf_torch.fields.occupancy import OccFieldConfig
from psnerf_torch.render.unisurf import UnisurfConfig
from psnerf_torch.train import losses, stage1
from torch_helpers import flatten_jax, port_config, port_occ_field

torch.set_num_threads(1)
N = 32
JCFG = jocc.OccFieldConfig(num_layers=4, hidden_dim=128, feat_size=128,
                           skips=(2,))
JRCFG = juni.UnisurfConfig(near=1.2, far=5.0, radius=1.2, interval_start=0.6,
                           interval_end=0.05, interval_decay=1e-3,
                           num_points_in=8, num_points_out=4,
                           ray_marching_steps=16)
JTCFG = jstage1.Stage1TrainConfig(learning_rate=1e-3, milestone_iters=(),
                                  n_training_points=N, normal_after=0,
                                  weights=jlosses.Stage1LossWeights())


def _port_tcfg():
    return stage1.Stage1TrainConfig(
        learning_rate=1e-3, milestone_iters=(), n_training_points=N,
        normal_after=0, weights=losses.Stage1LossWeights())


def _batch():
    k = jax.random.PRNGKey(3)
    return {
        "pixels": jax.random.uniform(k, (N, 2), minval=-0.5, maxval=0.5),
        "rgb_gt": jnp.full((N, 3), 0.4),
        "camera_mat": jnp.eye(4),
        "world_mat": jnp.eye(4).at[2, 3].set(-3.0),
        "normal_gt": jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1)),
        "norm_mask": jnp.ones((N,), bool),
        "mask_gt": jnp.ones((N,)),
        "mask_valid": jnp.ones((N,), bool),
    }


def _noise(key, s):
    k_phase, k_n1, k_n2, k_jit = jax.random.split(key, 4)
    u = lambda k, shape: torch.as_tensor(np.array(
        jax.random.uniform(k, shape, dtype=jnp.float32)))
    return {"phase": u(k_phase, ()), "hit": u(k_n1, (N, s)),
            "miss": u(k_n2, (N, s)), "jitter": u(k_jit, (N, 3))}


@pytest.fixture(scope="module")
def reference():
    """JAX's step (plain routes) and its gradients, at it=100."""
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    batch, key = _batch(), jax.random.PRNGKey(5)
    init, step = jstage1.make_stage1_train_step(JCFG, JRCFG, JTCFG)
    opt0 = init(jp)
    p1, _, terms = step(jp, opt0, batch, 100.0, key, use_outside=True)

    def loss_fn(params):
        out = juni.render_unisurf(params, JCFG, JRCFG, batch["pixels"],
                                  batch["camera_mat"], batch["world_mat"],
                                  it=100.0, key=key, use_outside=True,
                                  train=True)
        return jlosses.stage1_loss(
            out, batch["rgb_gt"], JTCFG.weights, batch["normal_gt"],
            batch["norm_mask"], batch["mask_gt"], batch["mask_valid"])["loss"]

    grads = flatten_jax(jax.grad(loss_fn)(jp))
    return jp, batch, key, flatten_jax(p1), float(terms["loss"]), grads


def _port_step(jp, batch, key, fused):
    cfg, field = port_occ_field(jp, JCFG)
    rcfg = port_config(JRCFG, UnisurfConfig)
    init, step = stage1.make_stage1_train_step(
        cfg, rcfg, _port_tcfg(), use_fused_radiance=fused)
    opt = init(field)
    tb = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
    terms = step(field, opt, tb, 100, _noise(key, 12), use_outside=True)
    params = {k.replace(".", "/"): v.detach().numpy()
              for k, v in field.named_parameters()}
    grads = {k.replace(".", "/"): v.grad.numpy()
             for k, v in field.named_parameters()}
    return float(terms["loss"]), params, grads, opt


def test_step_matches_jax_plain_routes(reference):
    jp, batch, key, p_ref, loss_ref, g_ref = reference
    loss, params, grads, opt = _port_step(jp, batch, key, fused=False)
    assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref)
    assert set(grads) == set(g_ref)
    for k, g in g_ref.items():
        scale = np.abs(g).max() + 1e-8
        np.testing.assert_allclose(grads[k] / scale, g / scale, rtol=0,
                                   atol=1e-4, err_msg=k)
        big = np.abs(g) > 1e-6
        np.testing.assert_allclose(params[k][big], p_ref[k][big], rtol=0,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(params[k], p_ref[k], rtol=0, atol=5e-4,
                                   err_msg=k)
    assert all(int(s) == 1 for s in opt["step"].values())


def test_fused_route_matches_jax_plain_route(reference):
    jp, batch, key, p_ref, loss_ref, _ = reference
    loss, params, _, _ = _port_step(jp, batch, key, fused=True)
    assert abs(loss - loss_ref) < 2e-3
    for k, v in p_ref.items():
        np.testing.assert_allclose(params[k], v, rtol=0, atol=5e-4,
                                   err_msg=k)


def test_multistep_lr_and_masked_mean():
    from psnerf_torch.train.optim import multistep_lr

    assert multistep_lr(1e-3, (), 0.5, 10) == 1e-3
    assert multistep_lr(1e-3, (5, 10), 0.5, 9) == 5e-4
    assert multistep_lr(1e-3, (5, 10), 0.5, 10) == 2.5e-4
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    assert float(losses.masked_mean(x, torch.tensor([True, False]))) == 1.5
    assert float(losses.masked_mean(x, torch.tensor([False, False]))) == 0.0


# ------------------------------------------------------------------ runner

def _cfgs(scene_dir):
    jcfg = JStage1Config(
        field=jocc.OccFieldConfig(num_layers=4, hidden_dim=32, feat_size=32,
                                  octaves_pe=2, octaves_pe_views=2,
                                  skips=(2,)),
        render=dataclasses.replace(JRCFG, num_points_in=8),
        train=dataclasses.replace(JTCFG, n_training_points=64),
        data_dir=scene_dir, inten_normalize=None, checkpoint_every=100000,
        backup_every=5, visualize_every=0)
    cfg = Stage1Config(
        field=port_config(jcfg.field, OccFieldConfig),
        render=port_config(jcfg.render, UnisurfConfig),
        train=dataclasses.replace(_port_tcfg(), n_training_points=64),
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
           if f.name not in ("field", "render", "train")})
    return jcfg, cfg


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from psnerf_torch.data.synthetic import generate_synthetic_scene

    d = str(tmp_path_factory.mktemp("stage1_scene"))
    generate_synthetic_scene(d, n_views=2, n_test=0, n_lights=3, hw=(24, 24))
    return d


def test_runner_trains_logs_and_resumes(scene_dir, tmp_path):
    from psnerf_torch.runners.stage1 import Stage1Runner

    _, cfg = _cfgs(scene_dir)
    wd = str(tmp_path / "run")
    r = Stage1Runner(cfg, wd, seed=0, resume=False, device="cpu")
    assert not r.use_fused_occ and not r.use_fused_radiance
    r.train(6, log_every=3)
    recs = [json.loads(l) for l in open(os.path.join(wd, "metrics.jsonl"))]
    assert [x["it"] for x in recs] == [3, 6]
    assert all(np.isfinite(x["loss"]) for x in recs)
    assert os.path.exists(os.path.join(wd, "checkpoints", "model.npz"))
    assert os.path.exists(os.path.join(wd, "checkpoints", "model_5.npz")) \
        is False                              # saved at ckpt cadence and end
    r2 = Stage1Runner(cfg, wd, seed=1, device="cpu")
    assert r2.it == 6
    for (k, a), b in zip(r.field.state_dict().items(),
                         r2.field.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    for k in r.opt_state["m"]:
        torch.testing.assert_close(r.opt_state["m"][k], r2.opt_state["m"][k])
        assert int(r2.opt_state["step"][k]) == 6
    r2.train(8, log_every=100)
    assert r2.it == 8
    with pytest.raises(ValueError, match="fused radiance"):
        Stage1Runner(cfg, str(tmp_path / "x"), device="cpu",
                     use_fused_radiance=True)


def test_checkpoints_cross_both_ways(scene_dir, tmp_path):
    from psnerf_tpu.runners.stage1 import Stage1Runner as JRunner
    from psnerf_tpu.train import checkpoints as jck
    from psnerf_torch.runners.stage1 import Stage1Runner

    jcfg, cfg = _cfgs(scene_dir)
    wd = str(tmp_path / "cross")
    jr = JRunner(jcfg, wd, seed=0, resume=False)
    jr.save(7)
    ref = flatten_jax({"params": jr.params, "opt": jr.opt_state})
    r = Stage1Runner(cfg, wd, seed=3, device="cpu")
    assert r.it == 7
    for k, v in r.field.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      ref["params/" + k.replace(".", "/")])
    r.train(9, log_every=100)
    path = os.path.join(wd, "checkpoints", "model.npz")
    tree, scalars = jck.load_checkpoint(
        path, {"params": jr.params, "opt": jr.opt_state})
    assert scalars["it"] == 9
    got = flatten_jax(tree)
    for k, v in r.field.state_dict().items():
        np.testing.assert_array_equal(got["params/" + k.replace(".", "/")],
                                      v.numpy())
    for k, v in r.opt_state["step"].items():
        assert int(got["opt/step/" + k]) == int(v) == 2
