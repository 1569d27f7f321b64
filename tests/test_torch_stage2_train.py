"""psnerf_torch's stage-2 training against psnerf_tpu's, on the 32x32
synthetic scene of test_torch_stage2_eval.py (ragged light counts 6, 5, 4;
vis_plus on), one parameter set carried across by a JAX checkpoint.

Tolerances: the module-parity levels of PARITY.md (1e-5 abs in f32), and
for outputs that carry the SG specular term (rgb, rough) the 1e-3 relative
bar of test_torch_frame.py (its sharpest lobe turns one f32 rounding step
into up to 2.2e4 ulp). The step is held at the stage-1 step test's bars:
loss terms 1e-5 relative; gradients 1e-4 of each leaf's scale; params 1e-5
where |g| > 1e-6 and 5e-4 everywhere (Adam moves a param whose near-zero
gradient flips sign by up to lr). Each test names the bar it uses.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.config import Stage2Config as JStage2Config
from psnerf_tpu.core.rays import get_camera_params as jcamera
from psnerf_tpu.data.stage2 import sample_stage2_batch as jsample
from psnerf_tpu.data.synthetic import (generate_synthetic_scene as jgen,
                                       write_stage1_exports as jexports)
from psnerf_tpu.eval.evaluation import evaluate_outputs as jevaluate_outputs
from psnerf_tpu.fields.psnet import PSNetConfig as JPSNetConfig
from psnerf_tpu.render.shading import render_psnet as jrender
from psnerf_tpu.runners.stage2 import Stage2Runner as JRunner
from psnerf_tpu.train import checkpoints as jck
from psnerf_tpu.train.losses import Stage2LossWeights as JWeights
from psnerf_tpu.train.losses import stage2_loss as jstage2_loss
from psnerf_tpu.train.stage2 import Stage2TrainConfig as JTrainConfig
from psnerf_tpu.train.stage2 import \
    light_direction_error_deg as jlight_error
from psnerf_tpu.train.stage2 import make_stage2_train_step as jmake_step
from psnerf_torch.data import stage2 as ds2
from psnerf_torch.eval.evaluation import evaluate_outputs
from psnerf_torch.render.shading import render_psnet
from psnerf_torch.runners.stage2 import Stage2Runner
from psnerf_torch.train import losses, stage2
from psnerf_torch.train.checkpoints import load_checkpoint
from torch_helpers import flatten_jax, port_stage2_config, t

torch.set_num_threads(1)
SCENE_KW = dict(n_views=3, n_test=1, n_lights=6, hw=(32, 32),
                ragged_lights=True)
TILE = 256
N_PIX, LIGHT_BS, VIS_NUM = 256, 4, 4
SPECULAR_RTOL = 1e-3        # test_torch_frame.py's bar for the SG term


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("t2_train_scene"))
    jgen(d, **SCENE_KW)
    jexports(d, os.path.join(d, "exports"), n_vis_plus=6)
    return d


def _jcfg(scene, **train_kw):
    return JStage2Config(
        net=JPSNetConfig(mlp_width=32, sg_mlp_width=16, normal_mlp_width=32,
                         vis_mlp_width=32, vis_mlp_depth=4, vis_mlp_skip_at=2,
                         n_freqs_xyz=4, normal_n_freqs_xyz=4, light_int=1.2,
                         normal_jitter_std=0.02),
        train=JTrainConfig(**train_kw),
        data_dir=scene, stage1_shape_path=os.path.join(scene, "exports"),
        inten_normalize=None, light_bs=LIGHT_BS, vis_train_num=VIS_NUM,
        num_pixels=N_PIX, train_all_pixels=False, ckpt_freq=100000)


@pytest.fixture(scope="module")
def runners(scene, tmp_path_factory):
    """A JAX runner that writes its initial checkpoint, and a port runner on
    the CPU that resumes from it: one parameter set, one dataset."""
    wd = str(tmp_path_factory.mktemp("t2_train_wd"))
    jcfg = _jcfg(scene)
    jr = JRunner(jcfg, wd, resume=False)
    jr.save(0)
    pr = Stage2Runner(port_stage2_config(jcfg), wd, device="cpu")
    return jr, pr


def _jax_batch(jr, view, seed):
    """JAX's sampler batch, and the vis_plus pool rows it drew (recovered by
    matching light_vis_train against the pool's directions)."""
    b = jsample(jr.data, view, jax.random.PRNGKey(seed), N_PIX, LIGHT_BS,
                vis_train_num=VIS_NUM, light_init_dirs=jr.light_init_dirs)
    b = {k: np.asarray(v) for k, v in b.items()}
    pool = np.concatenate([np.asarray(jr.data["vis_plus_dirs"][view]),
                           np.asarray(jr.light_init_dirs[view])])
    d2 = ((b["light_vis_train"][:, None] - pool[None]) ** 2).sum(-1)
    sidx = d2.argmin(1)
    assert (d2.min(1) == 0).all()
    return b, sidx


def _port_batch(b, sidx, pr, view):
    return ds2.gather_stage2_batch(pr.data, torch.tensor([view]),
                                   t(b["lidx"]), t(b["pix"]), t(sidx),
                                   pr.light_init_dirs)


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("view,seed", [(0, 1), (1, 2), (2, 3)])
def test_gather_matches_jax_batch(runners, view, seed):
    """At JAX's own draws the gather gives JAX's batch, array for array."""
    jr, pr = runners
    np.testing.assert_array_equal(pr.light_init_dirs.numpy(),
                                  np.asarray(jr.light_init_dirs))
    b, sidx = _jax_batch(jr, view, seed)
    got = _port_batch(b, sidx, pr, view)
    assert set(got) == set(b)
    for k, v in b.items():
        g = got[k].numpy()
        assert g.shape == v.shape, k
        np.testing.assert_array_equal(g, v.astype(g.dtype), err_msg=k)


def _draw(pr, view, n_pix, seed, in_mask=True):
    gen = torch.Generator().manual_seed(seed)
    return ds2.draw_stage2_indices(pr.data, torch.tensor([view]), n_pix,
                                   LIGHT_BS, gen, sample_in_mask=in_mask,
                                   vis_train_num=VIS_NUM)


@pytest.mark.parametrize("view", [0, 2])
def test_draw_inside_mask_and_real_lights(runners, view):
    """Distinct pixels, all inside the object mask when it holds enough;
    distinct real lights only (view 2 has 4 of the 6 padded light rows);
    distinct vis_plus pool rows, none of them a padded light."""
    _, pr = runners
    mask = pr.data["object_masks"][view].numpy()
    n_real = int(pr.data["light_count"][view])
    n_vp = pr.data["vis_plus_dirs"].shape[1]
    for seed in range(5):
        idx = {k: v.numpy() for k, v in _draw(pr, view, 64, seed).items()}
        assert len(set(idx["pix"])) == 64 and mask[idx["pix"]].all()
        assert len(set(idx["lidx"])) == LIGHT_BS
        assert (idx["lidx"] < n_real).all()
        assert len(set(idx["sidx"])) == VIS_NUM
        assert (idx["sidx"] < n_vp + n_real).all()
    lights = np.concatenate([_draw(pr, view, 64, s)["lidx"].numpy()
                             for s in range(20)])
    assert set(lights) == set(range(n_real))


def test_draw_when_mask_holds_too_few_pixels(runners):
    """Asking for more pixels than the mask holds gives every mask pixel
    and then out-of-mask ones, the same set as JAX's Gumbel top-k (the
    lowest-index zero-weight pixels)."""
    jr, pr = runners
    mask = pr.data["object_masks"][0].numpy()
    n_pix = int(mask.sum()) + 40
    pix = _draw(pr, 0, n_pix, 0)["pix"].numpy()
    assert len(set(pix)) == n_pix
    assert set(np.nonzero(mask)[0]) <= set(pix)
    assert (~mask[pix]).sum() == 40
    ref = np.asarray(jsample(jr.data, 0, jax.random.PRNGKey(0), n_pix,
                             LIGHT_BS)["pix"])
    assert set(ref) == set(pix)


def test_draw_without_mask(runners):
    _, pr = runners
    pix = _draw(pr, 1, 500, 0, in_mask=False)["pix"].numpy()
    assert len(set(pix)) == 500 and (pix < 32 * 32).all()
    assert (~pr.data["object_masks"][1].numpy()[pix]).any()


# ---------------------------------------------------------------- shading

def _jax_noise(key, n):
    """The jitter draws of render_psnet(key=key), as the port's noise."""
    k1, k2 = jax.random.split(key)
    return {"xyz": t(jax.random.normal(k1, (n, 3))),
            "normal": t(jax.random.normal(k2, (n, 3)))}


def _render_inputs(jr, b):
    rd, _ = jcamera(jnp.asarray(b["uv"]), jnp.asarray(b["pose"]),
                    jnp.asarray(b["intrinsics"]))
    ld = np.asarray(jr.params["light_dirs"])[b["l_slt"]]
    ld = ld / np.linalg.norm(ld, axis=-1, keepdims=True)
    li = np.asarray(jr.params["light_ints"])[b["l_slt"], 0]
    return (b["points"], b["normal"], b["surface_mask"], np.asarray(rd), ld,
            li)


def test_render_psnet_training_outputs_match_jax(runners):
    """The jittered heads and vis_train at 1e-5 abs; the eval outputs too,
    rgb and rough (SG specular) at the 1e-3 relative bar."""
    jr, pr = runners
    b, _ = _jax_batch(jr, 1, 7)
    key = jax.random.PRNGKey(11)
    args = _render_inputs(jr, b)
    ref = jrender(jr.params["model"], jr.cfg.net,
                  *[jnp.asarray(a) for a in args], key=key,
                  light_vis_train=jnp.asarray(b["light_vis_train"]))
    with torch.no_grad():
        got = render_psnet(pr.params["model"], pr.cfg.net,
                           *[t(a) for a in args],
                           noise=_jax_noise(key, N_PIX),
                           light_vis_train=t(b["light_vis_train"]))
    assert set(got) == set(ref)
    for k in ("albedo_jitter", "rough_jitter", "normal_jitter", "vis_train"):
        assert k in got
    for k, r in ref.items():
        r, g = np.asarray(r), got[k].numpy()
        assert g.shape == r.shape, k
        if k in ("rgb", "rough"):
            np.testing.assert_allclose(g, r, rtol=SPECULAR_RTOL, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=k)


def test_eval_render_has_no_training_outputs(runners):
    jr, pr = runners
    b, _ = _jax_batch(jr, 0, 3)
    with torch.no_grad():
        got = render_psnet(pr.params["model"], pr.cfg.net,
                           *[t(a) for a in _render_inputs(jr, b)])
    assert not {"albedo_jitter", "rough_jitter", "normal_jitter",
                "vis_train"} & set(got)


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("branch", ["vis_plus", "stage1_vis_on_vis_train",
                                    "stage1_vis_on_render"])
def test_stage2_loss_matches_jax(branch):
    """All terms at 1e-6 relative on one set of random outputs, for each of
    the three visibility supervisions, with the warm-up's overrides."""
    rng = np.random.default_rng(5)
    n, n_l, n_v = 300, 4, 3
    u = lambda *s: rng.uniform(size=s).astype(np.float32)
    out = {"rgb": u(n_l, n, 3), "albedo": u(n, 3), "albedo_jitter": u(n, 3),
           "sg_weight": u(n, 27), "rough_jitter": u(n, 27),
           "visibility": u(n_l, n, 1), "normal_pred": u(n, 3) - 0.5,
           "normal_values": u(n, 3) - 0.5, "normal_jitter": u(n, 3) - 0.5,
           "network_object_mask": rng.uniform(size=n) > 0.2}
    kw = {"vis_gt": u(n_l, n)}
    if branch != "stage1_vis_on_render":
        out["vis_train"] = u(n_v, n) if branch == "vis_plus" else u(n_l, n)
    if branch == "vis_plus":
        kw["vis_train_gt"] = u(n_v, n)
    rgb_gt, obj = u(n_l, n, 3), rng.uniform(size=n) > 0.1
    over = {"sg_rgb_weight": 0.0, "albedo_smooth_weight": 0.0,
            "rough_smooth_weight": 0.0, "vis_weight": 10.0}
    for override in (None, over):
        w = JWeights(loss_type="L1" if override else "L2")
        ref = jstage2_loss({k: jnp.asarray(v) for k, v in out.items()},
                           jnp.asarray(rgb_gt), jnp.asarray(obj), w,
                           **{k: jnp.asarray(v) for k, v in kw.items()},
                           weights_override=override)
        got = losses.stage2_loss(
            {k: t(v) for k, v in out.items()}, t(rgb_gt), t(obj),
            losses.Stage2LossWeights(**dataclasses.asdict(w)),
            **{k: t(v) for k, v in kw.items()}, weights_override=override)
        assert set(got) == set(ref)
        for k, r in ref.items():
            np.testing.assert_allclose(float(got[k]), float(r), rtol=1e-6,
                                       err_msg=k)


# ------------------------------------------------------------------- step

def _jax_loss_and_grads(cfg, tcfg, params, batch, it, key):
    """The loss terms and gradients of psnerf_tpu's stage-2 step
    (train/stage2.py:79-117), which its step does not return."""
    w = tcfg.weights

    def loss_fn(p):
        wf = jnp.float32(it < tcfg.warmup_iters and tcfg.train_order)
        ld = p["light_dirs"][batch["l_slt"]]
        ld = ld / jnp.maximum(jnp.linalg.norm(ld, axis=-1, keepdims=True),
                              1e-12)
        li = p["light_ints"][batch["l_slt"]][:, 0]
        rd, _ = jcamera(batch["uv"], batch["pose"], batch["intrinsics"])
        out = jrender(p["model"], cfg, batch["points"], batch["normal"],
                      batch["surface_mask"], rd, ld, li, key=key,
                      light_vis_train=batch["light_vis_train"])
        terms = jstage2_loss(out, batch["rgb_gt"], batch["object_mask"], w,
                             vis_gt=batch["visibility"],
                             vis_train_gt=batch["vis_train_gt"],
                             weights_override={
                                 "sg_rgb_weight": (1 - wf) * w.sg_rgb_weight,
                                 "albedo_smooth_weight":
                                     (1 - wf) * w.albedo_smooth_weight,
                                 "rough_smooth_weight":
                                     (1 - wf) * w.rough_smooth_weight,
                                 "vis_weight": wf * tcfg.warmup_vis_weight
                                 + (1 - wf) * w.vis_weight})
        return terms["loss"], terms

    (_, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return terms, grads


def _flat_params(params):
    out = {f"model/{k}": v.detach().numpy().copy()
           for k, v in stage2.model_params(params["model"]).items()}
    out.update({k: params[k].numpy().copy()
                for k in ("light_dirs", "light_ints")})
    return out


@pytest.mark.parametrize("it,joint", [(10, True), (6000, True),
                                      (6000, False)])
def test_step_matches_jax(runners, it, joint):
    """One step in the warm-up (it = 10) and one after it (it = 6000; also
    with the normal net not trained jointly), from one parameter set,
    batch and jitter draws: the stage-1 step test's bars. In the warm-up
    albedo, rough and the light tables stay bit for bit; after it only the
    gathered light rows move, as in JAX; without normal_joint the normal
    net stays bit for bit."""
    jr, pr = runners
    jcfg = dataclasses.replace(jr.cfg.net, normal_joint=joint)
    jt = JTrainConfig(milestone_iters=(3000,))
    b, sidx = _jax_batch(jr, 2, 21)
    key = jax.random.PRNGKey(it)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    # the initial visibility net's output is below 0 on most points, so the
    # clipped visibility zeroes the rgb and its gradients; lifting its
    # output bias by 0.5 (in both packages) lets the rgb loss reach albedo,
    # rough and the lights. Without it, albedo's gradient after the warm-up
    # is the smoothness term alone, a near-cancellation of sigmoid slopes at
    # points 0.01 apart, which f32 resolves to ~1e-4 of its scale: JAX's own
    # f32 gradient lies 1.7e-4 of its scale from an f64 run (measured)
    jparams = jax.tree_util.tree_map(lambda x: x, jr.params)
    vis_last = jparams["model"]["visibility"][-1]
    vis_last["b"] = vis_last["b"] + 0.5
    jterms, jgrads = _jax_loss_and_grads(jcfg, jt, jparams, jb, it, key)
    init, jstep = jmake_step(jcfg, jt)
    jp1, _, jterms1 = jstep(jparams, init(jparams), jb, float(it), key)
    g_ref = flatten_jax(jgrads)
    p_ref = flatten_jax(jp1)

    cfg = dataclasses.replace(pr.cfg.net, normal_joint=joint)
    tcfg = port_stage2_config(dataclasses.replace(jr.cfg, train=jt)).train
    pinit, pstep = stage2.make_stage2_train_step(cfg, tcfg)
    import copy
    params = {"model": copy.deepcopy(pr.params["model"]),
              "light_dirs": pr.params["light_dirs"].clone(),
              "light_ints": pr.params["light_ints"].clone()}
    with torch.no_grad():
        params["model"]["visibility"][-1].b.add_(0.5)
    p0 = _flat_params(params)
    batch = _port_batch(b, sidx, pr, 2)
    noise = _jax_noise(key, N_PIX)
    terms, grads = pstep.loss_and_grads(params, batch, it, noise)
    opt = pinit(params)
    terms1 = pstep(params, opt, batch, it, noise)

    assert set(terms) == set(jterms)
    for k, r in jterms.items():
        assert abs(float(terms[k]) - float(r)) <= 1e-5 * abs(float(r)) + 1e-12, k
        assert float(terms1[k]) == float(terms[k]), k
    assert float(terms1["sg_lr"]) == pytest.approx(float(jterms1["sg_lr"]))
    got_p = _flat_params(params)
    assert set(got_p) == set(p_ref)
    for k, g in g_ref.items():
        gk = grads[k.removeprefix("model/")].numpy()
        scale = np.abs(g).max() + 1e-8
        np.testing.assert_allclose(gk / scale, g / scale, rtol=0, atol=1e-4,
                                   err_msg=k)
        big = np.abs(g) > 1e-6
        np.testing.assert_allclose(got_p[k][big], p_ref[k][big], rtol=0,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got_p[k], p_ref[k], rtol=0, atol=5e-4,
                                   err_msg=k)
    moved = lambda d: {k for k in d if not np.array_equal(d[k], p0[k])}
    ref_moved = moved(p_ref)
    assert moved(got_p) == ref_moved
    frozen = {k for k in p0 if k.startswith(("model/albedo", "model/rough"))}
    if it < jt.warmup_iters:
        assert not (frozen | {"light_dirs", "light_ints"}) & ref_moved
    else:
        assert frozen <= ref_moved
        for k in ("light_dirs", "light_ints"):
            rows = np.any(got_p[k] != p0[k], axis=-1)
            ref_rows = np.any(p_ref[k] != p0[k], axis=-1)
            np.testing.assert_array_equal(rows, ref_rows)
            assert set(np.nonzero(rows)[0]) == set(b["l_slt"].tolist())
    normal = {k for k in p0 if k.startswith("model/normal")}
    assert bool(normal & ref_moved) == joint
    assert int(opt["light_dirs"]["step"]) == (0 if it < 5000 else 1)


def test_light_direction_error_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(40, 3)).astype(np.float32)
    b = rng.normal(size=(40, 3)).astype(np.float32)
    ref = float(jlight_error(jnp.asarray(a), jnp.asarray(b)))
    got = float(stage2.light_direction_error_deg(t(a), t(b)))
    assert got == pytest.approx(ref, rel=1e-5)
    z = t(np.asarray([[0.0, 0.0, 2.0], [1.0, 0.0, 0.0]], np.float32))
    y = t(np.asarray([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]], np.float32))
    assert float(stage2.light_direction_error_deg(z, y)) == \
        pytest.approx(45.0, abs=1e-4)


def test_milestones_in_iterations(scene, tmp_path):
    """Epoch milestones become epochs x views x light_bs iterations, and a
    direct iteration schedule is kept when no epochs are configured."""
    jcfg = dataclasses.replace(_jcfg(scene), sched_milestones_epochs=(2, 5))
    jr = JRunner(jcfg, str(tmp_path / "j"), resume=False)
    pr = Stage2Runner(port_stage2_config(jcfg), str(tmp_path / "p"),
                      resume=False, device="cpu")
    assert pr.tcfg.milestone_iters == tuple(jr.tcfg.milestone_iters) \
        == (2 * 3 * 4, 5 * 3 * 4)
    assert pr.light_bs == jr.light_bs == 4
    assert pr.num_pixels == jr.num_pixels == N_PIX
    direct = dataclasses.replace(
        jcfg, sched_milestones_epochs=(),
        train=dataclasses.replace(jcfg.train, milestone_iters=(7,)))
    p2 = Stage2Runner(port_stage2_config(direct), str(tmp_path / "q"),
                      resume=False, device="cpu")
    assert tuple(p2.tcfg.milestone_iters) == (7,)


# ------------------------------------------------------ runner, checkpoints

def test_checkpoints_cross_both_ways(scene, tmp_path):
    """The key sets of params/ and opt/ are JAX's; a JAX training
    checkpoint resumes in the port, and the port's in JAX."""
    jcfg = _jcfg(scene)
    wd = str(tmp_path / "cross")
    jr = JRunner(jcfg, wd, resume=False)
    jr.train(2, log_every=1)
    ref = flatten_jax({"params": jr.params, "opt": jr.opt_state})
    pr = Stage2Runner(port_stage2_config(jcfg), wd, seed=3, device="cpu")
    assert pr.it == 2
    flat, _ = load_checkpoint(os.path.join(wd, "checkpoints", "model.npz"))
    from psnerf_torch.train.checkpoints import flatten_tree

    mine = flatten_tree({"params": pr.params, "opt": pr.opt_state})
    assert set(mine) == set(ref) == set(flat)
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    pr.train(5, log_every=100)
    jr2 = JRunner(jcfg, wd, seed=5)
    assert jr2.it == 5
    got = flatten_jax({"params": jr2.params, "opt": jr2.opt_state})
    mine = flatten_tree({"params": pr.params, "opt": pr.opt_state})
    for k, v in mine.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(got["opt/model/step/visibility/0/w"]) == 5
    # the warm-up froze albedo and the lights: their steps never counted
    assert int(got["opt/model/step/albedo/0/w"]) == 0
    assert int(got["opt/light_dirs/step"]) == 0
    tree, scalars = jck.load_checkpoint(
        os.path.join(wd, "checkpoints", "model.npz"),
        {"params": jr.params, "opt": jr.opt_state})
    assert scalars["it"] == 5


def test_runner_cadence_backups_plot_and_halt(scene, tmp_path):
    jcfg = dataclasses.replace(_jcfg(scene, warmup_iters=3), ckpt_freq=2)
    wd = str(tmp_path / "run")
    pr = Stage2Runner(port_stage2_config(jcfg), wd, resume=False,
                      device="cpu")
    logs = []
    pr.train(6, log_every=3, plot_every=4,
             on_log=lambda it, terms: logs.append((it, terms)))
    assert [it for it, _ in logs] == [3, 6]
    assert all(np.isfinite(x["loss"]) and "light_direction_error" in x
               for _, x in logs)
    recs = [json.loads(line) for line in open(os.path.join(wd,
                                                           "metrics.jsonl"))]
    assert [r["it"] for r in recs] == [3, 4, 6]
    assert "train_psnr" in recs[1] and "test_psnr" in recs[1]
    assert os.path.exists(os.path.join(wd, "plots", "it_4.png"))
    ck = sorted(os.listdir(os.path.join(wd, "checkpoints")))
    assert ck == ["model.npz"]        # a numbered backup every 2 x 10 steps
    pr.save(20)
    assert os.path.exists(os.path.join(wd, "checkpoints", "model_20.npz"))
    with torch.no_grad():
        pr.params["model"]["visibility"][0].b.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="it=7"):
        pr.train(9, log_every=3)


def test_plot_to_disk_matches_jax(runners, tmp_path):
    jr, pr = runners
    ref = jr.plot_to_disk(str(tmp_path / "j.png"), tile=TILE)
    got = pr.plot_to_disk(str(tmp_path / "p.png"), tile=TILE)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, abs=0.011), k
    from psnerf_torch.data.scene import imread

    assert imread(str(tmp_path / "p.png")).shape == (2 * 32, 3 * 32, 3)


def test_evaluate_outputs_matches_jax(runners, scene, tmp_path):
    """The same numbers from one eval directory in both packages, and
    JAX's status for the missing LPIPS weights."""
    jr, _ = runners
    out = str(tmp_path / "eval")
    jr.evaluate(out, split="test", tile=TILE)
    got = evaluate_outputs(scene, out)
    ref = jevaluate_outputs(scene, out)
    assert set(got) == set(ref)
    assert got["lpips"] is None and got["lpips_status"] == ref["lpips_status"]
    for k in ("psnr", "ssim", "normal_mae"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k


# ---------------------------------------------------------------- outcome

def _pipeline_cfg(scene_dir):
    """tests/test_pipeline.py:160-179's stage-2 config."""
    return JStage2Config(
        net=JPSNetConfig(mlp_width=48, sg_mlp_width=16, normal_mlp_width=48,
                         vis_mlp_width=48, vis_mlp_depth=4,
                         vis_mlp_skip_at=2, n_freqs_xyz=6,
                         normal_n_freqs_xyz=6, light_int=1.2,
                         xyz_jitter_std=0.01),
        train=JTrainConfig(sg_learning_rate=1e-3, light_learning_rate=5e-4,
                           train_order=True, warmup_iters=40,
                           weights=JWeights()),
        data_dir=scene_dir, stage1_shape_path=os.path.join(scene_dir,
                                                           "exports"),
        inten_normalize=None, light_bs=4, vis_train_num=4, num_pixels=256,
        train_all_pixels=False, ckpt_freq=100000)


def test_runner_outcome_on_the_pipeline_scene(tmp_path):
    """160 iterations of the port's runner at the pipeline test's stage-2
    config on the analytic export of its scene: the rgb loss gate of
    tests/test_pipeline.py:190 and its normal-MAE gate (:213). Its PSNR
    gate (> 14, :212) was set on a trained stage-1 export; on the analytic
    export JAX's own runner scores about 11 (the test view sees a side of
    the sphere that no train view sees), so PSNR is held against JAX's
    runner on the same scene and config: no more than 1 dB under the lower
    of its seeds 0 and 1."""
    from psnerf_torch.data.synthetic import (generate_synthetic_scene,
                                             write_stage1_exports)

    d = str(tmp_path / "scene")
    generate_synthetic_scene(d, n_views=3, n_test=1, n_lights=6, hw=(32, 32),
                             radius=0.6, focal=40.0)
    write_stage1_exports(d, os.path.join(d, "exports"), n_vis_plus=8)
    jcfg = _pipeline_cfg(d)
    pr = Stage2Runner(port_stage2_config(jcfg), str(tmp_path / "wd"),
                      resume=False, device="cpu")
    logs = []
    pr.train(160, log_every=40, on_log=lambda it, terms: logs.append(terms))
    assert logs[-1]["sg_rgb_loss"] < 0.2
    pr.evaluate(str(tmp_path / "out"), split="test", tile=256)
    res = evaluate_outputs(d, str(tmp_path / "out"))
    assert res["normal_mae"] < 15, res
    ref = []
    for seed in (0, 1):
        jr = JRunner(jcfg, str(tmp_path / f"jwd{seed}"), seed=seed,
                     resume=False)
        jr.train(160, log_every=160)
        jr.evaluate(str(tmp_path / f"jout{seed}"), split="test", tile=256)
        ref.append(jevaluate_outputs(d, str(tmp_path / f"jout{seed}")))
    assert res["psnr"] > min(r["psnr"] for r in ref) - 1.0, (res, ref)
    assert res["normal_mae"] < max(r["normal_mae"] for r in ref) + 1.0
