"""psnerf_torch's stage-1 eval and shape export against psnerf_tpu's, on the
CPU at toy sizes (plain f32 routes on both sides):
  * light_visibility (faithful protocol, and the rescaled, chunked and
    guided ones) within 1e-5;
  * render_shape_extract: masks equal, points within 1e-4, normals within
    0.08 degrees (PARITY.md), visibility within 1e-4;
  * farthest_point_sampling_np: identical indices;
  * stage1_vis_strip: identical uint8 strips; render_phong within 5e-4;
  * Stage1Runner on a 16x16 synthetic scene, one checkpoint in both
    packages: render_view (masks equal, rgb, acc and phong within 5e-4),
    shape_extract (every exported array, light_dir.json equal), eval_views
    (PSNR within 1e-3 dB); train's visualisation strip and wall budget.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.ops.fps import farthest_point_sampling_np as jfps
from psnerf_tpu.render import marching as jmarch
from psnerf_tpu.render import phong as jphong
from psnerf_tpu.render import unisurf as juni
from psnerf_tpu.train.logging import stage1_vis_strip as jstrip
from psnerf_torch.fields import occupancy as occ
from psnerf_torch.ops.fps import farthest_point_sampling_np
from psnerf_torch.render import marching, phong, unisurf
from psnerf_torch.train.logging import stage1_vis_strip
from torch_helpers import j, port_config, port_occ_field, t, unit

torch.set_num_threads(1)
JCFG = jocc.OccFieldConfig(num_layers=4, hidden_dim=32, feat_size=32,
                           octaves_pe=2, octaves_pe_views=2, skips=(2,))
JRCFG = juni.UnisurfConfig(near=1.2, far=5.0, radius=1.2, interval_start=0.6,
                           interval_end=0.05, num_points_in=8,
                           num_points_out=4, ray_marching_steps=16)
NORMAL_DEG = 0.08


def _angles_deg(a, b):
    dot = np.clip(np.sum(a * b, -1), -1.0, 1.0)
    return np.degrees(np.arccos(dot))


@pytest.fixture(scope="module")
def field():
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    cfg, f = port_occ_field(jp, JCFG)
    return jp, cfg, f


def _camera(n):
    rng = np.random.default_rng(4)
    pixels = rng.uniform(-0.4, 0.4, size=(n, 2)).astype(np.float32)
    world = np.eye(4, dtype=np.float32)
    world[2, 3] = -3.0
    return pixels, np.eye(4, dtype=np.float32), world


def test_light_visibility_matches_jax(field):
    jp, cfg, f = field
    rng = np.random.default_rng(2)
    surf = (unit(rng, (40, 3)) * 0.6).astype(np.float32)
    ldir = unit(rng, (3, 3))
    ref = jmarch.light_visibility(lambda p: jocc.occ_alpha(jp, p, JCFG),
                                  j(surf), j(ldir), n_steps=16)
    with torch.no_grad():
        got = marching.light_visibility(
            lambda p: occ.occ_alpha(f, p, cfg), t(surf), t(ldir),
            n_steps=16)
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert float(got.min()) < 0.9          # some rays do pass the surface


@pytest.mark.parametrize("kw", [dict(rescale=True), dict(light_chunk=2),
                                dict(guide=True)])
def test_light_visibility_refuses_other_protocols(field, kw):
    """The protocols besides the faithful one (rescaled, light chunks, a
    guide grid) are not refused: each agrees with the JAX package within
    1e-5 (test_torch_export_protocols.py holds more cases)."""
    jp, cfg, f = field
    rng = np.random.default_rng(2)
    surf = (unit(rng, (40, 3)) * 0.6).astype(np.float32)
    ldir = unit(rng, (3, 3))
    jfn = lambda p: jocc.occ_alpha(jp, p, JCFG)
    jkw, pkw = dict(kw), dict(kw)
    if "guide" in kw:
        grid = np.asarray(jmarch.occupancy_guide_grid(jfn, res=16, dilate=1))
        jkw["guide"], pkw["guide"] = j(grid), t(grid)
    ref = jmarch.light_visibility(jfn, j(surf), j(ldir), n_steps=16, **jkw)
    got = marching.light_visibility(lambda p: occ.occ_alpha(f, p, cfg),
                                    t(surf), t(ldir), n_steps=16, **pkw)
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_render_shape_extract_matches_jax(field):
    jp, cfg, f = field
    pixels, K, world = _camera(64)
    rcfg = port_config(JRCFG, unisurf.UnisurfConfig)
    ldir = np.asarray([[0.0, 0.0, -1.0], [0.6, 0.0, 0.8]], np.float32)
    ref = juni.render_shape_extract(jp, JCFG, JRCFG, j(pixels), j(K),
                                    j(world), light_dir=j(ldir), n_steps=32)
    got = unisurf.render_shape_extract(f, cfg, rcfg, t(pixels), t(K),
                                       t(world), light_dir=t(ldir),
                                       n_steps=32)
    mask = got["mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(ref["mask"]))
    assert 0 < mask.sum() < len(mask)
    np.testing.assert_allclose(got["points"].numpy(),
                               np.asarray(ref["points"]), atol=1e-4, rtol=0)
    ang = _angles_deg(got["normal"].numpy()[mask],
                      np.asarray(ref["normal"])[mask])
    assert ang.max() < NORMAL_DEG, ang.max()
    assert (got["normal"].numpy()[~mask] == 0).all()
    np.testing.assert_allclose(got["visibility"].numpy(),
                               np.asarray(ref["visibility"]), atol=1e-4,
                               rtol=0)


def test_render_phong_matches_jax(field):
    jp, cfg, f = field
    pixels, K, world = _camera(64)
    ref = jphong.render_phong(jp, JCFG, JRCFG, j(pixels), j(K), j(world),
                              n_steps=32)["rgb"]
    got = phong.render_phong(f, cfg, port_config(JRCFG, unisurf.UnisurfConfig),
                             t(pixels), t(K), t(world), n_steps=32)["rgb"]
    assert (got.numpy() < 1.0).any() and (got.numpy() == 1.0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=0)


@pytest.mark.parametrize("seed,start", [(0, 0), (1, 5), (2, 17)])
def test_fps_matches_jax(seed, start):
    pts = np.random.default_rng(seed).normal(size=(500, 3))
    np.testing.assert_array_equal(farthest_point_sampling_np(pts, 16, start),
                                  jfps(pts, 16, start))


@pytest.mark.parametrize("with_gt_normal", [True, False])
def test_vis_strip_matches_jax(with_gt_normal):
    rng = np.random.default_rng(6)
    h, w = 8, 10
    render = {"rgb": rng.uniform(size=(h, w, 3)),
              "normal": rng.normal(size=(h, w, 3)),
              "mask": rng.uniform(size=(h, w)) > 0.5,
              "acc": rng.uniform(size=(h, w)),
              "phong": rng.uniform(size=(h, w, 3))}
    gt = rng.uniform(size=(h, w, 3))
    gt_n = rng.normal(size=(h, w, 3)) if with_gt_normal else None
    mask_gt = rng.uniform(size=(h, w))
    got = stage1_vis_strip(render, gt, gt_n, mask_gt)
    assert got.dtype == np.uint8
    assert got.shape == (h, w * (8 if with_gt_normal else 6), 3)
    np.testing.assert_array_equal(got, jstrip(render, gt, gt_n, mask_gt))


# ------------------------------------------------------------------ runner

def _cfgs(scene_dir):
    from psnerf_tpu.config import Stage1Config as JStage1Config
    from psnerf_tpu.train import losses as jlosses
    from psnerf_tpu.train import stage1 as jstage1
    from psnerf_torch.config import Stage1Config
    from psnerf_torch.train import losses, stage1

    jcfg = JStage1Config(
        field=JCFG, render=JRCFG,
        train=jstage1.Stage1TrainConfig(
            learning_rate=1e-3, milestone_iters=(), n_training_points=64,
            normal_after=0, weights=jlosses.Stage1LossWeights()),
        data_dir=scene_dir, inten_normalize=None, checkpoint_every=100000,
        backup_every=100000, visualize_every=0)
    cfg = Stage1Config(
        field=port_config(JCFG, occ.OccFieldConfig),
        render=port_config(JRCFG, unisurf.UnisurfConfig),
        train=stage1.Stage1TrainConfig(
            learning_rate=1e-3, milestone_iters=(), n_training_points=64,
            normal_after=0, weights=losses.Stage1LossWeights()),
        **{k.name: getattr(jcfg, k.name) for k in dataclasses.fields(jcfg)
           if k.name not in ("field", "render", "train")})
    return jcfg, cfg


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """A port runner trained 4 steps on the CPU, its checkpoint resumed by
    a JAX runner: both hold one parameter set."""
    from psnerf_torch.data.synthetic import generate_synthetic_scene
    from psnerf_torch.runners.stage1 import Stage1Runner
    from psnerf_tpu.runners.stage1 import Stage1Runner as JRunner

    root = tmp_path_factory.mktemp("stage1_export")
    scene = str(root / "scene")
    generate_synthetic_scene(scene, n_views=2, n_test=1, n_lights=3,
                             hw=(16, 16), focal=20.0)
    jcfg, cfg = _cfgs(scene)
    wd = str(root / "run")
    r = Stage1Runner(cfg, wd, seed=0, resume=False, device="cpu")
    r.train(4, log_every=100)
    jr = JRunner(jcfg, wd, seed=1)
    assert jr.it == r.it == 4
    return r, jr, root


def test_render_view_matches_jax(runners):
    r, jr, _ = runners
    got, ref = r.render_view(0, tile=64), jr.render_view(0, tile=64)
    assert got["rgb"].shape == (16, 16, 3) and got["mask"].shape == (16, 16)
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert 0 < got["mask"].sum() < got["mask"].size
    for k in ("rgb", "acc", "phong"):
        np.testing.assert_allclose(got[k], ref[k], atol=5e-4, rtol=0,
                                   err_msg=k)
    m = got["mask"]
    assert _angles_deg(got["normal"][m] / np.linalg.norm(
        got["normal"][m], axis=-1, keepdims=True), ref["normal"][m] /
        np.linalg.norm(ref["normal"][m], axis=-1, keepdims=True)).max() \
        < NORMAL_DEG


def test_shape_extract_matches_jax(runners):
    r, jr, root = runners
    kw = dict(visibility=True, vis_plus=True, vis_plus_num=4, tile=64,
              n_steps=32, vis_steps=16, seed=3)
    d_got, d_ref = str(root / "export_port"), str(root / "export_jax")
    timings = r.shape_extract(d_got, **kw)
    jr.shape_extract(d_ref, **kw)
    assert {"march_s", "vis_train_s", "vis_plus_s", "fps_s",
            "host_s"} <= set(timings)
    names = sorted(os.listdir(os.path.join(d_ref, "mask")))
    assert len(names) == 3                           # every view, "all"
    for name in names:
        load = lambda d, sub: np.load(os.path.join(d, sub, name))
        mask = load(d_got, "mask")
        np.testing.assert_array_equal(mask, load(d_ref, "mask"))
        assert mask.dtype == bool and mask.any()
        np.testing.assert_allclose(load(d_got, "points"),
                                   load(d_ref, "points"), atol=1e-4, rtol=0)
        ang = _angles_deg(load(d_got, "normal")[mask],
                          load(d_ref, "normal")[mask])
        assert ang.max() < NORMAL_DEG, (name, ang.max())
        for sub, n_l in (("visibility", 3), ("vis_plus", 4)):
            got = load(d_got, sub)
            assert got.shape == (n_l, 16, 16) and got.dtype == np.float32
            np.testing.assert_allclose(got, load(d_ref, sub), atol=1e-4,
                                       rtol=0, err_msg=sub)
            assert (got[:, ~mask] == 1.0).all()
    with open(os.path.join(d_got, "vis_plus", "light_dir.json")) as f:
        got_json = json.load(f)
    with open(os.path.join(d_ref, "vis_plus", "light_dir.json")) as f:
        assert got_json == json.load(f)


def test_eval_views_matches_jax(runners):
    r, jr, root = runners
    got = r.eval_views(str(root / "eval_port"), tile=64)
    ref = jr.eval_views(str(root / "eval_jax"), tile=64)
    assert [m["view"] for m in got] == [m["view"] for m in ref] and got
    for a, b in zip(got, ref):
        assert np.isfinite(a["psnr"]) and abs(a["psnr"] - b["psnr"]) < 1e-3
    name = f"view_{got[0]['view'] + 1:02d}"
    for sub in ("rgb", "normal", "mask", "acc", "phong"):
        assert os.path.exists(os.path.join(root, "eval_port", sub,
                                           name + ".png"))
    assert np.load(os.path.join(root, "eval_port", "normal",
                                name + ".npy")).shape == (16, 16, 3)
    with open(os.path.join(root, "eval_port", "metrics.json")) as f:
        assert json.load(f) == got


def test_train_writes_strip_and_keeps_its_wall_budget(runners, tmp_path):
    from psnerf_torch.data.scene import imread
    from psnerf_torch.runners.stage1 import Stage1Runner

    r, _, _ = runners
    wd = str(tmp_path / "vis")
    r2 = Stage1Runner(r.cfg, wd, seed=0, resume=False, device="cpu")
    r2.train(3, log_every=100, vis_every=2)
    strip = imread(os.path.join(wd, "vis", "it_2.png"))
    assert strip.shape == (2 * 16, 8 * 16, 3)       # 2 views x 8 panels
    assert not os.path.exists(os.path.join(wd, "vis", "it_3.png"))
    os.remove(os.path.join(wd, "checkpoints", "model.npz"))
    r2.train(10, log_every=100, vis_every=0, wall_budget_s=0)
    assert r2.it == 3
    r3 = Stage1Runner(r.cfg, wd, seed=1, device="cpu")
    assert r3.it == 3
