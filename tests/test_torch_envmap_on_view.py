"""Stage2Runner.render_envmap's on_view callback and spans on the CPU, at a
toy stage-2 scene the benchmark builds (benchmark/traffic/train_stage2.
build): the frames on_view receives against the benchmark's relight
reference (benchmark/reference/relight.py) at every surface pixel, with
the light sum at the visibility kernel's bf16 rounding points (its plain
version), over chunks of the runner's ENV_CHUNK; the PNGs the same with
and without the callback, and each the frame's 8-bit form; the spans of a
traced call."""

import copy
import functools
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import relight as rel
from benchmark.reference import stage2 as ref
from benchmark.traffic.relight_view import sky
from benchmark.traffic.train_stage2 import build
from psnerf_torch.data.scene import imread
from psnerf_torch.runners import stage2 as rs
from psnerf_torch.utils import profiling

torch.set_num_threads(2)
TOY = {"cfg": {"train": {"num_pixels": 256},
               "dataset_shape": {"hw": [24, 32], "n_lights": 12,
                                 "focal_px": 382.0, "cam_dist": 31.5,
                                 "light_spread": 0.6, "n_vis_plus": 8}}}
LIGHT_H = 12          # 288 texel lights: chunks of 128, 128 and 32
TILE = 256


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    run = harness.Run(harness.load_cell("s2_relight_bear"), 2_147_483_777,
                      0.1, False, "cpu", copy.deepcopy(TOY))
    runner, net, w0, scene, export = build(run)
    # the card's route: the light sum of the visibility kernel's plain
    # version, at its bf16 rounding points
    runner.render_view = functools.partial(runner.render_view,
                                           use_fused_vis=True)
    yield run, runner, net, w0, scene, export
    run.cleanup()


def _frames(runner, out_dir, env, **kw):
    got = {}
    runner.render_envmap(out_dir, env, light_h=LIGHT_H, tile=TILE,
                         on_view=lambda v, img: got.setdefault(v, img), **kw)
    return got


def test_on_view_frames_match_the_relight_reference(toy, tmp_path):
    run, runner, net, w0, scene, export = toy
    env = sky(5, LIGHT_H)
    got = _frames(runner, str(tmp_path / "a"), env)
    with open(os.path.join(scene, "params.json")) as f:
        params = json.load(f)
    views = params["view_test"]
    assert sorted(got) == list(range(len(views)))
    d = ref.load_views(scene, export, views, "cpu", images=False)
    w = params["imhw"][1]
    for v in got:
        idx = torch.nonzero(d["surface_mask"][v])[:, 0]
        uv = torch.stack([idx % w, idx // w], -1).float()
        want = rel.relight(w0, net, d["points"][v][idx], d["normals"][v][idx],
                           uv, d["poses_cv"][v], d["K"], env).numpy()
        frame = got[v].reshape(-1, 3)
        # the same rounding points and the chunks added in the same order:
        # float32 sums in another order (measured up to 4.2e-7)
        np.testing.assert_allclose(frame[idx.numpy()], want, atol=2e-6)
        assert 0.02 < want.mean() < 0.98           # lit, not saturated
        off = ~d["surface_mask"][v].numpy()
        assert (frame[off] == 1.0).all()


def test_pngs_unchanged_by_on_view(toy, tmp_path):
    _, runner, *_ = toy
    env = sky(6, LIGHT_H)
    a, b = str(tmp_path / "with"), str(tmp_path / "without")
    got = _frames(runner, a, env, gamma=2.2)
    runner.render_envmap(b, env, light_h=LIGHT_H, tile=TILE, gamma=2.2)
    names = sorted(os.listdir(os.path.join(a, "rgb", "img")))
    assert names == sorted(os.listdir(os.path.join(b, "rgb", "img")))
    for rel_path in ["light_probe.png"] + [os.path.join("rgb", "img", n)
                                           for n in names]:
        with open(os.path.join(a, rel_path), "rb") as x, \
                open(os.path.join(b, rel_path), "rb") as y:
            assert x.read() == y.read(), rel_path
    for v, n in enumerate(names):
        np.testing.assert_array_equal(
            imread(os.path.join(a, "rgb", "img", n)), rs._to8(got[v]))


def test_traced_render_envmap_records_its_spans(toy, tmp_path):
    _, runner, *_ = toy
    with profiling.trace(str(tmp_path / "trace")):
        n_views = len(_frames(runner, str(tmp_path / "out"),
                              sky(7, LIGHT_H)))
        spans = profiling.spans()
    names = [s.name for s in spans]
    chunks = -(-LIGHT_H * 2 * LIGHT_H // rs.ENV_CHUNK)
    assert names.count("render_envmap") == 1
    assert names.count("render_envmap.chunk") == n_views * chunks
    assert names.count("render_view") == n_views * chunks
    # each view's PNG and the light probe's
    assert names.count("render_envmap.write") == n_views + 1
    root = next(s for s in spans if s.name == "render_envmap")
    assert all(s.root == root.id for s in spans)
