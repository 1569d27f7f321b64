"""psnerf_torch's rescaled, chunked and grid-guided visibility protocols
against psnerf_tpu's, on the CPU (plain f32 routes on both sides):
  * occupancy_guide_grid: the same {0, 1} grid;
  * light_visibility with rescale, light_chunk 1, 3 (padded) and L, and a
    guide at two guide_coarse values: within 1e-5 abs;
  * the runner's guide calibration check (a probe spacing wider than the
    dilated slab raises);
  * Stage1Runner.shape_extract on the 16x16 scene of
    test_torch_stage1_export.py, one checkpoint in both packages, with
    vis_rescale, the mixed protocol, the guided one (guide_res 32) and
    light_chunk 4: geometry and faithful legs within that file's bars of
    JAX's export, rescaled and guided legs within 1e-5 of JAX's
    light_visibility on the port's exported points (_assert_export_matches
    says why);
    the mixed and guided train-light visibility bit for bit the faithful
    run's; a second guided call with another guide_coarse on the same
    runner gives that protocol's result.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.render import marching as jmarch
from psnerf_torch.fields import occupancy as occ
from psnerf_torch.render import marching
from psnerf_torch.runners.stage1 import check_guide_calibration
from test_torch_stage1_export import JCFG, NORMAL_DEG, _angles_deg, _cfgs
from torch_helpers import j, port_occ_field, t, unit

torch.set_num_threads(1)
VIS_ABS = 1e-5


@pytest.fixture(scope="module")
def fields():
    """{name: (JAX occ_fn, port occ_fn)}: the toy field of
    test_torch_stage1_export.py, and a sharp analytic sphere of radius 0.6
    whose guide grid leaves most of the box empty."""
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    cfg, f = port_occ_field(jp, JCFG)
    return {
        "field": (lambda p: jocc.occ_alpha(jp, p, JCFG),
                  lambda p: occ.occ_alpha(f, p, cfg)),
        "sphere": (lambda p: jax.nn.sigmoid(
            -40.0 * (jnp.linalg.norm(p, axis=-1) - 0.6)),
            lambda p: torch.sigmoid(-40.0 * (torch.linalg.norm(p, dim=-1)
                                             - 0.6)))}


@pytest.mark.parametrize("name", ["field", "sphere"])
@pytest.mark.parametrize("res,dilate", [(16, 1), (32, 3)])
def test_guide_grid_matches_jax(fields, name, res, dilate):
    jf, pf = fields[name]
    ref = np.asarray(jmarch.occupancy_guide_grid(jf, res=res, dilate=dilate))
    got = marching.occupancy_guide_grid(pf, res=res, dilate=dilate,
                                        device="cpu").numpy()
    assert got.shape == (res, res, res) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert set(np.unique(got)) <= {0.0, 1.0} and 0 < got.mean() < 1


def _inputs(seed=2, n=48, n_l=5):
    rng = np.random.default_rng(seed)
    surf = (unit(rng, (n, 3)) * 0.6).astype(np.float32)
    return surf, unit(rng, (n_l, 3))


@pytest.mark.parametrize("name", ["field", "sphere"])
@pytest.mark.parametrize("kw", [
    dict(rescale=True), dict(light_chunk=1, rescale=True),
    dict(light_chunk=3), dict(light_chunk=3, rescale=True),
    dict(light_chunk=5), dict(light_chunk=5, rescale=True),
    dict(guide_coarse=8), dict(guide_coarse=16, light_chunk=3)],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_light_visibility_protocols_match_jax(fields, name, kw):
    jf, pf = fields[name]
    surf, ldir = _inputs()
    jkw, pkw = dict(kw), dict(kw)
    if "guide_coarse" in kw:
        grid = np.asarray(jmarch.occupancy_guide_grid(jf, res=16, dilate=1))
        jkw["guide"], pkw["guide"] = j(grid), t(grid)
    ref = np.asarray(jmarch.light_visibility(jf, j(surf), j(ldir),
                                             n_steps=16, **jkw))
    got = marching.light_visibility(pf, t(surf), t(ldir), n_steps=16, **pkw)
    assert got.shape == (5, 48)
    np.testing.assert_allclose(got.numpy(), ref, atol=VIS_ABS, rtol=0)
    assert got.min() < 0.9 and got.max() > 0.1     # lit and shadowed rays


def test_light_chunks_equal_single_lights(fields):
    """Grouping lights changes no light's result (the padding copies of
    direction 0 are sliced off)."""
    _, pf = fields["field"]
    surf, ldir = _inputs(n_l=7)
    one = marching.light_visibility(pf, t(surf), t(ldir), n_steps=16,
                                    rescale=True)
    for chunk in (2, 3, 7, 9):
        got = marching.light_visibility(pf, t(surf), t(ldir), n_steps=16,
                                        rescale=True, light_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-6,
                                   rtol=0)


def test_guide_calibration_check():
    check_guide_calibration(64, 16)      # the defaults: 0.227 <= 0.241
    check_guide_calibration(32, 16)      # test_pipeline.py's: 0.227 <= 0.481
    for res, coarse in ((32, 8), (64, 15), (128, 16)):
        with pytest.raises(ValueError, match="under-covers"):
            check_guide_calibration(res, coarse)


# ------------------------------------------------------------------ runner

@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """A port runner trained 4 steps on the CPU; its checkpoint resumed by
    JAX runners (one per protocol: the JAX runner's program cache keys
    omit guide_coarse)."""
    from psnerf_torch.data.synthetic import generate_synthetic_scene
    from psnerf_torch.runners.stage1 import Stage1Runner
    from psnerf_tpu.runners.stage1 import Stage1Runner as JRunner

    root = tmp_path_factory.mktemp("export_protocols")
    scene = str(root / "scene")
    generate_synthetic_scene(scene, n_views=2, n_test=1, n_lights=3,
                             hw=(16, 16), focal=20.0)
    jcfg, cfg = _cfgs(scene)
    wd = str(root / "run")
    r = Stage1Runner(cfg, wd, seed=0, resume=False, device="cpu")
    r.train(4, log_every=100)
    return r, (lambda: JRunner(jcfg, wd, seed=1)), root


BASE = dict(visibility=True, vis_plus=True, vis_plus_num=4, tile=64,
            n_steps=32, vis_steps=16, seed=3)
PROTOCOLS = {
    "faithful": {},
    "rescaled": dict(vis_rescale=True),
    "mixed": dict(vis_plus_steps=8, vis_plus_rescale=True),
    "guided": dict(vis_plus_guided=True, guide_res=32),
    "chunk4": dict(light_chunk=4),
}


@pytest.fixture(scope="module")
def exports(runners):
    """{protocol: (port export dir, timings, JAX export dir, JAX runner)}."""
    r, jrunner, root = runners
    out = {}
    for name, kw in PROTOCOLS.items():
        d_got, d_ref = str(root / f"{name}_port"), str(root / f"{name}_jax")
        timings = r.shape_extract(d_got, **BASE, **kw)
        jr = None
        if name != "faithful":     # test_torch_stage1_export.py holds it
            jr = jrunner()
            jr.shape_extract(d_ref, **BASE, **kw)
        out[name] = (d_got, timings, d_ref, jr)
    return out


def _load(d, sub, name):
    return np.load(os.path.join(d, sub, name))


def _legs(kw):
    """{subdir: light_visibility's protocol} of an export's two legs, with
    shape_extract's defaults."""
    kw = dict(BASE, **kw)
    guided = kw.get("vis_plus_guided", False)
    steps = kw.get("vis_plus_steps") or (16 if guided else kw["vis_steps"])
    rescale = kw.get("vis_plus_rescale")
    rescale = kw.get("vis_rescale", False) if rescale is None else rescale
    chunk = kw.get("light_chunk") or 1
    return {"visibility": dict(n_steps=kw["vis_steps"], light_chunk=chunk,
                               rescale=kw.get("vis_rescale", False)),
            "vis_plus": dict(n_steps=steps, rescale=rescale,
                             light_chunk=chunk, guided=guided,
                             guide_res=kw.get("guide_res", 64),
                             guide_coarse=kw.get("guide_coarse", 16))}


def _assert_export_matches(d_got, d_ref, kw, jr):
    """Geometry within test_torch_stage1_export.py's bars of JAX's export.
    A faithful leg's visibility: within its 1e-4 of JAX's export. A
    rescaled or guided leg samples its last point on the box face, where
    the last bit of the surface point (which the two packages' marches set
    within 1e-4 of each other) decides whether it counts: there the port's
    visibility is held against JAX's light_visibility on the port's own
    exported points and directions, within 1e-5."""
    from psnerf_torch.runners.stage1 import world_lights

    names = sorted(os.listdir(os.path.join(d_ref, "mask")))
    assert len(names) == 3
    with open(os.path.join(d_got, "vis_plus", "light_dir.json")) as f:
        got_json = json.load(f)
    with open(os.path.join(d_ref, "vis_plus", "light_dir.json")) as f:
        assert got_json == json.load(f)
    legs = _legs(kw)
    jfn = lambda p: jocc.occ_alpha(jr.params, p, jr.cfg.field)
    grid = None
    if legs["vis_plus"]["guided"]:
        grid = jmarch.occupancy_guide_grid(jfn, res=legs["vis_plus"][
            "guide_res"])
    views = [int(nm[5:7]) - 1 for nm in names]
    train_dirs = world_lights(jr.scene, jr.cfg, views)
    for i, name in enumerate(names):
        mask = _load(d_got, "mask", name)
        np.testing.assert_array_equal(mask, _load(d_ref, "mask", name))
        points = _load(d_got, "points", name)
        np.testing.assert_allclose(points, _load(d_ref, "points", name),
                                   atol=1e-4, rtol=0)
        ang = _angles_deg(_load(d_got, "normal", name)[mask],
                          _load(d_ref, "normal", name)[mask])
        assert ang.max() < NORMAL_DEG, (name, ang.max())
        dirs = {"visibility": train_dirs[i],
                "vis_plus": np.asarray(got_json[name[:-4]], np.float32)}
        for sub, n_l in (("visibility", 3), ("vis_plus", 4)):
            got = _load(d_got, sub, name)
            assert got.shape == (n_l, 16, 16) and got.dtype == np.float32
            assert (got[:, ~mask] == 1.0).all()
            leg = dict(legs[sub])
            if not (leg["rescale"] or leg.get("guided")):
                np.testing.assert_allclose(got, _load(d_ref, sub, name),
                                           atol=1e-4, rtol=0, err_msg=sub)
                continue
            extra = {}
            if leg.pop("guided", False):
                extra = dict(guide=grid, guide_coarse=leg["guide_coarse"])
            ref = jmarch.light_visibility(
                jfn, j(points[mask]), j(dirs[sub]), n_steps=leg["n_steps"],
                rescale=leg["rescale"], light_chunk=leg["light_chunk"],
                **extra)
            np.testing.assert_allclose(got[:, mask], np.asarray(ref),
                                       atol=VIS_ABS, rtol=0, err_msg=sub)


@pytest.mark.parametrize("name", [p for p in PROTOCOLS if p != "faithful"])
def test_shape_extract_protocol_matches_jax(exports, name):
    d_got, timings, d_ref, jr = exports[name]
    _assert_export_matches(d_got, d_ref, PROTOCOLS[name], jr)
    assert timings["guide_s"] > 0 if name == "guided" \
        else timings["guide_s"] == 0


@pytest.mark.parametrize("name", ["mixed", "guided", "chunk4"])
def test_train_light_visibility_is_the_faithful_runs(exports, name):
    """The mixed and guided exports march the train lights faithfully: the
    same bits as the faithful export. light_chunk groups the same lights'
    marches (within 1e-6)."""
    base = exports["faithful"][0]
    for view in sorted(os.listdir(os.path.join(base, "visibility"))):
        want = _load(base, "visibility", view)
        got = _load(exports[name][0], "visibility", view)
        if name == "chunk4":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got, want)
    if name != "chunk4":       # and the vis_plus leg did change protocol
        view = sorted(os.listdir(os.path.join(base, "visibility")))[0]
        assert not np.array_equal(_load(base, "vis_plus", view),
                                  _load(exports[name][0], "vis_plus", view))


def test_guide_coarse_takes_effect_on_the_same_runner(runners, exports):
    """The runner's second guided export at another guide_coarse is that
    protocol's export, not the first one's."""
    r, jrunner, root = runners
    kw = dict(vis_plus_guided=True, guide_res=32, guide_coarse=24)
    d_got, d_ref = str(root / "coarse24_port"), str(root / "coarse24_jax")
    r.shape_extract(d_got, **BASE, **kw)
    jr = jrunner()
    jr.shape_extract(d_ref, **BASE, **kw)
    _assert_export_matches(d_got, d_ref, kw, jr)
    first = exports["guided"][0]
    assert not all(np.array_equal(_load(d_got, "vis_plus", v),
                                  _load(first, "vis_plus", v))
                   for v in os.listdir(os.path.join(first, "visibility")))


def test_shape_extract_refuses_an_under_covering_guide(runners, tmp_path):
    r, _, _ = runners
    with pytest.raises(ValueError, match="under-covers"):
        r.shape_extract(str(tmp_path / "x"), **BASE, vis_plus_guided=True,
                        guide_res=32, guide_coarse=8)
    assert not os.path.exists(tmp_path / "x")
