"""psnerf_torch's mesh extraction against psnerf_tpu's, on the CPU at toy
sizes:
  * the native sources are byte-equal copies, built into the port's own
    directory;
  * MISE and marching_cubes on an analytic sphere: identical query points,
    dense grids, vertices and triangles;
  * extract_mesh with one numpy value function: identical meshes under the
    raw and the exterior_only protocols, with clip_bottom, and with an
    enclosed pocket (where the raw protocol warns in both);
  * Stage1Runner.extract_mesh_to on a 16x16 scene whose checkpoint both
    runners load (resolution0 16, upsampling 1): the value grids within
    1e-4 wherever both evaluated, the meshes within 1e-3 of the box size
    by the port's Chamfer; extract_mesh_both's exterior mesh likewise;
  * PLY and OBJ files written by either package load in the other;
  * chamfer_distance and surface_distance equal JAX's to 1e-12;
  * the silhouette carver's keep-masks (carve, carve_dense_grid) are
    identical;
  * refine_mesh fed the draws of JAX's key stream gives vertices within
    1e-5 after 5 steps.
"""

import dataclasses
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.mesh import chamfer as jchamfer
from psnerf_tpu.mesh import extractor as jext
from psnerf_tpu.mesh import meshio as jio
from psnerf_tpu.mesh import native as jnative
from psnerf_tpu.mesh import refine as jrefine
from psnerf_torch.fields import occupancy as occ
from psnerf_torch.mesh import build, chamfer, extractor, meshio, native, refine
from torch_helpers import port_config, port_occ_field

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTER = np.asarray([0.1, -0.05, 0.02])


def _sphere(p):
    """Inside-positive analytic values: a 0.6 sphere off the origin."""
    p = np.asarray(p, np.float64)
    return 0.6 - np.linalg.norm(p - CENTER, axis=-1)


def _shell(p):
    """A hollow ball: inside between radii 0.35 and 0.7 (an enclosed
    pocket within)."""
    r = np.linalg.norm(np.asarray(p, np.float64) - CENTER, axis=-1)
    return np.minimum(0.7 - r, r - 0.35)


# ------------------------------------------------------------------ native

@pytest.mark.parametrize("name", build.SOURCES)
def test_sources_are_byte_equal_copies(name):
    with open(os.path.join(ROOT, "psnerf_tpu", "mesh", "csrc", name),
              "rb") as a, open(build.CSRC / name, "rb") as b:
        assert a.read() == b.read()


def test_library_builds_into_the_ports_directory():
    lib = native._load()
    assert os.path.dirname(lib._name) == str(build.BUILD_DIR)
    assert build.BUILD_DIR.parent.name == "mesh" \
        and build.BUILD_DIR.parent.parent.name == "psnerf_torch"


@pytest.mark.parametrize("res0,depth", [(8, 2), (16, 1), (5, 3)])
def test_mise_and_marching_cubes_match_jax(res0, depth):
    iso = 0.0
    got, ref = native.MISE(res0, depth, iso), jnative.MISE(res0, depth, iso)
    assert got.resolution == ref.resolution == res0 * 2 ** depth
    rounds = 0
    while True:
        pg, pr = got.query(), ref.query()
        np.testing.assert_array_equal(pg, pr)
        if len(pg) == 0:
            break
        vals = _sphere(pg.astype(np.float32) / got.resolution * 2.4 - 1.2)
        got.update(pg, vals)
        ref.update(pr, vals)
        rounds += 1
    assert rounds == depth + 1
    for dt in (np.float32, np.float64):
        dg, dr = got.to_dense(dt), ref.to_dense(dt)
        assert dg.dtype == dt
        np.testing.assert_array_equal(dg, dr)
        vg, tg = native.marching_cubes(dg, iso)
        vr, tr = jnative.marching_cubes(dr, iso)
        assert len(tg) > 100
        np.testing.assert_array_equal(vg, vr)
        np.testing.assert_array_equal(tg, tr)


# --------------------------------------------------------------- extractor

@pytest.mark.parametrize("fn,kw", [
    (_sphere, {}), (_sphere, dict(exterior_only=True)),
    (_sphere, dict(clip_bottom=-0.2)), (_shell, dict(exterior_only=True)),
    (_shell, dict(upsampling_steps=0, resolution0=24)),
    (_sphere, dict(points_batch=777, padding=0.2, threshold=0.3))])
def test_extract_mesh_matches_jax(fn, kw):
    kw = dict(dict(resolution0=12, upsampling_steps=2), **kw)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        vr, tr = jext.extract_mesh(fn, **kw)
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        vg, tg = extractor.extract_mesh(fn, **kw)
    assert vg.dtype == np.float32 and len(tg) > 100
    np.testing.assert_array_equal(vg, vr)
    np.testing.assert_array_equal(tg, tr)
    # the raw protocol warns of the shell's pocket in both packages
    pocket = lambda ws: any("enclosed interior pockets" in str(w.message)
                            for w in ws)
    assert pocket(wp) == pocket(wj) == (
        fn is _shell and not kw.get("exterior_only", False))


def test_pocket_helpers_match_jax():
    n = 20
    lin = np.linspace(-1.2, 1.2, n)
    grid = _shell(np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                           -1)).astype(np.float32)
    enc = extractor.find_enclosed_pockets(grid, 0.0)
    assert enc.any()
    np.testing.assert_array_equal(enc, jext.find_enclosed_pockets(grid, 0.0))
    np.testing.assert_array_equal(extractor.fill_enclosed_pockets(grid, 0.0),
                                  jext.fill_enclosed_pockets(grid, 0.0))
    assert extractor.POCKET_WARN_FRACTION == jext.POCKET_WARN_FRACTION


# ------------------------------------------------------------------ mesh io

def _tetra():
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.5]],
                   np.float64) * 0.3
    f = np.asarray([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int64)
    return v, f


@pytest.mark.parametrize("ext", [".ply", ".obj"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mesh_files_cross_between_packages(tmp_path, ext, writer):
    v, f = jext.extract_mesh(_sphere, resolution0=8, upsampling_steps=1)
    path = str(tmp_path / f"m{ext}")
    save = {"port": {".ply": meshio.save_ply, ".obj": meshio.save_obj},
            "jax": {".ply": jio.save_ply, ".obj": jio.save_obj}}[writer][ext]
    save(path, v, f)
    reader = jio.load_mesh if writer == "port" else meshio.load_mesh
    vl, fl = reader(path)
    np.testing.assert_array_equal(fl, f)
    np.testing.assert_allclose(vl, v, rtol=1e-6, atol=1e-7)
    vo, fo = (meshio.load_mesh if writer == "port" else jio.load_mesh)(path)
    np.testing.assert_array_equal(vo, vl)
    np.testing.assert_array_equal(fo, fl)


def test_sampling_matches_jax():
    v, f = _tetra()
    np.testing.assert_array_equal(meshio.triangle_areas(v, f),
                                  jio.triangle_areas(v, f))
    np.testing.assert_array_equal(
        meshio.sample_surface(v, f, 500, np.random.default_rng(2)),
        jio.sample_surface(v, f, 500, np.random.default_rng(2)))


@pytest.mark.parametrize("seed,n", [(0, 2000), (5, 300)])
def test_chamfer_and_surface_distance_match_jax(seed, n):
    va, fa = jext.extract_mesh(_sphere, resolution0=10, upsampling_steps=1)
    vb, fb = jext.extract_mesh(_shell, resolution0=9, upsampling_steps=1,
                               exterior_only=True)
    for fn, jfn in ((chamfer.chamfer_distance, jchamfer.chamfer_distance),
                    (chamfer.surface_distance, jchamfer.surface_distance)):
        got = fn(va, fa, vb, fb, num_samples=n, seed=seed)
        ref = jfn(va, fa, vb, fb, num_samples=n, seed=seed)
        assert got > 0.05
        assert abs(got - ref) <= 1e-12
    pts = np.random.default_rng(seed).normal(size=(50, 3))
    np.testing.assert_array_equal(
        chamfer.MeshProximity(va, fa).distances(pts),
        jchamfer.MeshProximity(va, fa).distances(pts))


# ----------------------------------------------------------------- carving

def _carve_inputs(n_views=3, hw=(20, 24)):
    rng = np.random.default_rng(3)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.stack([((xx - w / 2 - i) ** 2 + (yy - h / 2) ** 2
                       < (4 + i) ** 2).astype(np.float32)
                      for i in range(n_views)])
    K = np.asarray([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    cams = np.broadcast_to(jrefine.pixel_to_ndc_camera(K, h, w),
                           (n_views, 4, 4))
    w2c = []
    for i in range(n_views):
        ang = 0.7 * i
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]]
        c2w[:3, 3] = c2w[:3, :3] @ np.asarray([0, 0, -3.0])
        w2c.append(np.linalg.inv(c2w.astype(np.float32)))
    pts = rng.uniform(-1.2, 1.2, size=(5000, 3)).astype(np.float32)
    return masks, cams, np.stack(w2c), pts


@pytest.mark.parametrize("radius", [0, 2])
def test_mask_carver_matches_jax(radius):
    masks, cams, w2c, pts = _carve_inputs()
    np.testing.assert_array_equal(
        refine.pixel_to_ndc_camera(np.eye(3) * 2, 20, 24),
        jrefine.pixel_to_ndc_camera(np.eye(3) * 2, 20, 24))
    np.testing.assert_array_equal(refine._disk(3), jrefine._disk(3))
    got = refine.make_mask_carver(masks, cams, w2c, dilate_radius=radius,
                                  chunk=1 << 12, device="cpu")
    ref = jrefine.make_mask_carver(masks, cams, w2c, dilate_radius=radius)
    kg, kr = got(pts), ref(pts)
    assert kg.dtype == bool and 0.02 < kg.mean() < 0.98
    np.testing.assert_array_equal(kg, kr)
    for n in (17, 33):
        dg = got.carve_dense_grid(n, 2.4)
        assert dg.shape == (n, n, n) and dg.any()
        np.testing.assert_array_equal(dg, ref.carve_dense_grid(n, 2.4))


# ------------------------------------------------------------------ refine

JCFG = jocc.OccFieldConfig(num_layers=4, hidden_dim=32, feat_size=32,
                           octaves_pe=2, octaves_pe_views=2, skips=(2,))


def _jax_refine_draws(n_faces, fb, steps, seed=0):
    """The face indices and barycentrics that psnerf_tpu's refine_mesh
    draws from its key stream."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        kf, kb = jax.random.split(k)
        idx = jax.random.choice(kf, n_faces, (fb,), replace=n_faces < fb)
        eps = jax.random.dirichlet(kb, jax.numpy.full((3,), 0.5), (fb,))
        out.append((np.asarray(idx), np.asarray(eps)))
    return out


@pytest.mark.parametrize("faces_per_step", [64, 100000])
def test_refine_mesh_matches_jax_with_its_draws(faces_per_step):
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    cfg, field = port_occ_field(jp, JCFG)
    v, f = jext.extract_mesh(lambda p: -np.asarray(jocc.occ_logit(
        jp, jax.numpy.asarray(p), JCFG)), resolution0=8, upsampling_steps=1)
    steps, lr = 5, 1e-5                 # the runner's learning rate
    ref = jrefine.refine_mesh(lambda p: jocc.occ_alpha(jp, p, JCFG), v, f,
                              steps=steps, faces_per_step=faces_per_step,
                              lr=lr)
    draws = _jax_refine_draws(len(f), min(faces_per_step, len(f)), steps)
    got = refine.refine_mesh(lambda p: occ.occ_alpha(field, p, cfg), v, f,
                             steps=steps, faces_per_step=faces_per_step,
                             lr=lr, draws=draws, device="cpu")
    assert got.shape == v.shape and got.dtype == np.float32
    moved = np.abs(ref - v).max()
    assert moved > 10 * lr                # the steps move the vertices
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_refine_mesh_own_draws():
    """Without draws: fb distinct faces a step and Dirichlet barycentrics
    from a torch.Generator; the same seed gives the same vertices."""
    gen = torch.Generator().manual_seed(1)
    idx, eps = refine.draw_refine_samples(50, 20, gen, "cpu")
    assert len(set(idx.tolist())) == 20 and int(idx.max()) < 50
    assert torch.allclose(eps.sum(-1), torch.ones(20)) and (eps >= 0).all()
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    cfg, field = port_occ_field(jp, JCFG)
    v, f = jext.extract_mesh(_sphere, resolution0=6, upsampling_steps=1)
    run = lambda seed: refine.refine_mesh(
        lambda p: occ.occ_alpha(field, p, cfg), v, f, steps=3,
        faces_per_step=40, lr=1e-3, seed=seed, device="cpu")
    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and np.abs(a - v).max() > 1e-3
    with pytest.raises(ValueError, match="draws"):
        refine.refine_mesh(lambda p: occ.occ_alpha(field, p, cfg), v, f,
                           steps=3, draws=[], device="cpu")


# ------------------------------------------------------------------ runner

@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """A 16x16 scene; a port runner at the field's init writes a checkpoint
    that a JAX runner resumes: both hold one parameter set."""
    from psnerf_tpu.config import Stage1Config as JStage1Config
    from psnerf_tpu.render import unisurf as juni
    from psnerf_tpu.runners.stage1 import Stage1Runner as JRunner
    from psnerf_tpu.train import stage1 as jstage1
    from psnerf_torch.config import Stage1Config
    from psnerf_torch.data.synthetic import generate_synthetic_scene
    from psnerf_torch.render.unisurf import UnisurfConfig
    from psnerf_torch.runners.stage1 import Stage1Runner
    from psnerf_torch.train import stage1

    root = tmp_path_factory.mktemp("mesh")
    scene = str(root / "scene")
    generate_synthetic_scene(scene, n_views=2, n_test=1, n_lights=3,
                             hw=(16, 16), focal=20.0)
    jrcfg = juni.UnisurfConfig(near=1.2, far=5.0, radius=1.2,
                               ray_marching_steps=16)
    kw = dict(data_dir=scene, inten_normalize=None, checkpoint_every=10 ** 6,
              backup_every=10 ** 6, visualize_every=0,
              extraction_resolution=16, extraction_upsampling=1)
    jcfg = JStage1Config(field=JCFG, render=jrcfg,
                         train=jstage1.Stage1TrainConfig(), **kw)
    cfg = Stage1Config(field=port_config(JCFG, occ.OccFieldConfig),
                       render=port_config(jrcfg, UnisurfConfig),
                       train=stage1.Stage1TrainConfig(), **kw)
    wd = str(root / "run")
    r = Stage1Runner(cfg, wd, seed=0, resume=False, device="cpu")
    r.save(2)
    jr = JRunner(jcfg, wd, seed=1)
    assert jr.it == 2
    return r, jr, root


def _recording(monkeypatch, module, seen):
    """Wrap module.make_field_value_fn so that every evaluated point is
    recorded (as numpy) in `seen`."""
    make = module.make_field_value_fn

    def wrapped(*a, **k):
        fn = make(*a, **k)

        def rec(pts):
            seen.append(np.asarray(pts).copy())
            return fn(pts)

        if hasattr(fn, "device"):
            rec.device = fn.device
        return rec

    monkeypatch.setattr(module, "make_field_value_fn", wrapped)


def test_extract_mesh_to_matches_jax(runners, monkeypatch):
    import psnerf_torch.runners.stage1 as pstage1
    import psnerf_tpu.runners.stage1 as jstage1

    r, jr, root = runners
    seen_p, seen_j = [], []
    _recording(monkeypatch, pstage1, seen_p)
    _recording(monkeypatch, jstage1, seen_j)
    timings = {}
    grid_p, iso, box = r._build_value_grid(None, None, True, 2, None,
                                           timings)
    grid_j, jiso, jbox = jr._build_value_grid(None, None, True, 2)
    assert grid_p.shape == grid_j.shape == (33, 33, 33)
    assert (iso, box) == (jiso, jbox)
    # the batches are padded to the 100,000-point batch
    assert 0 < timings["points"] <= sum(len(s) for s in seen_p)
    assert {"eval_s", "mise_s", "carve_s"} <= set(timings)
    ijk = lambda seen: {tuple(x) for x in np.rint(
        (np.concatenate(seen) / box + 0.5) * 32).astype(int).tolist()}
    both = np.asarray(sorted(ijk(seen_p) & ijk(seen_j)))
    assert len(both) > 33 ** 3 // 4
    i, j_, k = both.T
    np.testing.assert_allclose(grid_p[i, j_, k], grid_j[i, j_, k],
                               atol=1e-4, rtol=0)
    # the meshes, written as PLY and read back, by the port's Chamfer
    paths = {}
    for name, runner in (("port", r), ("jax", jr)):
        paths[name] = str(root / f"mesh_{name}.ply")
        runner.extract_mesh_to(paths[name], mask_carve=True, dilate_radius=2)
    vp, fp = meshio.load_mesh(paths["port"])
    vj, fj = meshio.load_mesh(paths["jax"])
    assert len(fp) > 100
    assert chamfer.chamfer_distance(vp, fp, vj, fj, 4000) < 1e-3 * box


def test_extract_mesh_both_matches_jax(runners, tmp_path):
    r, jr, _ = runners
    timings = {}
    (vr, fr), (ve, fe) = r.extract_mesh_both(
        str(tmp_path / "raw.obj"), str(tmp_path / "ext.ply"),
        timings=timings)
    (jvr, jfr), (jve, jfe) = jr.extract_mesh_both(
        str(tmp_path / "jraw.obj"), str(tmp_path / "jext.ply"))
    assert {"march_s", "pocket_s", "write_s"} <= set(timings["raw"])
    for a, b in (((vr, fr), (jvr, jfr)), ((ve, fe), (jve, jfe))):
        assert chamfer.chamfer_distance(*a, *b, 4000) < 2.4e-3
    vl, fl = meshio.load_mesh(str(tmp_path / "raw.obj"))
    np.testing.assert_array_equal(fl, fr)
    np.testing.assert_allclose(vl, vr, rtol=1e-6)


def test_extract_mesh_refines_with_the_config(runners, tmp_path):
    """extraction_refinement > 0 runs refine_mesh on the field after the
    marching: the vertices move, the faces stay."""
    r, _, _ = runners
    base = r.extract_mesh_to(str(tmp_path / "a.ply"))
    r.cfg = dataclasses.replace(r.cfg, extraction_refinement=3)
    try:
        refined = r.extract_mesh_to(str(tmp_path / "b.ply"))
    finally:
        r.cfg = dataclasses.replace(r.cfg, extraction_refinement=0)
    np.testing.assert_array_equal(refined[1], base[1])
    assert 0 < np.abs(refined[0] - base[0]).max() < 1e-3
