"""psnerf_torch's envmap relighting and material edits against psnerf_tpu's,
on the CPU (plain routes on both sides):
  * the spherical helpers of core/spherical.py are equal to JAX's;
  * load_envmap (the port's RGBE decoder and INTER_AREA resize) matches the
    JAX package's cv2 loader on .npy, .png and .hdr files (flat and RLE, as
    cv2.imwrite writes them) when shrinking by integer and fractional
    factors and when enlarging, within 1e-5 relative;
  * psnet_point_heads and render_psnet with albedo_new and basis_new, with
    specular_rgb on and off, within 1e-5;
  * on a 16x16 stage-2 scene whose checkpoint both Stage2Runners load, the
    PNGs of render_envmap (light_h 4: 32 lights, one chunk; light_h 16: 512
    lights, four chunks) and of edit_material decode within 1/255 of JAX's,
    and light_probe.png is equal.
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from psnerf_tpu.core import spherical as jsph
from psnerf_tpu.fields.psnet import PSNetConfig as JCfg, init_psnet as jinit
from psnerf_tpu.render import shading as jshading
from psnerf_tpu.runners import stage2 as jstage2
from psnerf_torch.core import spherical as sph
from psnerf_torch.data.envmap import load_envmap
from psnerf_torch.data.scene import imread
from psnerf_torch.render import shading
from torch_helpers import j, port_psnet, port_stage2_config, t, unit

torch.set_num_threads(1)
TILE = 64


# ---------------------------------------------------------------- spherical

def test_sph2cart_and_cart2sph_match_jax():
    rng = np.random.default_rng(0)
    sphc = np.stack([rng.uniform(0.5, 2, 50), rng.uniform(-1.5, 1.5, 50),
                     rng.uniform(-3, 3, 50)], -1)
    np.testing.assert_array_equal(sph.sph2cart(sphc), jsph.sph2cart(sphc))
    cart = rng.normal(size=(4, 7, 3))
    np.testing.assert_array_equal(sph.cart2sph(cart), jsph.cart2sph(cart))


@pytest.mark.parametrize("h,w,radius", [(4, 8, 1.0), (16, 32, 1e2),
                                        (5, 12, 3.0)])
def test_gen_light_xyz_matches_jax(h, w, radius):
    xyz, areas = sph.gen_light_xyz(h, w, radius)
    jxyz, jareas = jsph.gen_light_xyz(h, w, radius)
    assert xyz.shape == (h, w, 3) and areas.shape == (h, w)
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(areas, jareas)


def test_sphere_samples_and_probe_match_jax():
    np.testing.assert_array_equal(sph.uniform_sample_sph(64, 2.0),
                                  jsph.uniform_sample_sph(64, 2.0))
    with pytest.raises(ValueError):
        sph.uniform_sample_sph(10)
    np.testing.assert_array_equal(
        sph.random_sphere_dirs(100, np.random.default_rng(3)),
        jsph.random_sphere_dirs(100, np.random.default_rng(3)))
    env = np.random.default_rng(1).uniform(size=(4, 8, 3)) * 3
    for h in (32, 3):
        np.testing.assert_array_equal(sph.vis_light_probe(env, h),
                                      jsph.vis_light_probe(env, h))


# ------------------------------------------------------------------ envmaps

def _write(path: str, img: np.ndarray) -> None:
    """img: float RGB [H, W, 3]; written as cv2 writes each format."""
    if path.endswith(".npy"):
        np.save(path, img.astype(np.float32))
    elif path.endswith(".png"):
        cv2.imwrite(path, np.clip(img * 255, 0, 255).astype(np.uint8)[
            ..., ::-1])
    else:
        comp = (cv2.IMWRITE_HDR_COMPRESSION_RLE if "rle" in path
                else cv2.IMWRITE_HDR_COMPRESSION_NONE)
        cv2.imwrite(path, img[..., ::-1].astype(np.float32),
                    [cv2.IMWRITE_HDR_COMPRESSION, comp])


# (source [H, W], light_h): 4x and 2x shrinks, a 2.5x and a ragged shrink,
# 2x and 1.6x enlargements, one axis shrunk and the other enlarged
_SIZES = [((64, 128), 16), ((32, 64), 16), ((40, 80), 16), ((37, 70), 8),
          ((8, 16), 16), ((10, 20), 16), ((30, 12), 8)]


@pytest.mark.parametrize("fmt", [".npy", ".png", "_flat.hdr", "_rle.hdr"])
@pytest.mark.parametrize("size,light_h", _SIZES)
def test_load_envmap_matches_jax(tmp_path, fmt, size, light_h):
    rng = np.random.default_rng(size[0] + size[1])
    img = (rng.uniform(size=(*size, 3)) ** 2 * (1.0 if fmt == ".png"
                                                else 6.0)).astype(np.float32)
    path = str(tmp_path / f"env{fmt}")
    _write(path, img)
    ref = jstage2.load_envmap(path, light_h)
    got = load_envmap(path, light_h)
    assert got.shape == ref.shape == (light_h, 2 * light_h, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_load_envmap_refuses_unknown_formats(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        load_envmap(str(tmp_path / "env.exr"))


# ------------------------------------------------------------- edit hooks

def _points(n, n_l, seed):
    rng = np.random.default_rng(seed)
    return dict(
        points=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
        normals=unit(rng, (n, 3)), mask=rng.uniform(size=n) > 0.3,
        rays=unit(rng, (n, 3)), ldirs=unit(rng, (n_l, 3)),
        lints=(rng.uniform(size=(n_l, 3)) * 2 + 0.5).astype(np.float32))


@pytest.mark.parametrize("specular_rgb", [True, False])
@pytest.mark.parametrize("edit", [
    dict(albedo_new=(0.8, 0.2, 0.1)), dict(basis_new=3),
    dict(albedo_new=(0.1, 0.5, 0.9), basis_new=0)])
def test_edit_hooks_match_jax(specular_rgb, edit):
    jcfg = JCfg(mlp_width=64, sg_mlp_width=32, normal_mlp_width=64,
                vis_mlp_width=64, specular_rgb=specular_rgb)
    params = jinit(jax.random.PRNGKey(4), jcfg)
    model = port_psnet(params, jcfg)
    s = _points(128, 4, 6)
    jedit = {k: (j(np.asarray(v, np.float32)) if k == "albedo_new" else v)
             for k, v in edit.items()}
    ref = jshading.psnet_point_heads(params, jcfg, j(s["points"]),
                                     j(s["normals"]), **jedit)
    with torch.no_grad():
        got = shading.psnet_point_heads(model, model.cfg, t(s["points"]),
                                        t(s["normals"]), **edit)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    args = (s["points"], s["normals"], s["mask"], s["rays"], s["ldirs"],
            s["lints"])
    ref = jshading.render_psnet(params, jcfg, *map(j, args), **jedit)
    with torch.no_grad():
        got = shading.render_psnet(model, model.cfg, *map(t, args), **edit)
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k].numpy(), r, atol=1e-5, rtol=0,
                                   err_msg=k)
    if "basis_new" in edit:
        w = got["sg_weight"][torch.as_tensor(s["mask"])].numpy()
        lobes = w.reshape(len(w), -1, jcfg.nbasis)
        assert (lobes[:, :, edit["basis_new"]]
                == np.float32(2.0 ** edit["basis_new"] / 100)).all()
        assert np.count_nonzero(lobes) == lobes.shape[0] * lobes.shape[1]


# ---------------------------------------------------------------- runners

@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """A 16x16 scene (2 train views, 1 test view, 5 lights) and its stage-1
    export; a JAX runner writes its initial checkpoint, and a port runner
    on the CPU resumes from it."""
    from psnerf_tpu.config import Stage2Config as JStage2Config
    from psnerf_tpu.data.synthetic import (generate_synthetic_scene,
                                           write_stage1_exports)
    from psnerf_tpu.runners.stage2 import Stage2Runner as JRunner
    from psnerf_tpu.train.stage2 import Stage2TrainConfig as JTrainConfig
    from psnerf_torch.runners.stage2 import Stage2Runner

    root = tmp_path_factory.mktemp("relight")
    scene = str(root / "scene")
    generate_synthetic_scene(scene, n_views=2, n_test=1, n_lights=5,
                             hw=(16, 16), focal=20.0)
    write_stage1_exports(scene, os.path.join(scene, "exports"), n_vis_plus=4)
    jcfg = JStage2Config(
        net=JCfg(mlp_width=32, sg_mlp_width=16, normal_mlp_width=32,
                 vis_mlp_width=32, vis_mlp_depth=4, vis_mlp_skip_at=2,
                 n_freqs_xyz=4, normal_n_freqs_xyz=4),
        train=JTrainConfig(), data_dir=scene,
        stage1_shape_path=os.path.join(scene, "exports"),
        inten_normalize=None, ckpt_freq=100000)
    wd = str(root / "run")
    jr = JRunner(jcfg, wd, resume=False)
    # lift the visibility output so that the clipped visibility is not 0
    # everywhere at raw init (a zero image tests nothing)
    vis = jr.params["model"]["visibility"]
    vis[-1]["b"] = vis[-1]["b"] + 0.7
    jr.save(3)
    pr = Stage2Runner(port_stage2_config(jcfg), wd, device="cpu")
    assert pr.it == 3
    return jr, pr, root


def _envmap(light_h, seed=0):
    rng = np.random.default_rng(seed)
    env = rng.uniform(size=(light_h, 2 * light_h, 3)).astype(np.float32)
    return env * np.asarray([1.0, 0.7, 0.4], np.float32) * 0.05


def _pngs(root):
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            out[os.path.relpath(os.path.join(dp, f), root)] = imread(
                os.path.join(dp, f))
    return out


def _assert_pngs_close(a_dir, b_dir, n_expected):
    a, b = _pngs(a_dir), _pngs(b_dir)
    assert sorted(a) == sorted(b) and len(a) == n_expected
    for k in a:
        assert a[k].shape == b[k].shape, k
        diff = np.abs(a[k].astype(np.int16) - b[k].astype(np.int16))
        assert diff.max() <= 1, (k, diff.max())
    return a


@pytest.mark.parametrize("light_h", [4, 16])
def test_render_envmap_matches_jax(runners, tmp_path, light_h):
    jr, pr, _ = runners
    env = _envmap(light_h)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jr.render_envmap(out_j, env, light_h=light_h, gamma=2.2, tile=TILE)
    pr.render_envmap(out_t, env, light_h=light_h, gamma=2.2, tile=TILE)
    got = _assert_pngs_close(out_j, out_t, 2)
    probe = os.path.join("light_probe.png")
    np.testing.assert_array_equal(got[probe], _pngs(out_j)[probe])
    img = got[os.path.join("rgb", "img", "view_03.png")]
    mask = pr._eval_data("test")["surface_mask"][0].numpy().reshape(16, 16)
    assert (img[~mask] == 255).all()
    assert img[mask].std() > 0           # the surface is lit, not flat


def test_edit_material_matches_jax(runners, tmp_path):
    jr, pr, _ = runners
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(albedo_new=np.asarray([0.9, 0.3, 0.2], np.float32),
              basis_new=5, tile=TILE)
    jr.edit_material(out_j, **kw)
    pr.edit_material(out_t, **kw)
    # one png per light of the test view (5)
    _assert_pngs_close(out_j, out_t, 5)
    # an edit changes the render, and the unedited render is not reused
    plain = str(tmp_path / "plain")
    pr.edit_material(plain, tile=TILE)
    name = os.path.join("rgb", "img", "view_03", "001.png")
    assert not np.array_equal(_pngs(plain)[name], _pngs(out_t)[name])
