"""psnerf_torch.preprocess against psnerf_tpu.preprocess on the CPU, on the
same seeded inputs: the class codecs, the conv and transposed-conv layers,
LCNet (logits 1e-4 of each head's max, classes equal away from near-ties),
NENet (normals 1e-5 abs), the reference checkpoint loaders leaf for leaf,
the crop/pad and the align-corners resize bit for bit, run_sdps on a
synthetic scene (same-light and ragged) through both packages, and
light_average's three modes with the PNGs bit for bit."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_torch.data.synthetic import generate_synthetic_scene
from psnerf_torch.preprocess import light_avg, runner, sdps
from psnerf_torch.train.checkpoints import flatten_tree, load_module
from psnerf_tpu.preprocess import light_avg as jlight_avg
from psnerf_tpu.preprocess import runner as jrunner
from psnerf_tpu.preprocess import sdps as jsdps
from torch_helpers import flatten_jax, sdps_reference_state_dict

torch.set_num_threads(1)
NEAR_TIE = 1e-3     # top-two logit gap, as a fraction of the head's max


def _nets(seed=0):
    """(JAX LCNet and NENet params, the port's modules holding them): the
    port's seeded init, handed to JAX through the reference layout."""
    gen = torch.Generator().manual_seed(seed)
    pl = sdps.LCNet(generator=gen, device="cpu").eval()
    pn = sdps.NENet(generator=gen, device="cpu").eval()
    jl = jsdps.load_lcnet_torch(sdps_reference_state_dict(flatten_tree(pl),
                                                          "lcnet"))
    jn = jsdps.load_nenet_torch(sdps_reference_state_dict(flatten_tree(pn),
                                                          "nenet"))
    return jl, jn, pl, pn


@pytest.fixture(scope="module")
def nets():
    return _nets()


def test_codecs_match_jax():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for got, want in zip(sdps.spherical_dirs_to_class(torch.as_tensor(d)),
                         jsdps.spherical_dirs_to_class(jnp.asarray(d))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every (azimuth, elevation) class pair, both signs of y
    xc, yc = np.meshgrid(np.arange(36), np.arange(36), indexing="ij")
    xc, yc = xc.ravel(), yc.ravel()
    got = sdps.spherical_class_to_dirs(torch.as_tensor(xc),
                                       torch.as_tensor(yc))
    want = jsdps.spherical_class_to_dirs(jnp.asarray(xc), jnp.asarray(yc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ints = rng.uniform(0.0, 2.5, 200).astype(np.float32)
    np.testing.assert_array_equal(
        sdps.light_ints_to_class(torch.as_tensor(ints)).numpy(),
        np.asarray(jsdps.light_ints_to_class(jnp.asarray(ints))))
    np.testing.assert_array_equal(
        sdps.class_to_light_ints(torch.arange(20)).numpy(),
        np.asarray(jsdps.class_to_light_ints(jnp.arange(20))))


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 1), (1, 0)])
def test_conv_and_deconv_match_jax(stride, pad):
    rng = np.random.default_rng(stride + 3 * pad)
    x = rng.normal(size=(2, 5, 10, 13)).astype(np.float32)
    w = rng.normal(size=(7, 5, 3, 3)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    got = sdps.conv2d(torch.as_tensor(x), torch.as_tensor(w),
                      torch.as_tensor(b), stride, pad)
    want = jsdps.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                        jnp.asarray(x), stride, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # F.conv_transpose2d on [cin, cout, 4, 4] is the JAX package's flipped,
    # lhs-dilated conv
    wd = rng.normal(size=(5, 6, 4, 4)).astype(np.float32)
    got = sdps.deconv2d(torch.as_tensor(x), torch.as_tensor(wd))
    want = jsdps.deconv2d({"w": jnp.asarray(wd)}, jnp.asarray(x))
    assert got.shape == (2, 6, 20, 26)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _head_errors(got: dict, want: dict):
    """Per head: max |diff| / max |logit| of JAX's logits."""
    return {k: float(np.abs(got[k].numpy() - np.asarray(want[k])).max()
                     / np.abs(np.asarray(want[k])).max())
            for k in ("dirs_x", "dirs_y", "ints")}


def _clear(logits, frac=NEAR_TIE):
    """Rows whose top two logits differ by more than frac of the max."""
    top2 = np.sort(logits, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > frac * np.abs(logits).max()


def test_lcnet_matches_jax(nets):
    jl, _, pl, _ = nets
    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(4, 3, 128, 128)).astype(np.float32)
    mask = (rng.uniform(size=(1, 128, 128)) > 0.2).astype(np.float32)
    with torch.no_grad():
        got = pl(torch.as_tensor(imgs), torch.as_tensor(mask))
    want = jsdps.lcnet_forward(jl, jnp.asarray(imgs), jnp.asarray(mask))
    errs = _head_errors(got, want)
    assert max(errs.values()) < 1e-4, errs
    cx = _clear(np.asarray(want["dirs_x"])) & _clear(np.asarray(
        want["dirs_y"]))
    ci = _clear(np.asarray(want["ints"]))
    assert cx.any() and ci.any()
    np.testing.assert_allclose(got["dirs"].numpy()[cx],
                               np.asarray(want["dirs"])[cx], atol=1e-6)
    np.testing.assert_array_equal(got["intens"].numpy()[ci],
                                  np.asarray(want["intens"])[ci])


def test_nenet_matches_jax(nets):
    _, jn, _, pn = nets
    rng = np.random.default_rng(2)
    imgs = rng.uniform(size=(4, 3, 32, 48)).astype(np.float32)
    d = rng.normal(size=(4, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ints = rng.uniform(0.3, 2.0, 4).astype(np.float32)
    with torch.no_grad():
        got = pn(*map(torch.as_tensor, (imgs, d, ints)))
        # an [L] intensity is an [L, 3] one with equal channels
        per_channel = pn(*map(torch.as_tensor, (imgs, d, ints[:, None]
                                                .repeat(3, 1))))
    want = jsdps.nenet_forward(jn, *map(jnp.asarray, (imgs, d, ints)))
    assert got.shape == (3, 32, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(per_channel.numpy(), got.numpy())


def test_loaders_match_jax(nets):
    """One reference-layout state dict through both packages' loaders:
    the same leaves, bit for bit, and the port's module loads them."""
    jl, jn, _, _ = nets
    for kind, params, load, jload, make in (
            ("lcnet", jl, sdps.load_lcnet_torch, jsdps.load_lcnet_torch,
             sdps.LCNet),
            ("nenet", jn, sdps.load_nenet_torch, jsdps.load_nenet_torch,
             sdps.NENet)):
        sd = sdps_reference_state_dict(flatten_jax(params), kind)
        got, want = flatten_tree(load(sd)), flatten_jax(jload(sd))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        net = load_module(make(device="cpu"), got)
        assert sorted(flatten_tree(net)) == sorted(want)


@pytest.mark.parametrize("hw,box", [((40, 52), (10, 12, 30, 40)),
                                    ((40, 52), (9, 12, 30, 41)),
                                    ((24, 24), (0, 0, 24, 24))])
def test_crop_pad_and_resize_bit_for_bit(hw, box):
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(*hw, 3)).astype(np.float32)
    mask = np.zeros(hw, np.float32)
    mask[box[0]:box[2], box[1]:box[3]] = 1.0
    got = runner._crop_and_pad(img, mask)
    want = jrunner._crop_and_pad(img, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[0].shape[0] % 4 == 0 and got[0].shape[1] % 4 == 0
    for th, tw in ((128, 128), (17, 9)):
        np.testing.assert_array_equal(
            runner.resize_bilinear_align(got[0], th, tw),
            jrunner.resize_bilinear_align(got[0], th, tw))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("ragged", [False, True])
def test_run_sdps_matches_jax(tmp_path, nets, ragged):
    jl, jn, pl, pn = nets
    d = str(tmp_path / "scene")
    generate_synthetic_scene(d, n_views=2, n_test=0, n_lights=4, hw=(48, 48),
                             ragged_lights=ragged)
    timings = {}
    got = runner.run_sdps(d, pl, pn, out_dir=str(tmp_path / "port"),
                          timings=timings)
    want = jrunner.run_sdps(d, jl, jn, out_dir=str(tmp_path / "jax"))
    assert _tree(got) == _tree(want)
    assert len(timings["nenet_s"]) == 2 and len(timings["crop_hw"]) == 2
    for vi in (1, 2):
        a = np.load(os.path.join(got, "outnpy", f"view_{vi:02d}.npy"))
        b = np.load(os.path.join(want, "outnpy", f"view_{vi:02d}.npy"))
        assert a.dtype == b.dtype and a.shape == b.shape == (48, 48, 3)
        # 5e-5 max (measured 2.1e-5), 1e-6 mean, not test_nenet_matches_
        # jax's 1e-5: both packages' f32 normals lie up to ~1e-5 from an f64
        # run of the same net where the raw normal is several times shorter
        # than the median (the normalization amplifies the rounding), and
        # JAX's jitted LCNet hands NENet directions a few ulps off eager
        # JAX's (below)
        err = np.abs(a - b)
        assert err.max() < 5e-5 and err.mean() < 1e-6, (err.max(),
                                                          err.mean())
        assert np.abs(a).sum() > 0
    # within 1e-6 and of the same classes: XLA's jitted codecs land an ulp
    # or two off eager JAX's (it folds the divisions by constants), which
    # the port matches bit for bit (test_codecs_match_jax)
    for name in ("light_direction_pred.npy", "light_intensity_pred.npy"):
        a = np.load(os.path.join(got, name), allow_pickle=True)
        b = np.load(os.path.join(want, name), allow_pickle=True)
        assert a.dtype == b.dtype and a.shape == b.shape
        if ragged:
            assert a.dtype == object and [x.shape for x in a] == \
                [x.shape for x in b] == ([(4, 3), (3, 3)] if "dir" in name
                                         else [(4,), (3,)])
        for x, y in zip(a, b):
            x, y = (torch.as_tensor(np.asarray(v, np.float32)) for v in (x, y))
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)
            codec = (sdps.spherical_dirs_to_class if "dir" in name
                     else lambda v: [sdps.light_ints_to_class(v)])
            for cx, cy in zip(codec(x), codec(y)):
                np.testing.assert_array_equal(cx.numpy(), cy.numpy())


def _scene_copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _png_trees_equal(a, b):
    from PIL import Image

    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        with Image.open(os.path.join(a, rel)) as x, \
                Image.open(os.path.join(b, rel)) as y:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=rel)
        with open(os.path.join(a, rel), "rb") as x, \
                open(os.path.join(b, rel), "rb") as y:
            assert x.read() == y.read(), rel


@pytest.mark.parametrize("mode", ["plain", "intnorm_gt", "intnorm_sdps"])
def test_light_average_matches_jax(tmp_path, mode):
    src = tmp_path / "src"
    generate_synthetic_scene(str(src), n_views=2, n_test=1, n_lights=5,
                             hw=(24, 28))
    rng = np.random.default_rng(5)
    if mode == "intnorm_gt":
        with open(src / "params.json") as f:
            para = json.load(f)
        para["light_intensity"] = rng.uniform(0.5, 1.5, (5, 3)).tolist()
        with open(src / "params.json", "w") as f:
            json.dump(para, f)
    if mode == "intnorm_sdps":
        np.save(src / "sdps_out_l5" / "light_intensity_pred.npy",
                rng.uniform(0.5, 1.5, (3, 5)).astype(np.float32))
    kw = dict(intnorm=mode != "plain", sdps=mode == "intnorm_sdps")
    got = light_avg.light_average(_scene_copy(src, tmp_path / "port"), **kw)
    want = jlight_avg.light_average(_scene_copy(src, tmp_path / "jax"), **kw)
    assert os.path.relpath(got, tmp_path / "port") == \
        os.path.relpath(want, tmp_path / "jax") == {
            "plain": "img", "intnorm_gt": "img_intnorm_gt",
            "intnorm_sdps": "img_intnorm_sdps_l5"}[mode]
    _png_trees_equal(got, want)
