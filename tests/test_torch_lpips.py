"""psnerf_torch.eval.lpips_torch against psnerf_tpu.eval.lpips_jax on the
CPU, with random AlexNet+LPIPS weights written through
tools/export_lpips_npz.py: the five ReLU taps and the distance within 1e-5
relative, 0 for a pair of the same image, the three state-dict key
spellings, the status without weights, and evaluate_outputs with weights
against the JAX package's (psnr, ssim, lpips within 1e-5 relative)."""

import json
import os
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_torch.data.scene import imread, imwrite
from psnerf_torch.data.synthetic import generate_synthetic_scene
from psnerf_torch.eval import evaluation, lpips_torch
from psnerf_tpu.eval import evaluation as jevaluation
from psnerf_tpu.eval import lpips_jax
from torch_helpers import random_lpips_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    sys.path.insert(0, str(ROOT / "tools"))
    from export_lpips_npz import export_from_state_dict

    path = str(tmp_path_factory.mktemp("lpips") / "lpips_alex.npz")
    export_from_state_dict(random_lpips_state_dict(), path)
    return path


def _images(hw=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(*hw, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_taps_and_distance_match_jax(npz):
    params = lpips_torch.load_weights(npz)
    jparams = lpips_jax.load_weights(npz)
    assert sorted(params) == sorted(jparams)
    x = np.random.default_rng(1).normal(size=(2, 3, 64, 64)) \
        .astype(np.float32)
    got = lpips_torch.alex_features(params, torch.as_tensor(x))
    want = lpips_jax.alex_features(jparams, jnp.asarray(x))
    assert [g.shape[1] for g in got] == lpips_torch._TAP_CHANNELS
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
    a, b = _images()
    d = float(lpips_torch.lpips_distance(params, torch.as_tensor(a),
                                         torch.as_tensor(b)))
    dj = float(lpips_jax.lpips_distance(jparams, jnp.asarray(a),
                                        jnp.asarray(b)))
    assert d > 0
    np.testing.assert_allclose(d, dj, rtol=1e-5)
    # the metric's object: same value, 0 for the same image
    metric = lpips_torch.LPIPS(npz, device="cpu")
    assert metric.available
    np.testing.assert_allclose(metric(a, b), dj, rtol=1e-5)
    assert metric(a, a) == 0.0


@pytest.mark.parametrize("spelling", ["lpips", "torchvision", "alex"])
def test_state_dict_spellings(tmp_path, npz, spelling):
    """A torch state dict in each key spelling loads as the npz does."""
    ref = lpips_torch.load_weights(npz)
    ids = [0, 3, 6, 8, 10]
    conv = {"lpips": lambda i, n: f"net.slice{i + 1}.{n}",
            "torchvision": lambda i, n: f"features.{n}",
            "alex": lambda i, n: f"alex.features.{n}"}[spelling]
    head = "lins.{}.model.1.weight" if spelling == "alex" \
        else "lin{}.model.1.weight"
    sd = {}
    for i, n in enumerate(ids):
        sd[conv(i, n) + ".weight"] = ref[f"conv{i}_w"]
        sd[conv(i, n) + ".bias"] = ref[f"conv{i}_b"]
        sd[head.format(i)] = ref[f"lin{i}_w"]
    path = str(tmp_path / "lpips.pth")
    torch.save(sd, path)
    got = lpips_torch.load_weights(path)
    want = lpips_jax.load_weights(path)
    assert sorted(got) == sorted(ref) == sorted(want)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(KeyError, match="head 4"):
        lpips_torch.load_weights_from_torch(
            {k: v for k, v in sd.items() if "4.model" not in k})


def test_unavailable_without_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    metric = lpips_torch.LPIPS()          # no weights: no device is resolved
    assert not metric.available and metric(np.zeros((8, 8, 3)),
                                           np.zeros((8, 8, 3))) is None
    assert not lpips_torch.LPIPS(str(tmp_path / "missing.npz")).available


@pytest.fixture(scope="module")
def scene_and_outputs(tmp_path_factory):
    """A synthetic scene and a stage-2 output tree whose rgb predictions
    are the GT images with noise, norm_mask as mask_pred and world-rotated
    GT normals (tests/test_metrics.py's contract)."""
    root = tmp_path_factory.mktemp("lpips_eval")
    scene, out = str(root / "scene"), str(root / "test_out")
    generate_synthetic_scene(scene, n_views=2, n_test=1, n_lights=2,
                             hw=(48, 48), radius=0.6, focal=60.0)
    with open(os.path.join(scene, "params.json")) as f:
        para = json.load(f)
    rng = np.random.default_rng(7)
    poses = np.asarray(para["pose_c2w"], np.float32)
    for vi in para["view_test"]:
        name = f"view_{vi + 1:02d}"
        for sub in (f"rgb/img/{name}", "mask/img", "normal/npy"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)
        for li in range(len(para["light_direction"])):
            img = imread(os.path.join(scene, "img", name, f"{li + 1:03d}.png"))
            noisy = np.clip(img.astype(np.int16)
                            + rng.integers(-20, 21, img.shape), 0, 255)
            imwrite(os.path.join(out, "rgb", "img", name, f"{li + 1:03d}.png"),
                    noisy.astype(np.uint8))
        shutil.copy(os.path.join(scene, "norm_mask", name + ".png"),
                    os.path.join(out, "mask", "img", name + ".png"))
        n_cam = np.load(os.path.join(scene, "normal", "npy", name + ".npy"))
        np.save(os.path.join(out, "normal", "npy", name + ".npy"),
                np.einsum("ij,hwj->hwi", poses[vi, :3, :3], n_cam))
    return scene, out


def test_evaluate_outputs_with_lpips_matches_jax(npz, scene_and_outputs,
                                                 monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    scene, out = scene_and_outputs
    got = evaluation.evaluate_outputs(scene, out, lpips_weights=npz,
                                      device="cpu")
    want = jevaluation.evaluate_outputs(scene, out, lpips_weights=npz)
    assert got["lpips_status"] == want["lpips_status"] == "computed"
    assert isinstance(got["lpips"], float) and got["lpips"] > 0
    for k in ("psnr", "ssim", "lpips", "normal_mae"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # LPIPS_WEIGHTS is read when no path is given
    monkeypatch.setenv("LPIPS_WEIGHTS", npz)
    env = evaluation.evaluate_outputs(scene, out, device="cpu")
    assert env["lpips"] == got["lpips"]
    # without weights: JAX's null and status string
    monkeypatch.delenv("LPIPS_WEIGHTS")
    got = evaluation.evaluate_outputs(scene, out)
    want = jevaluation.evaluate_outputs(scene, out)
    assert got["lpips"] is None and want["lpips"] is None
    assert got["lpips_status"] == want["lpips_status"]
