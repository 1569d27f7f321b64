"""psnerf_torch core math, BRDFs and metrics against psnerf_tpu (1e-6 abs;
the numpy metrics exactly)."""

import numpy as np
import pytest
import torch

from psnerf_tpu.core import encoding as jenc, rays as jrays
from psnerf_tpu.eval import metrics as jmetrics
from psnerf_tpu.fields import brdf as jbrdf
from psnerf_torch.core import encoding, rays
from psnerf_torch.eval import metrics
from psnerf_torch.fields import brdf
from torch_helpers import j, t, unit

torch.set_num_threads(1)
ATOL = 1e-6


@pytest.mark.parametrize("n_freqs", [0, 4, 10])
def test_nerf_embed(n_freqs):
    rng = np.random.default_rng(0)
    p = (rng.normal(size=(7, 5, 3)) * 0.4).astype(np.float32)
    ref = np.asarray(jenc.nerf_embed(j(p), n_freqs))
    got = encoding.nerf_embed(t(p), n_freqs).numpy()
    assert got.shape == ref.shape
    assert encoding.nerf_embed_dim(3, n_freqs) == got.shape[-1]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pose_kind", ["matrix", "quat"])
def test_get_camera_params(pose_kind):
    rng = np.random.default_rng(1)
    uv = rng.uniform(0, 32, size=(50, 2)).astype(np.float32)
    K = np.asarray([[40.0, 0, 16, 0], [0, 42.0, 15, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float32)
    if pose_kind == "matrix":
        q = unit(rng, (4,))
        pose = np.asarray(jrays.pose_to_matrix(
            j(np.concatenate([q, [0.1, -0.2, 3.0]]).astype(np.float32))))
    else:
        pose = np.concatenate([unit(rng, (4,)), [0.1, -0.2, 3.0]]).astype(
            np.float32)
    rd_ref, loc_ref = jrays.get_camera_params(j(uv), j(pose), j(K))
    rd, loc = rays.get_camera_params(t(uv), t(pose), t(K))
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_ref), atol=ATOL)
    np.testing.assert_allclose(loc.numpy(), np.asarray(loc_ref), atol=ATOL)
    np.testing.assert_allclose(
        rays.pose_to_matrix(t(pose)).numpy(),
        np.asarray(jrays.pose_to_matrix(j(pose))), atol=ATOL)


@pytest.mark.parametrize("specular_rgb", [True, False])
def test_sg_basis(specular_rgb):
    rng = np.random.default_rng(2)
    n = 64
    v, nrm, l = unit(rng, (n, 3)), unit(rng, (n, 3)), unit(rng, (n, 3))
    albedo = rng.uniform(size=(n, 3)).astype(np.float32)
    w = (np.abs(rng.normal(size=(n, 27 if specular_rgb else 9))) * 0.2
         ).astype(np.float32)
    ref = jbrdf.sg_basis(j(v), j(nrm), j(l), j(albedo), j(w), specular_rgb)
    got = brdf.sg_basis(t(v), t(nrm), t(l), t(albedo), t(w), specular_rgb)
    np.testing.assert_array_equal(brdf.SG_LOBES, jbrdf.SG_LOBES)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_microfacet_brdf():
    rng = np.random.default_rng(3)
    n = 64
    l, v, nrm = unit(rng, (n, 3)), unit(rng, (n, 3)), unit(rng, (n, 3))
    albedo = rng.uniform(size=(n, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.9, size=(n, 1)).astype(np.float32)
    ref = np.asarray(jbrdf.microfacet_brdf(j(l), j(v), j(nrm), j(albedo),
                                           j(rough)))
    got = brdf.microfacet_brdf(t(l), t(v), t(nrm), t(albedo), t(rough))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match(masked):
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    m = rng.uniform(size=(24, 20)) > 0.3 if masked else None
    assert metrics.psnr(a, b, m) == jmetrics.psnr(a, b, m)
    assert metrics.ssim(a, b) == jmetrics.ssim(a, b)
    na, nb = unit(rng, (24, 20, 3)), unit(rng, (24, 20, 3))
    got, ref = metrics.mae(na, nb, m), jmetrics.mae(na, nb, m)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])
