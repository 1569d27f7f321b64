"""psnerf_torch's stage-1 march and UNISURF render against psnerf_tpu's:
  * ray_marching / secant on the analytic sphere of tests/test_render.py;
  * the march on one field: masks equal, depths within 1e-4;
  * render_unisurf in eval mode (noise=None against key=None) at
    PARITY.md's level: masks exactly equal, rgb and acc within 5e-4;
  * train mode with JAX's own draws rebuilt from its key and passed as the
    port's noise: every output within 1e-4.
The field is f32 at hidden 64, 6 layers (deep enough for the geometric
init to be a sphere), on 256 rays of a 64x64 camera."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.render import marching as jmarch
from psnerf_tpu.render import unisurf as juni
from psnerf_torch.render import marching, unisurf
from torch_helpers import j, port_config, port_occ_field, t

torch.set_num_threads(1)
JCFG = jocc.OccFieldConfig(num_layers=6, hidden_dim=64, feat_size=64,
                           octaves_pe=4, octaves_pe_views=2)
JRCFG = juni.UnisurfConfig(near=1.2, far=5.0, radius=1.2, interval_start=0.6,
                           interval_end=0.05, interval_decay=1e-3,
                           num_points_in=16, num_points_out=8,
                           ray_marching_steps=64)


def sphere_occ(p, r=0.7, sharp=50.0):
    d = torch.linalg.norm(p, dim=-1) - r
    return torch.sigmoid(-sharp * d)


def test_ray_marching_analytic_sphere():
    n = 8
    ray0 = torch.tensor([[0.0, 0.0, -3.0]]).repeat(n, 1)
    ys = torch.linspace(0.0, 1.2, n)
    dirs = torch.stack([torch.zeros(n), ys, torch.ones(n)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    d = marching.ray_marching(sphere_occ, ray0, dirs, n_steps=128, near=0.5,
                              rad=2.0).numpy()
    assert abs(d[0] - 2.3) < 0.01
    assert np.isinf(d[-1])
    finite = np.isfinite(d)
    assert np.all(np.diff(d[finite]) > -1e-3)
    # a ray starting inside: the first sample is occupied -> the 0 sentinel
    d0 = marching.ray_marching(sphere_occ, torch.zeros((2, 3)),
                               torch.tensor([[0.0, 0.0, 1.0], [1.0, 0, 0]]),
                               n_steps=64, near=0.01, rad=2.0)
    np.testing.assert_allclose(d0.numpy(), 0.0)


def test_secant_refines_root():
    d = marching.secant(lambda p: sphere_occ(p) - 0.5,
                        torch.tensor([-0.49]), torch.tensor([0.49]),
                        torch.tensor([2.0]), torch.tensor([2.6]),
                        torch.tensor([[0.0, 0.0, -3.0]]),
                        torch.tensor([[0.0, 0.0, 1.0]]))
    assert abs(float(d[0]) - 2.3) < 1e-4


@pytest.fixture(scope="module")
def scene():
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    cfg, field = port_occ_field(jp, JCFG)
    rcfg = port_config(JRCFG, unisurf.UnisurfConfig)
    k = np.asarray([[100.0, 0, 32, 0], [0, 100.0, 32, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1.0]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -3.0]
    ys, xs = np.mgrid[0:64:4, 0:64:4]
    pix = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    return jp, cfg, field, rcfg, k, pose, pix


def test_march_matches_jax(scene):
    jp, cfg, field, _, k, pose, pix = scene
    from psnerf_tpu.core.rays import image_points_to_ray
    from psnerf_torch.fields.occupancy import occ_alpha

    ray = np.asarray(image_points_to_ray(j(pix), j(k), j(pose)))
    ray = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    ray0 = np.broadcast_to(pose[:3, 3], ray.shape).copy()
    for phase in (None, 0.37):
        key = None
        if phase is not None:   # the port takes JAX's draw as a tensor
            key = jax.random.PRNGKey(4)
            phase = float(jax.random.uniform(key, ()))
        ref = np.asarray(jmarch.ray_marching(
            lambda p: jocc.occ_alpha(jp, p, JCFG), j(ray0), j(ray),
            n_steps=64, near=1.2, rad=1.2, phase_key=key))
        got = marching.ray_marching(
            lambda p: occ_alpha(field, p, cfg), t(ray0), t(ray), n_steps=64,
            near=1.2, rad=1.2,
            phase=None if phase is None else torch.tensor(phase)).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        np.testing.assert_array_equal(got == 0, ref == 0)
        hit = np.isfinite(ref)
        assert 0.2 < hit.mean() < 0.9
        np.testing.assert_allclose(got[hit], ref[hit], atol=1e-4, rtol=0)


def _jax_noise(key, n, s):
    """JAX's draws of render_unisurf(key=key), as the port's noise dict."""
    k_phase, k_n1, k_n2, k_jit = jax.random.split(key, 4)
    u = lambda k, shape: torch.as_tensor(np.array(
        jax.random.uniform(k, shape, dtype=jnp.float32)))
    return {"phase": u(k_phase, ()), "hit": u(k_n1, (n, s)),
            "miss": u(k_n2, (n, s)), "jitter": u(k_jit, (n, 3))}


@pytest.mark.parametrize("use_outside", [True, False])
def test_eval_render_matches_jax(scene, use_outside):
    jp, cfg, field, rcfg, k, pose, pix = scene
    ref = juni.render_unisurf(jp, JCFG, JRCFG, j(pix), j(k), j(pose),
                              it=1e5, key=None, use_outside=use_outside,
                              train=False)
    with torch.no_grad():
        got = unisurf.render_unisurf(field, cfg, rcfg, t(pix), t(k), t(pose),
                                     it=1e5, noise=None,
                                     use_outside=use_outside, train=False)
    np.testing.assert_array_equal(got["mask_pred"].numpy(),
                                  np.asarray(ref["mask_pred"]))
    assert got["diff_norm"] is None
    for name in ("rgb", "acc_map"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=5e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(got["normal_pred"].numpy(),
                               np.asarray(ref["normal_pred"]), atol=5e-4)


def test_train_render_matches_jax_with_its_noise(scene):
    jp, cfg, field, rcfg, k, pose, pix = scene
    key = jax.random.PRNGKey(11)
    ref = juni.render_unisurf(jp, JCFG, JRCFG, j(pix), j(k), j(pose),
                              it=3000.0, key=key, use_outside=True,
                              train=True)
    noise = _jax_noise(key, pix.shape[0], 24)
    with torch.no_grad():
        got = unisurf.render_unisurf(field, cfg, rcfg, t(pix), t(k), t(pose),
                                     it=3000.0, noise=noise,
                                     use_outside=True, train=True)
    np.testing.assert_array_equal(got["mask_pred"].numpy(),
                                  np.asarray(ref["mask_pred"]))
    for name in ("rgb", "acc_map", "normal_pred", "diff_norm", "points"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=1e-4, rtol=0, err_msg=name)
    with pytest.raises(ValueError, match="noise"):
        unisurf.render_unisurf(field, cfg, rcfg, t(pix), t(k), t(pose),
                               noise=None, train=True)


def test_draw_noise_shapes():
    gen = torch.Generator().manual_seed(0)
    nz = unisurf.draw_unisurf_noise(5, 7, gen, "cpu")
    assert nz["phase"].shape == () and nz["hit"].shape == (5, 7)
    assert nz["miss"].shape == (5, 7) and nz["jitter"].shape == (5, 3)
    for v in nz.values():
        assert (v >= 0).all() and (v < 1).all()
