"""psnerf_torch MLPs, PSNet heads and eval shading against psnerf_tpu, at
the full PSNetConfig() widths on 256 points x 5 lights (f32 1e-5 abs, the
PARITY.md module level; bf16 heads 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields.mlp import skip_mlp_apply as jskip_apply
from psnerf_tpu.fields.mlp import skip_mlp_init as jskip_init
from psnerf_tpu.fields.psnet import PSNetConfig as JCfg, init_psnet as jinit
from psnerf_tpu.render import shading as jshading
from psnerf_torch.fields.mlp import skip_mlp_apply, skip_mlp_init
from psnerf_torch.render import shading
from psnerf_torch.train.checkpoints import load_module
from torch_helpers import flatten_jax, j, port_config, port_psnet, t, unit

torch.set_num_threads(1)
N, L = 256, 5


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("skip_at,final", [((4,), "none"), ((2,), "sigmoid")])
def test_skip_mlp_apply(bf16, skip_at, final):
    rng = np.random.default_rng(0)
    layers = jskip_init(jax.random.PRNGKey(0), 63, 3, 128, 6, skip_at)
    port = load_module(skip_mlp_init(63, 3, 128, 6, skip_at),
                       flatten_jax(layers))
    x = (rng.normal(size=(N, 63)) * 0.5).astype(np.float32)
    ref = np.asarray(jskip_apply(layers, j(x), skip_at, final,
                                 compute_dtype=jnp.bfloat16 if bf16 else None))
    got = skip_mlp_apply(port, t(x), skip_at, final,
                         compute_dtype=torch.bfloat16 if bf16 else None)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-3 if bf16 else 1e-5,
                                   rtol=0)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(N, 3)) * 0.3).astype(np.float32)
    return dict(
        points=pts, normals=unit(rng, (N, 3)),
        mask=rng.uniform(size=N) > 0.3, rays=unit(rng, (N, 3)),
        ldirs=unit(rng, (L, 3)),
        lints=(rng.uniform(size=L) * 2 + 0.5).astype(np.float32))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_psnet_point_heads(compute_dtype):
    jcfg = JCfg(compute_dtype=compute_dtype)
    params = jinit(jax.random.PRNGKey(1), jcfg)
    model = port_psnet(params, jcfg)
    s = _scene()
    ref = jshading.psnet_point_heads(params, jcfg, j(s["points"]),
                                     j(s["normals"]))
    with torch.no_grad():
        got = shading.psnet_point_heads(model, model.cfg, t(s["points"]),
                                        t(s["normals"]))
    assert set(got) == set(ref)
    tol = 1e-3 if compute_dtype == "bfloat16" else 1e-5
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("cfg_kw", [
    dict(), dict(specular_rgb=False, normal_mlp=False),
    dict(render_model="microfacet"), dict(visibility=False)])
def test_render_psnet_eval(cfg_kw):
    jcfg = JCfg(**cfg_kw)
    params = jinit(jax.random.PRNGKey(2), jcfg)
    model = port_psnet(params, jcfg)
    s = _scene(1)
    args = (s["points"], s["normals"], s["mask"], s["rays"], s["ldirs"],
            s["lints"])
    ref = jax.jit(lambda p, *a: jshading.render_psnet(p, jcfg, *a))(
        params, *map(j, args))
    with torch.no_grad():
        got = shading.render_psnet(model, model.cfg, *map(t, args))
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k].numpy(), r, atol=1e-5, rtol=0,
                                   err_msg=k)


def test_render_psnet_vis_precomputed():
    jcfg = JCfg()
    params = jinit(jax.random.PRNGKey(3), jcfg)
    model = port_psnet(params, jcfg)
    s = _scene(2)
    vis = np.random.default_rng(5).uniform(-0.2, 1.2, size=(L, N, 1)).astype(
        np.float32)
    args = (s["points"], s["normals"], s["mask"], s["rays"], s["ldirs"],
            s["lints"])
    ref = jshading.render_psnet(params, jcfg, *map(j, args),
                                vis_precomputed=j(vis))
    with torch.no_grad():
        got = shading.render_psnet(model, model.cfg, *map(t, args),
                                   vis_precomputed=t(vis))
    for k in ("rgb", "visibility", "rough"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_port_config_copies_every_field():
    from psnerf_torch.fields.psnet import PSNetConfig

    assert port_config(JCfg(), PSNetConfig) == PSNetConfig()
