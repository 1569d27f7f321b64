"""psnerf_torch's stage-1 field (weight-norm linear, occupancy logits and
features, analytic normals, appearance, radiance_and_alpha) against
psnerf_tpu's on one parameter set, at hidden 128 and 6 layers on 256
points: f32 within 1e-5 abs (PARITY.md's module level), the bf16 operand
path within 1e-2; weight gradients of radiance_and_alpha (second order
through the normals) within 1e-4 of each leaf's scale; the geometric init
by its statistics (the generators differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import mlp as jmlp
from psnerf_tpu.fields import occupancy as jocc
from psnerf_torch.fields import mlp
from psnerf_torch.fields import occupancy as occ
from torch_helpers import flatten_jax, j, port_occ_field, t, unit

torch.set_num_threads(1)
N = 256
JCFG = jocc.OccFieldConfig(num_layers=6, hidden_dim=128, feat_size=128,
                           octaves_pe=6, octaves_pe_views=4, skips=(3,))


def _setup(compute_dtype="float32", seed=0):
    import dataclasses

    jcfg = dataclasses.replace(JCFG, compute_dtype=compute_dtype)
    jparams = jocc.init_occupancy_field(jax.random.PRNGKey(seed), jcfg)
    cfg, field = port_occ_field(jparams, jcfg)
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = unit(rng, (N, 3))
    return jcfg, jparams, cfg, field, p, rd


@pytest.mark.parametrize("bf16", [False, True])
def test_wn_linear(bf16):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(39, 64)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    x = rng.normal(size=(N, 39)).astype(np.float32)
    jl = jmlp.wn_from_dense(j(w), j(b))
    jl = dict(jl, g=jl["g"] * 1.3)
    lyr = mlp.wn_from_dense(t(w), t(b))
    with torch.no_grad():
        lyr.g.mul_(1.3)
    ref = np.asarray(jmlp.wn_linear_apply(
        jl, j(x), compute_dtype=jnp.bfloat16 if bf16 else None))
    got = lyr(t(x), torch.bfloat16 if bf16 else None).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3 if bf16 else 1e-5, rtol=0)
    np.testing.assert_allclose(mlp.wn_weight(lyr).detach().numpy(),
                               np.asarray(jmlp.wn_weight(jl)), atol=1e-6)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_field_functions(dtype, atol):
    jcfg, jp, cfg, field, p, rd = _setup(dtype)
    with torch.no_grad():
        got = occ.occ_logits_and_feat(field, t(p), cfg).numpy()
    ref = np.asarray(jocc.occ_logits_and_feat(jp, j(p), jcfg))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    np.testing.assert_allclose(
        occ.occ_alpha(field, t(p), cfg).detach().numpy(),
        np.asarray(jocc.occ_alpha(jp, j(p), jcfg)), atol=atol, rtol=0)
    gn = occ.occ_gradient(field, t(p), cfg).detach().numpy()
    gref = np.asarray(jocc.occ_gradient(jp, j(p), jcfg))
    np.testing.assert_allclose(gn, gref, atol=atol * np.abs(gref).max(),
                               rtol=0)
    # appearance on the JAX normals and features
    vpe = np.asarray(jax.vmap(lambda v: jnp.concatenate(
        [v] + [f(v * 2.0 ** k) for k in range(4) for f in (jnp.sin, jnp.cos)]
    ))(j(rd)))
    feat = ref[:, 1:]
    a = occ.appearance(field, t(p), t(gref), t(vpe), t(feat), cfg)
    aref = jocc.appearance(jp, j(p), j(gref), j(vpe), j(feat), jcfg)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(aref),
                               atol=atol, rtol=0)
    rgb, alpha = occ.radiance_and_alpha(field, t(p), t(rd), cfg)
    rref, aref = jocc.radiance_and_alpha(jp, j(p), j(rd), jcfg)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rref),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(aref),
                               atol=atol, rtol=0)


def test_radiance_weight_gradients_second_order():
    """d/dparams of a loss on rgb and alpha: through the appearance MLP and
    the analytic normals into the geometry weights (second order)."""
    jcfg, jp, cfg, field, p, rd = _setup()
    rng = np.random.default_rng(7)
    w_rgb = rng.normal(size=(N, 3)).astype(np.float32)
    w_a = rng.normal(size=(N,)).astype(np.float32)

    def loss_ref(params):
        rgb, alpha = jocc.radiance_and_alpha(params, j(p), j(rd), jcfg)
        return jnp.sum(rgb * w_rgb) + jnp.sum(alpha * w_a)

    ref = flatten_jax(jax.grad(loss_ref)(jp))
    rgb, alpha = occ.radiance_and_alpha(field, t(p), t(rd), cfg)
    (torch.sum(rgb * t(w_rgb)) + torch.sum(alpha * t(w_a))).backward()
    got = {k.replace(".", "/"): v.grad.numpy()
           for k, v in field.named_parameters()}
    assert set(got) == set(ref)
    for k, a in ref.items():
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(got[k] / scale, a / scale, rtol=0,
                                   atol=1e-4, err_msg=k)


def test_param_tree_matches_jax():
    jparams = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    ref = flatten_jax(jparams)
    field = occ.init_occupancy_field(
        occ.OccFieldConfig(**{k: getattr(JCFG, k) for k in
                              JCFG.__dataclass_fields__}))
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in field.state_dict().items()}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype


def test_geometric_init_is_a_sphere():
    """SAL init: the logit is negative inside radius ~0.6 and positive
    outside, for the port's own draws (as for the JAX package's)."""
    cfg = occ.OccFieldConfig(num_layers=6, hidden_dim=128, feat_size=128)
    field = occ.init_occupancy_field(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)
    d = unit(rng, (512, 3))
    with torch.no_grad():
        inside = occ.occ_logit(field, t(d * 0.3), cfg)
        outside = occ.occ_logit(field, t(d * 1.0), cfg)
    assert (inside < 0).float().mean() > 0.95
    assert (outside > 0).float().mean() > 0.95
