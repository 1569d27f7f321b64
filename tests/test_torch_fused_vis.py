"""The port's plain versions of the fused visibility kernels (K4
fused_visibility, K5 fused_vis_shade) against psnerf_tpu's Pallas kernels
run with interpret=True, at the shapes of tests/test_fused_vis.py (width
256, depth 8, skip 4, N=512, L=12).

Bar vs interpret mode: 1e-3 max abs on raw vis and rgb. Both sides round to
bf16 at the same points, so only the f32 summation order differs (the
measured gap is ~1e-5). Against the f32 XLA reference the bars are the JAX
kernel tests' own (rel < 0.05 and corr > 0.999 on raw vis; rgb max < 2e-2,
mean < 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.core.encoding import nerf_embed as jembed
from psnerf_tpu.fields.mlp import skip_mlp_apply as jskip_apply
from psnerf_tpu.fields.mlp import skip_mlp_init as jskip_init
from psnerf_tpu.ops import fused_vis as jfv
from psnerf_torch.core.encoding import nerf_embed
from psnerf_torch.fields.mlp import skip_mlp_init
from psnerf_torch.ops import fused_vis as fv
from psnerf_torch.train.checkpoints import load_module
from torch_helpers import flatten_jax, j, t, unit

torch.set_num_threads(1)
E, WIDTH, DEPTH, SKIP = 63, 256, 8, 4
N = 512


def _setup(l=12, specular_rgb=True, seed=0):
    layers = jskip_init(jax.random.PRNGKey(0), 2 * E, 1, WIDTH, DEPTH, (SKIP,))
    port = load_module(skip_mlp_init(2 * E, 1, WIDTH, DEPTH, (SKIP,)),
                       flatten_jax(layers))
    rng = np.random.default_rng(seed)
    nw = 27 if specular_rgb else 9
    d = dict(
        pts=(rng.normal(size=(N, 3)) * 0.3).astype(np.float32),
        ldirs=unit(rng, (l, 3)), normal=unit(rng, (N, 3)),
        view=unit(rng, (N, 3)),
        albedo=rng.uniform(size=(N, 3)).astype(np.float32),
        weights=np.maximum(rng.normal(size=(N, nw)) * 0.3, 0).astype(
            np.float32),
        mask=rng.uniform(size=N) > 0.3,
        lints=(rng.uniform(size=l) * 2 + 0.5).astype(np.float32))
    return layers, port, d


def _shade_args(d, lints=None):
    keys = ("normal", "view", "albedo", "weights", "mask", "ldirs")
    return [d[k] for k in keys] + [d["lints"] if lints is None else lints]


def _both_shade(layers, port, d, lints=None, **kw):
    args = _shade_args(d, lints)
    ref = jfv.fused_vis_shade(
        layers, jembed(j(d["pts"]), 10), jembed(j(d["ldirs"]), 10),
        *map(j, args), tile=256, interpret=True, **kw)
    got = fv.fused_vis_shade(
        port, nerf_embed(t(d["pts"]), 10), nerf_embed(t(d["ldirs"]), 10),
        *map(t, args), **kw)
    return np.asarray(ref), got.numpy()


def test_fused_visibility_plain_matches_interpret_and_xla():
    layers, port, d = _setup()
    pe, le = jembed(j(d["pts"]), 10), jembed(j(d["ldirs"]), 10)
    ref = np.asarray(jfv.fused_visibility(layers, pe, le, tile=256,
                                          interpret=True))
    before = fv.fused_visibility.launches
    got = fv.fused_visibility(port, nerf_embed(t(d["pts"]), 10),
                              nerf_embed(t(d["ldirs"]), 10)).numpy()
    assert fv.fused_visibility.launches == before  # CPU: plain, no launch
    assert got.shape == ref.shape == (12, N)
    assert np.abs(got - ref).max() < 1e-3

    def xla_one_light(lemb):
        x = jnp.concatenate([pe, jnp.broadcast_to(lemb, (N, E))], axis=-1)
        return jskip_apply(layers, x, (SKIP,), "none")[..., 0]

    xla = np.asarray(jax.vmap(xla_one_light)(le))
    rel = np.abs(got - xla) / (np.abs(xla) + 1e-2)
    assert rel.max() < 0.05
    assert np.corrcoef(got.ravel(), xla.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("kw", [
    dict(), dict(layout="cnl"), dict(sum_lights=True),
    dict(specular_rgb=False)])
def test_fused_vis_shade_plain_matches_interpret(kw):
    layers, port, d = _setup(specular_rgb=kw.get("specular_rgb", True))
    before = fv.fused_vis_shade.launches
    ref, got = _both_shade(layers, port, d, **kw)
    assert fv.fused_vis_shade.launches == before
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-3


@pytest.mark.parametrize("kind", ["scalar", "per_channel"])
def test_fused_vis_shade_intensity_forms(kind):
    layers, port, d = _setup()
    li = d["lints"]
    lints = (np.float32(1.7) if kind == "scalar"
             else np.stack([li, li * 0.5, li * 0.25], -1))
    ref, got = _both_shade(layers, port, d, lints=lints)
    assert np.abs(got - ref).max() < 1e-3


def test_fused_vis_shade_single_light():
    layers, port, d = _setup(l=1)
    ref, got = _both_shade(layers, port, d)
    assert got.shape == (1, N, 3)
    assert np.abs(got - ref).max() < 1e-3


def test_fused_vis_shade_antipodal_lights_finite():
    """l = -v exactly: 2 + 2 l.v can round below 0; the clamps keep it
    finite, as in the JAX kernel."""
    layers, port, d = _setup(l=8)
    d["view"] = np.broadcast_to(np.float32([0, 0, 1]), (N, 3)).copy()
    d["ldirs"][0] = (0.0, 0.0, -1.0)
    ref, got = _both_shade(layers, port, d)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 1e-3
    ref_s, got_s = _both_shade(layers, port, d, sum_lights=True)
    assert np.isfinite(got_s).all()
    assert np.abs(got_s - ref_s).max() < 1e-3


def test_fused_vis_shade_plain_matches_xla_reference():
    """Against the f32 shading of render_psnet at the JAX kernel tests'
    bars; the sum outside the mask is exactly L (ones-fill on real lights)."""
    from psnerf_tpu.fields.brdf import sg_basis

    layers, port, d = _setup()
    pe = jembed(j(d["pts"]), 10)

    def one_light(ldir, lint):
        lfull = jnp.broadcast_to(ldir, (N, 3))
        brdf, _ = sg_basis(v=j(d["view"]), n=j(d["normal"]), l=lfull,
                           albedo=j(d["albedo"]), weights=j(d["weights"]),
                           specular_rgb=True)
        cos = jnp.sum(lfull * j(d["normal"]), axis=-1, keepdims=True)
        x = jnp.concatenate([pe, jembed(lfull, 10)], axis=-1)
        vis = jskip_apply(layers, x, (SKIP,), "none")
        return jnp.clip(brdf * lint * cos * jnp.clip(vis, 0, 1), 0.0, 1.0)

    xla = np.asarray(jax.vmap(one_light)(j(d["ldirs"]), j(d["lints"])))
    xla = np.where(d["mask"][None, :, None], xla, 1.0)
    _, got = _both_shade(layers, port, d)
    err = np.abs(got - xla)
    assert err.max() < 2e-2 and err.mean() < 2e-3
    _, s = _both_shade(layers, port, d, sum_lights=True)
    np.testing.assert_allclose(s, got.sum(0), atol=1e-4)
    assert (s[~d["mask"]] == 12.0).all()


def test_wrappers_reject_bad_inputs():
    layers, port, d = _setup(l=3)
    pe = nerf_embed(t(d["pts"]), 10)
    le = nerf_embed(t(d["ldirs"]), 10)
    with pytest.raises(ValueError, match="layout"):
        fv.fused_vis_shade(port, pe, le, *map(t, _shade_args(d)),
                           layout="nlc")
    with pytest.raises(ValueError, match="weights"):
        fv.fused_vis_shade(port, pe, le, *map(t, _shade_args(d)),
                           specular_rgb=False)
    with pytest.raises(ValueError, match="float32"):
        fv.fused_visibility(port, pe.double(), le.double())


@pytest.mark.parametrize("width", [64, 128, 256])
def test_slab_packing_unpacks_to_the_operands(width):
    """The kernel's k-step slabs give back pack_vis_operands' w0xT, w5xT and
    trunk bit for bit under the plain inverse of their layout."""
    from psnerf_torch.ops.build import unpack_slabs

    layers = skip_mlp_init(2 * E, 1, width, DEPTH, (SKIP,),
                           generator=torch.Generator().manual_seed(width))
    rng = np.random.default_rng(width)
    ops = fv.pack_vis_operands(
        layers, nerf_embed(t(rng.normal(size=(40, 3)).astype(np.float32)), 10),
        nerf_embed(t(unit(rng, (3, 3))), 10))
    slabs = fv.vis_slabs(ops)
    nt = ops["trunk_wT"].shape[0]
    got = unpack_slabs(slabs, width, [ops["ke"]] * 2 + [width] * nt)
    want = [ops["w0xT"], ops["w5xT"], *ops["trunk_wT"]]
    assert len(got) == len(want) == 2 + nt
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("l", [1, 5, 12])
def test_light_sum_follows_the_kernel_order(l):
    """The plain light sum adds lights 0, 2, 4, ... and 1, 3, 5, ... in
    turn, then the two partials (the kernel's fixed order); it agrees with
    the [L, N, 3] form summed over lights to f32 rounding."""
    layers, port, d = _setup(l=l)
    args = [t(x) for x in _shade_args(d)]
    pe, le = nerf_embed(t(d["pts"]), 10), nerf_embed(t(d["ldirs"]), 10)
    per_light = fv.fused_vis_shade(port, pe, le, *args)
    got = fv.fused_vis_shade(port, pe, le, *args, sum_lights=True)
    want = [torch.zeros(N, 3), torch.zeros(N, 3)]
    for i in range(l):
        want[i % 2] = want[i % 2] + per_light[i]
    assert torch.equal(got, want[0] + want[1])
    np.testing.assert_allclose(got.numpy(), per_light.sum(0).numpy(),
                               rtol=1e-6, atol=1e-5)
