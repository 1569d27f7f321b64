"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `gpu` marker and skips when no CUDA device is
present. This file imports only torch and the port (no JAX), because the
machine with the card has no JAX: run it there with
`python -m pytest tests/test_torch_gpu.py -q`.
"""

import numpy as np
import pytest
import torch

from psnerf_torch.core.encoding import nerf_embed
from psnerf_torch.fields.mlp import skip_mlp_init
from psnerf_torch.ops import fused_vis as fv

pytestmark = pytest.mark.gpu


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _setup(n, l, width=256, depth=8, skip=4, specular_rgb=True, seed=0):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    dev = "cuda"
    layers = skip_mlp_init(126, 1, width, depth, (skip,), generator=gen,
                           device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)
    pts = t((rng.normal(size=(n, 3)) * 0.3).astype(np.float32))
    ld = t(_unit(rng, (l, 3)))
    nw = 27 if specular_rgb else 9
    shade = dict(
        normal=t(_unit(rng, (n, 3))), view=t(_unit(rng, (n, 3))),
        albedo=t(rng.uniform(size=(n, 3)).astype(np.float32)),
        weights=t(np.maximum(rng.normal(size=(n, nw)) * 0.3, 0)
                  .astype(np.float32)),
        mask=t(rng.uniform(size=n) > 0.3), light_dirs=ld,
        light_ints=t((rng.uniform(size=l) * 2 + 0.5).astype(np.float32)))
    return layers, nerf_embed(pts, 10), nerf_embed(ld, 10), shade


@pytest.mark.parametrize("width,n,l", [(256, 1000, 7), (128, 640, 3)])
def test_fused_visibility_kernel_matches_plain(width, n, l):
    _need_gpu()
    layers, pe, le, _ = _setup(n, l, width=width)
    before = fv.fused_visibility.launches
    got = fv.fused_visibility(layers, pe, le)
    torch.cuda.synchronize()
    assert fv.fused_visibility.launches == before + 1
    ref = fv.fused_visibility_plain(layers, pe, le)
    assert got.shape == ref.shape == (l, n)
    err = (got - ref).abs()
    # same rounding points; only f32 summation order differs
    assert err.max().item() < 1e-3, err.max().item()


@pytest.mark.parametrize("kw", [
    dict(), dict(layout="cnl"), dict(sum_lights=True),
    dict(specular_rgb=False), dict(per_channel=True)])
def test_fused_vis_shade_kernel_matches_plain(kw):
    _need_gpu()
    kw = dict(kw)
    spec_rgb = kw.get("specular_rgb", True)
    layers, pe, le, sh = _setup(1000, 12, specular_rgb=spec_rgb)
    if kw.pop("per_channel", False):
        li = sh["light_ints"]
        sh["light_ints"] = torch.stack([li, li * 0.5, li * 0.25], dim=-1)
    args = (layers, pe, le, sh["normal"], sh["view"], sh["albedo"],
            sh["weights"], sh["mask"], sh["light_dirs"], sh["light_ints"])
    before = fv.fused_vis_shade.launches
    got = fv.fused_vis_shade(*args, **kw)
    torch.cuda.synchronize()
    assert fv.fused_vis_shade.launches == before + 1
    ref = fv.fused_vis_shade_plain(*args, **kw)
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    assert err.max().item() < 1e-3, err.max().item()


def test_kernel_refuses_unsupported_width():
    _need_gpu()
    layers, pe, le, _ = _setup(64, 2, width=32, depth=4, skip=2)
    with pytest.raises(ValueError, match="widths"):
        fv.fused_visibility(layers, pe, le)
