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


# widths 64, 128 and 256; L of 1, 7 and 96; N ragged against the kernel's
# 64-pixel tile and its 128-row CTA
@pytest.mark.parametrize("width,n,l", [
    (256, 1000, 7), (128, 640, 3), (64, 333, 1), (256, 130, 96),
    (128, 1001, 96), (64, 4097, 7), (256, 63, 1)])
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


@pytest.mark.parametrize("kw,width,n,l", [
    (dict(), 256, 1000, 12), (dict(layout="cnl"), 256, 1000, 12),
    (dict(sum_lights=True), 256, 1000, 12),
    (dict(specular_rgb=False), 256, 1000, 12),
    (dict(per_channel=True), 256, 1000, 12),
    (dict(), 64, 333, 1), (dict(layout="cnl"), 128, 1001, 7),
    (dict(sum_lights=True), 256, 130, 96), (dict(sum_lights=True), 64, 77, 7),
    (dict(), 128, 4097, 96), (dict(layout="cnl"), 256, 200, 96)])
def test_fused_vis_shade_kernel_matches_plain(kw, width, n, l):
    _need_gpu()
    kw = dict(kw)
    spec_rgb = kw.get("specular_rgb", True)
    layers, pe, le, sh = _setup(n, l, width=width, specular_rgb=spec_rgb)
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


@pytest.mark.parametrize("width,n,l", [(256, 1000, 96), (64, 333, 7)])
def test_fused_vis_shade_light_sum_is_bitwise_reproducible(width, n, l):
    """The light sum adds each warpgroup's lights in order, then the two
    partials: the same bits on every run."""
    _need_gpu()
    layers, pe, le, sh = _setup(n, l, width=width)
    args = (layers, pe, le, sh["normal"], sh["view"], sh["albedo"],
            sh["weights"], sh["mask"], sh["light_dirs"], sh["light_ints"])
    runs = [fv.fused_vis_shade(*args, sum_lights=True) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("width,n", [(256, 65536), (64, 333)])
def test_fused_vis_shade_envmap_chunk(width, n):
    """The light sum of one envmap relighting chunk: 128 texel lights with
    per-channel intensities [L, 3], against the plain version (which adds
    the lights in the kernel's order), and the same bits on every run."""
    _need_gpu()
    l = 128
    layers, pe, le, sh = _setup(n, l, width=width)
    with torch.no_grad():      # clipped at raw init, the visibility is 0
        layers[-1].b += 0.5    # almost everywhere: lift its output
    rng = np.random.default_rng(5)
    texels = torch.as_tensor(rng.uniform(0.0, 0.05, size=(l, 3))
                             .astype(np.float32), device="cuda")
    args = (layers, pe, le, sh["normal"], sh["view"], sh["albedo"],
            sh["weights"], sh["mask"], sh["light_dirs"], texels)
    before = fv.fused_vis_shade.launches
    runs = [fv.fused_vis_shade(*args, sum_lights=True) for _ in range(3)]
    torch.cuda.synchronize()
    assert fv.fused_vis_shade.launches == before + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    ref = fv.fused_vis_shade_plain(*args, sum_lights=True)
    assert runs[0].shape == ref.shape == (n, 3)
    assert torch.isfinite(runs[0]).all()
    # the channels see different intensities
    inside = sh["mask"]
    assert not torch.equal(runs[0][inside, 0], runs[0][inside, 1])
    err = (runs[0] - ref).abs()
    assert err.max().item() < 1e-3, err.max().item()


def test_kernel_refuses_unsupported_width():
    _need_gpu()
    layers, pe, le, _ = _setup(64, 2, width=32, depth=4, skip=2)
    with pytest.raises(ValueError, match="widths"):
        fv.fused_visibility(layers, pe, le)


# ------------------------------------------------ stage-1 kernels K1, K2, K3

def _occ_field(width=256, layers=8, seed=0, compute="bfloat16"):
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)

    cfg = OccFieldConfig(num_layers=layers, hidden_dim=width,
                         feat_size=width, skips=(layers // 2,),
                         compute_dtype=compute)
    gen = torch.Generator().manual_seed(seed)
    return cfg, init_occupancy_field(cfg, generator=gen, device="cuda")


def _corr(a, b):
    return float(np.corrcoef(a.flatten().cpu().numpy(),
                             b.flatten().cpu().numpy())[0, 1])


@pytest.mark.parametrize("width,layers,n", [
    (256, 8, 3000), (128, 6, 640),
    *[(256, 8, n) for n in (1, 63, 2048, 70001, 1 << 20)],
    *[(128, 6, n) for n in (1, 63, 2048, 70001)]])
def test_fused_occ_kernel_matches_plain(width, layers, n):
    _need_gpu()
    from psnerf_torch.ops import fused_occ as fo

    cfg, field = _occ_field(width, layers)
    rng = np.random.default_rng(1)
    p = torch.as_tensor((rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
                        device="cuda")
    before = fo.fused_occ_logit.launches
    got = fo.fused_occ_logit(field, p, cfg)
    torch.cuda.synchronize()
    assert fo.fused_occ_logit.launches == before + 1
    ref = fo.fused_occ_logit_plain(field, p, cfg)
    assert got.shape == ref.shape == (n,)
    # same rounding points; only f32 summation order differs
    assert (got - ref).abs().max().item() < 1e-2
    if n > 2:
        assert _corr(got, ref) > 0.9999


def _radiance_inputs(cfg, n, seed=2):
    from psnerf_torch.ops import fused_radiance as fr

    rng = np.random.default_rng(seed)
    p = torch.as_tensor((rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
                        device="cuda")
    rd = torch.as_tensor(_unit(rng, (n, 3)), device="cuda")
    return fr.radiance_inputs(p, rd, cfg)


@pytest.mark.parametrize("width,layers,n", [(256, 8, 1000), (128, 4, 200)])
def test_fused_radiance_kernels_match_plain(width, layers, n):
    _need_gpu()
    from psnerf_torch.ops import fused_radiance as fr

    cfg, field = _occ_field(width, layers)
    em, de, vpe, p3 = _radiance_inputs(cfg, n)
    skip = cfg.skips[0] - 1
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.bfloat16)
    f0 = fr.radiance_forward.launches["bfloat16"]
    b0 = fr.radiance_backward.launches["bfloat16"]
    out, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip)
    torch.cuda.synchronize()
    ref, g_e_ref = fr.radiance_forward_plain(packed, em, de, vpe, p3, skip)
    assert out.shape == ref.shape == (n, 4)
    assert torch.isfinite(out).all() and torch.isfinite(g_e).all()
    assert (out - ref).abs().max().item() < 2e-2
    assert (out - ref).abs().mean().item() < 2e-3
    assert (g_e - g_e_ref).abs().max().item() < 2e-2 * g_e_ref.abs().max()

    rng = np.random.default_rng(3)
    # a loss that grows with every output holds the bars; random signs make
    # the sums cancel, so bf16 rounding and relu-mask flips show most there
    # and only the correlation is held
    for g_out, rel in ((rng.uniform(0.5, 1.5, size=(n, 4)), 2e-2),
                       (rng.normal(size=(n, 4)), None)):
        g_out = torch.as_tensor(g_out.astype(np.float32), device="cuda")
        got = fr.radiance_backward(packed, em, de, vpe, p3, g_e_ref, g_out,
                                   skip)
        torch.cuda.synchronize()
        want = fr.radiance_backward_plain(packed, em, de, vpe, p3, g_e_ref,
                                          g_out, skip)
        for k in fr.PACK_ORDER:
            a, b = got[k], want[k]
            assert a.shape == b.shape, k
            assert torch.isfinite(a).all(), k
            scale = b.abs().max().item() + 1e-12
            if rel is not None:
                assert (a - b).abs().max().item() / scale < rel, k
            if b.numel() > 8:
                assert _corr(a, b) > 0.999, k
    assert fr.radiance_forward.launches["bfloat16"] == f0 + 1
    assert fr.radiance_backward.launches["bfloat16"] == b0 + 2


def _kink_free(fr, packed, em, de, vpe, p3, g_e, skip, margin=1e-4):
    """The points whose appearance pre-activations all clear the relu kink
    by `margin` in the plain f32 forward."""
    r, cast = fr._ops(packed, "float32")
    c = fr._forward_core(r, cast, em, de, vpe, p3, skip, g_e=g_e)
    clear = torch.stack([z.abs().amin(1) for z in c["za"]], 1).amin(1)
    return torch.nonzero(clear > margin).flatten()


# N below one 64-point tile, not a multiple of it, above slots x tile (132
# SMs x 64 points), and above one backward chunk (65,536 points)
@pytest.mark.parametrize("width,layers,n", [
    (256, 8, 40), (256, 8, 1000), (256, 8, 9000), (256, 8, 70000),
    (128, 4, 40), (128, 4, 200), (128, 4, 9000)])
def test_fused_radiance_f32_kernels_match_plain(width, layers, n):
    """The f32-operand form (3xTF32) against the plain f32 version at the
    JAX kernel tests' bars: rgb and alpha within 1e-5, each gradient leaf
    within 2e-4 of its max, under both upstream gradients (past 1000
    points as the comment below sets out)."""
    _need_gpu()
    from psnerf_torch.ops import fused_radiance as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, field = _occ_field(width, layers, compute="float32")
    em, de, vpe, p3 = _radiance_inputs(cfg, n)
    skip = cfg.skips[0] - 1
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.float32)
    before = dict(fr.radiance_forward.launches)
    k_before = dict(fr.f32_launches)
    out, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip, "float32")
    torch.cuda.synchronize()
    assert fr.radiance_forward.launches == dict(
        before, float32=before["float32"] + 1)
    ref, g_e_ref = fr.radiance_forward_plain(packed, em, de, vpe, p3, skip,
                                             "float32")
    finish = lambda o: torch.cat([torch.tanh(o[:, :3]) * 0.5 + 0.5,
                                  torch.sigmoid(-10.0 * o[:, 3:])], 1)
    torch.testing.assert_close(finish(out), finish(ref), rtol=1e-5,
                               atol=1e-5)
    assert (g_e - g_e_ref).abs().max() < 2e-4 * g_e_ref.abs().max()
    # an appearance pre-activation within ~1e-6 of the relu kink flips its
    # mask under any f32 rounding; past 1000 points such points occur, and
    # a leaf whose other factor changes sign over the points (wp above all)
    # then cancels even under U(0.5, 1.5), so that plain f32 itself lies
    # more than 2e-4 of the leaf's max from an f64 run. So past 1000 points
    # the 2e-4 bar against plain f32 holds on the points that clear the
    # kink by 1e-4, and every point under U(0.5, 1.5) is held against f64:
    # within 2e-4, or within twice plain f32's own distance
    keep = _kink_free(fr, packed, em, de, vpe, p3, g_e_ref, skip)
    every = torch.arange(n, device="cuda")
    p64 = {k: v.double() for k, v in packed.items()}
    rng = np.random.default_rng(3)
    runs = chunks = 0
    for i, g_out in enumerate((rng.uniform(0.5, 1.5, size=(n, 4)),
                               rng.normal(size=(n, 4)))):
        g_out = torch.as_tensor(g_out.astype(np.float32), device="cuda")
        sets = [keep, every] if n <= 1000 else [keep] + [every] * (i == 0)
        for rows in sets:
            runs += 1
            chunks += -(-rows.numel() // fr.CHUNK)
            sub = lambda x: x[rows].contiguous()
            args = (sub(em), sub(de), sub(vpe), sub(p3), sub(g_e_ref),
                    sub(g_out))
            got = fr.radiance_backward(packed, *args, skip, "float32")
            torch.cuda.synchronize()
            want = fr.radiance_backward_plain(packed, *args, skip, "float32")
            exact = None
            if n > 1000 and rows is every:
                exact = fr.radiance_backward_plain(
                    p64, *[x.double() for x in args], skip, "float32")
            for k in fr.PACK_ORDER:
                assert got[k].shape == want[k].shape, k
                if exact is None:
                    scale = want[k].abs().max().item() + 1e-12
                    assert (got[k] - want[k]).abs().max().item() / scale \
                        < 2e-4, k
                    continue
                scale = exact[k].abs().max().item() + 1e-30
                dist = lambda x: (x.double() - exact[k]).abs().max().item() \
                    / scale
                assert dist(got[k]) < max(2e-4, 2 * dist(want[k])), k
    grew = {k: fr.f32_launches[k] - k_before[k] for k in fr.F32_KERNELS}
    assert grew == {"split": 1 + runs, "fwd": 1, "sweep": chunks,
                    "wgrad": chunks, "reduce": runs}


def test_fused_radiance_f32_backward_is_deterministic():
    """The f32 backward sums in fixed order: two launches agree bit for
    bit."""
    _need_gpu()
    from psnerf_torch.ops import fused_radiance as fr

    cfg, field = _occ_field(256, 8, compute="float32")
    n = 20000
    em, de, vpe, p3 = _radiance_inputs(cfg, n)
    skip = cfg.skips[0] - 1
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.float32)
    _, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip, "float32")
    g_out = torch.as_tensor(np.random.default_rng(4).normal(
        size=(n, 4)).astype(np.float32), device="cuda")
    a, b = (fr.radiance_backward(packed, em, de, vpe, p3, g_e, g_out, skip,
                                 "float32") for _ in range(2))
    torch.cuda.synchronize()
    for k in fr.PACK_ORDER:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("width,layers", [(256, 8), (128, 4)])
def test_fused_radiance_f32_split_and_sweep(width, layers):
    """The prologue's split weights equal split_weights_plain's bit for bit
    (hi + lo within 2^-22 of each weight), and the sweep's workspace holds
    radiance_sweep_plain's operands (each array within 2e-4 of its max)."""
    _need_gpu()
    from psnerf_torch.ops import fused_radiance as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, field = _occ_field(width, layers, compute="float32")
    n = 1000
    em, de, vpe, p3 = _radiance_inputs(cfg, n)
    skip = cfg.skips[0] - 1
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.float32)
    words = fr.split_weights(packed, skip)
    torch.cuda.synchronize()
    want = fr.split_weights_plain(packed)
    assert words.shape == want.shape
    assert torch.equal(words, want)
    f = words.view(torch.float32)
    off = 0
    for b in fr._split_mats(packed):
        k, m = b.shape
        # k-step slabs: [ks, part (hi, lo), m // 8, c, m % 8, kk]
        blk = f[off:off + k * m // 2].reshape(k // 8, 2, m // 8, 2, 8, 4)
        off += k * m // 2
        hi, lo = (blk[:, q].permute(0, 2, 4, 1, 3).reshape(k, m)
                  for q in (0, 1))
        assert ((hi + lo - b).abs() <= 2.0 ** -22 * b.abs()).all()

    _, g_e = fr.radiance_forward_plain(packed, em, de, vpe, p3, skip,
                                       "float32")
    g_out = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 1.5, size=(n, 4)).astype(np.float32), device="cuda")
    bwd = fr.F32Backward(packed, em, de, vpe, p3, g_e, g_out, skip)
    bwd.split()
    bwd.sweep(0)
    torch.cuda.synchronize()
    got = bwd.workspace(0)
    plain = fr.radiance_sweep_plain(packed, em, de, vpe, p3, g_e, g_out,
                                    skip, "float32")
    for k, x in plain.items():
        scale = x.abs().max().item() + 1e-12
        assert (got[k] - x).abs().max().item() / scale < 2e-4, k


# N of one point, below one 64-point tile, above one CTA per SM, and the
# integration batch of a 96-sample step (2048 x 96)
@pytest.mark.parametrize("width,layers", [(256, 8), (128, 4)])
@pytest.mark.parametrize("n", [1, 63, 70001, 196608])
def test_fused_radiance_bf16_backward_is_deterministic(width, layers, n):
    """The bf16 backward writes its split-K and column-sum slots without
    atomics and sums them in a fixed order: five launches agree bit for
    bit."""
    _need_gpu()
    from psnerf_torch.ops import fused_radiance as fr

    cfg, field = _occ_field(width, layers)
    em, de, vpe, p3 = _radiance_inputs(cfg, n)
    skip = cfg.skips[0] - 1
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.bfloat16)
    _, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip)
    g_out = torch.as_tensor(np.random.default_rng(6).normal(
        size=(n, 4)).astype(np.float32), device="cuda")
    before = fr.slot_sum.launches
    runs = [fr.radiance_backward(packed, em, de, vpe, p3, g_e, g_out, skip)
            for _ in range(5)]
    torch.cuda.synchronize()
    assert fr.slot_sum.launches == before + 5
    for k in fr.PACK_ORDER:
        assert torch.isfinite(runs[0][k]).all(), k
        assert all(torch.equal(runs[0][k], r[k]) for r in runs[1:]), k


# ragged N: below one 128-point CTA tile, not a multiple of it, above one
# backward chunk (65,536 points)
_BF16_STAGES = [(256, 8, 1000), (256, 8, 70001), (128, 4, 200),
                (128, 4, 9000)]


def _bf16_backward(width, layers, n):
    from psnerf_torch.ops import fused_radiance as fr

    cfg, field = _occ_field(width, layers)
    em, de, vpe, p3 = _radiance_inputs(cfg, n)
    skip = cfg.skips[0] - 1
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.bfloat16)
    _, g_e = fr.radiance_forward_plain(packed, em, de, vpe, p3, skip)
    g_out = torch.as_tensor(np.random.default_rng(8).uniform(
        0.5, 1.5, size=(n, 4)).astype(np.float32), device="cuda")
    b = fr.Bf16Backward(packed, em, de, vpe, p3, g_e, g_out, skip)
    return fr, b, packed, (em, de, vpe, p3, g_e, g_out), skip


@pytest.mark.parametrize("width,layers,n", _BF16_STAGES)
def test_fused_radiance_bf16_sweep_matches_plain(width, layers, n):
    """The bf16 sweep kernel's workspace against radiance_sweep_plain at
    bf16, chunk by chunk: each array's mean error under 1e-2 of its mean
    and correlation above 0.999 (a relu mask that a bf16 rounding flips
    moves single elements by their size), zero past the chunk's points;
    its column-sum slots, summed, against the plain version's f32 column
    sums (the bias-like leaves, wp, wn, w8l): each leaf's mean error under
    1e-2 of its mean and correlation above 0.999 (the flipped masks again:
    at 1,000 points one flip moves wp by ~2% of its max)."""
    _need_gpu()
    fr, b, packed, (em, de, vpe, p3, g_e, g_out), skip = _bf16_backward(
        width, layers, n)
    leaves, p_floats, _ = fr.bf16_slot_layout(*b.dims)
    sums = [k for k in fr.PACK_ORDER if leaves[k] >= p_floats]
    shapes = fr._GRAD_SHAPES(*b.dims)
    before = fr.bf16_launches["sweep"]
    want_sums = None
    for c in range(b.n_chunks):
        b.sweep(c)
        torch.cuda.synchronize()
        r0, nc = b._chunk(c)
        r = slice(r0, r0 + nc)
        want = fr.radiance_sweep_plain(packed, em[r], de[r], vpe[r], p3[r],
                                       g_e[r], g_out[r], skip)
        got = b.workspace(c)
        for k, x in got.items():
            y = want[k].to(torch.bfloat16).float()
            assert torch.isfinite(x).all(), k
            assert (x - y).abs().mean() <= 1e-2 * y.abs().mean(), k
            if y.numel() > 1 and y.std() > 0:
                assert _corr(x, y) > 0.999, k
        lay, rows = fr.ws_layout(*b.dims, "bfloat16")
        flat = b.ws.float()
        # the last CTA tile's points past the chunk (what wgrad reads)
        pad = torch.arange(nc, fr.round_up(nc, fr.BF16_TILE), device="cuda")
        tail = fr.ws_index(torch.arange(rows, device="cuda")[:, None],
                           pad[None], b.ld)
        assert (flat[tail] == 0).all()
        d = fr.weight_grads_plain(want, skip)
        want_sums = d if want_sums is None else {
            k: want_sums[k] + d[k] for k in d}
    assert fr.bf16_launches["sweep"] == before + b.n_chunks
    cs = fr.slot_sum_plain(b.colsums)
    for k in sums:
        o = leaves[k] - p_floats
        got = cs[o:o + want_sums[k].numel()].view(shapes[k])
        want_k = want_sums[k]
        assert (got - want_k).abs().mean() <= 1e-2 * want_k.abs().mean(), k
        if want_k.numel() > 8:
            assert _corr(got, want_k) > 0.999, k


@pytest.mark.parametrize("width,layers,n", _BF16_STAGES)
def test_fused_radiance_bf16_wgrad_matches_plain(width, layers, n):
    """The bf16 split-K weight-gradient kernel against weight_grads_plain
    on the kernel's own workspace, summed over the chunks: the products'
    leaves within 1e-4 of their max (the same bf16 operands, f32 sums in
    another order); the last chunk's splits fold the column-sum slots,
    each its share in order, into their column-sum regions; the slots
    summed bit for bit as slot_sum_plain sums them."""
    _need_gpu()
    fr, b, packed, (em, de, vpe, p3, g_e, g_out), skip = _bf16_backward(
        width, layers, n)
    leaves, p_floats, _ = fr.bf16_slot_layout(*b.dims)
    prods = [k for k in fr.PACK_ORDER if leaves[k] < p_floats]
    want = None
    before = fr.bf16_launches["wgrad"]
    for c in range(b.n_chunks):
        b.sweep(c)
        b.wgrad(c)
        torch.cuda.synchronize()
        r0, nc = b._chunk(c)
        r = slice(r0, r0 + nc)
        ws = b.workspace(c)
        plain = fr.radiance_sweep_plain(packed, em[r], de[r], vpe[r], p3[r],
                                        g_e[r], g_out[r], skip)
        ws.update({k: plain[k] for k in ("p3", "n3", "w8lt")})
        d = fr.weight_grads_plain(ws, skip)
        want = d if want is None else {k: want[k] + d[k] for k in d}
    assert fr.bf16_launches["wgrad"] == before + b.n_chunks
    cs = b.colsums
    S = b.splits
    fold = torch.stack([fr.slot_sum_plain(cs[len(cs) * s // S:
                                             len(cs) * (s + 1) // S])
                        for s in range(S)])
    last = b.partial[(b.n_chunks - 1) * S:, p_floats:]
    assert torch.equal(last, fold)
    assert (b.partial[:(b.n_chunks - 1) * S, p_floats:] == 0).all()
    grads = b.reduce()
    torch.cuda.synchronize()
    assert torch.equal(b.sum, fr.slot_sum_plain(b.partial))
    for k in prods:
        scale = want[k].abs().max().item() + 1e-12
        assert torch.isfinite(grads[k]).all(), k
        assert (grads[k] - want[k]).abs().max().item() / scale < 1e-4, k


# slot counts of one, a few, the f32 reduce's 27 (3 chunks x 9 splits at
# 196,608 points), one per SM of an H100 and one more; totals of the bf16
# backward's slot at widths 256 and 128, and float4 counts that 256-thread
# CTAs do not divide evenly: fewer than one CTA's (3), a few CTAs' (1,001),
# and more than one resident wave holds (400,009 > 270,336 on an H100, so
# threads take a second column)
@pytest.mark.parametrize("total", [825092, 149892, 12, 4 * 1001,
                                   4 * 400009])
@pytest.mark.parametrize("slots", [1, 8, 27, 132, 133])
def test_slot_sum_kernel_matches_plain(slots, total):
    """The slot reduction engine adds the slots in order from zero, as the
    plain version does: the same bits. A slot length that is not a
    multiple of 4 floats is refused (16-byte loads)."""
    _need_gpu()
    from psnerf_torch.ops import fused_radiance as fr

    x = torch.as_tensor(np.random.default_rng(7).normal(
        size=(slots, total)).astype(np.float32), device="cuda")
    before = fr.slot_sum.launches
    got = fr.slot_sum(x)
    torch.cuda.synchronize()
    assert fr.slot_sum.launches == before + 1
    assert torch.equal(got, fr.slot_sum_plain(x))
    with pytest.raises(ValueError, match="multiple of 4"):
        fr.slot_sum(x[:, :-1].contiguous())


@pytest.mark.parametrize("width,layers,n", [(256, 8, 70000), (128, 4, 9000)])
def test_f32_reduce_matches_plain(width, layers, n):
    """The f32 backward's reduce adds its split-K slots in order from zero,
    as the slots summed one by one do: the same bits; each gradient is its
    own contiguous view of that sum."""
    _need_gpu()
    from psnerf_torch.ops import fused_radiance as fr

    cfg, field = _occ_field(width, layers, compute="float32")
    em, de, vpe, p3 = _radiance_inputs(cfg, n)
    skip = cfg.skips[0] - 1
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.float32)
    _, g_e = fr.radiance_forward(packed, em, de, vpe, p3, skip, "float32")
    g_out = torch.as_tensor(np.random.default_rng(9).normal(
        size=(n, 4)).astype(np.float32), device="cuda")
    b = fr.F32Backward(packed, em, de, vpe, p3, g_e, g_out, skip)
    b.split()
    for c in range(b.n_chunks):
        b.sweep(c)
        b.wgrad(c)
    before = fr.f32_launches["reduce"]
    grads = b.reduce()
    torch.cuda.synchronize()
    assert fr.f32_launches["reduce"] == before + 1
    assert torch.equal(b.sum, fr.slot_sum_plain(b.partial))
    leaves, total = fr.f32_slot_layout(*b.dims)
    for k, x in grads.items():
        o = leaves[k]
        assert x.is_contiguous(), k
        assert torch.equal(x.flatten(), b.sum[o:o + x.numel()]), k


def _stage2_batch(n, n_l, n_v, n_rows, seed=8):
    """A stage-2 training batch of random pixels of a camera at 3 looking
    at the origin (host tensors)."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -3.0)
    k = np.asarray([[400.0, 0, 256, 0], [0, 400.0, 256, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float32)
    mask = rng.uniform(size=n) > 0.1
    return {
        "uv": f(rng.uniform(0, 512, size=(n, 2))), "pose": f(pose),
        "intrinsics": f(k), "object_mask": torch.as_tensor(mask),
        "points": f(rng.normal(size=(n, 3)) * 0.3),
        "normal": f(_unit(rng, (n, 3))),
        "surface_mask": torch.as_tensor(mask | (rng.uniform(size=n) > 0.5)),
        "rgb_gt": f(rng.uniform(size=(n_l, n, 3))),
        "l_slt": torch.as_tensor(rng.choice(n_rows, n_l, replace=False)),
        "visibility": f(rng.uniform(size=(n_l, n)) > 0.3),
        "light_vis_train": f(_unit(rng, (n_v, 3))),
        "vis_train_gt": f(rng.uniform(size=(n_v, n)) > 0.3)}


def _stage2_step_on(model, dirs, batch, noise, dev, dt, it=6000):
    """(loss, gradients, params after the step) of one stage-2 step of
    `model` on device dev in dtype dt, from a fresh optimizer state."""
    import copy

    from psnerf_torch.train import stage2

    cfg, tcfg = model.cfg, stage2.Stage2TrainConfig()
    params = stage2.init_stage2_params(copy.deepcopy(model).to(dev, dt),
                                       dirs, np.full((len(dirs), 1), 2.0),
                                       dev)
    for k in ("light_dirs", "light_ints"):
        params[k] = params[k].to(dt)
    cast = lambda v: v.to(dev, dt) if v.is_floating_point() else v.to(dev)
    b = {k: cast(v) for k, v in batch.items()}
    nz = {k: cast(v) for k, v in noise.items()}
    init, step = stage2.make_stage2_train_step(cfg, tcfg)
    _, grads = step.loss_and_grads(params, b, it, nz)
    terms = step(params, init(params), b, it, nz)
    flat = {k: v.detach().cpu() for k, v in
            stage2.model_params(params["model"]).items()}
    flat.update({k: params[k].cpu() for k in ("light_dirs", "light_ints")})
    return (float(terms["loss"]), {k: g.cpu() for k, g in grads.items()},
            flat)


def test_stage2_train_step_cuda_matches_cpu():
    """One stage-2 step of the full bear PSNet (8,192 pixels x 10 lights, 8
    vis_plus lights) on the card against the same step on the CPU, from one
    parameter set, batch and jitter draws, after the warm-up.
    In f32, the precision the runner trains in: the loss within 1e-4
    relative; each param within 2 lr of its group (Adam's first step moves
    a param by lr, so a near-zero gradient whose sign differs costs 2 lr)
    and within 1e-5 where its gradient exceeds 1e-6; each gradient leaf
    within 1e-3 of its scale: the f32 sin and cos of the positional
    encoding differ by an ulp between the card's and the CPU's math
    libraries, which the encoding's high frequencies amplify to up to
    1.7e-4 of a leaf's scale (9e-6 with the encoding in f64 on both;
    tools/stage2_grad_precision.py).
    In f64, which holds the card's backward itself: the loss within 1e-12
    relative, each gradient leaf within 1e-9 of its scale, each param
    within 1e-10 where its gradient exceeds 1e-6."""
    _need_gpu()
    from psnerf_torch.fields.psnet import PSNetConfig, init_psnet
    from psnerf_torch.render.shading import draw_psnet_noise
    from psnerf_torch.train import stage2

    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = stage2.Stage2TrainConfig()
    model = init_psnet(PSNetConfig(),
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():      # a visibility above 0: the rgb loss flows
        model["visibility"][-1].b.add_(0.5)
    dirs = _unit(np.random.default_rng(9), (40, 3))
    batch = _stage2_batch(8192, 10, 8, 40)
    noise = draw_psnet_noise(8192, torch.Generator().manual_seed(1))
    lrs = {"light_dirs": tcfg.light_learning_rate,
           "light_ints": tcfg.light_inten_lr}
    for dt, loss_rel, grad_rel, p_abs in ((torch.float32, 1e-4, 1e-3, 1e-5),
                                          (torch.float64, 1e-12, 1e-9,
                                           1e-10)):
        loss_c, g_c, p_c = _stage2_step_on(model, dirs, batch, noise, "cpu",
                                           dt)
        loss_g, g_g, p_g = _stage2_step_on(model, dirs, batch, noise, "cuda",
                                           dt)
        assert abs(loss_c - loss_g) <= loss_rel * abs(loss_c), dt
        assert set(g_c) == set(p_c) == set(g_g)
        for k, v in p_c.items():
            scale = g_c[k].abs().max().item() + 1e-8
            assert (g_g[k] - g_c[k]).abs().max().item() <= grad_rel * scale, \
                (dt, k)
            diff = (v - p_g[k]).abs()
            big = g_c[k].abs() > 1e-6
            assert (diff[big].max().item() if big.any() else 0.0) <= p_abs, \
                (dt, k)
            lr = lrs.get(k, tcfg.sg_learning_rate)
            assert diff.max().item() <= 2 * lr * (1 + 1e-4), (dt, k)


def _cudnn_tf32_default():
    """PyTorch's default cuDNN TF32 setting (on) for a test; the SDPS and
    LPIPS convolutions must switch it off themselves."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    return old


@pytest.mark.parametrize("n_lights", [8, 96])
def test_sdps_nets_cuda_match_cpu(n_lights):
    """LCNet (128x128) and NENet (a 96x120 crop) of one seeded parameter
    set on the card against the CPU, cuDNN's TF32 left at PyTorch's default:
    LCNet's logits within 1e-4 of each head's max |logit|, its classes
    equal where the top two logits differ by more than 1e-3 of that max;
    NENet's normals within 1e-4 abs."""
    _need_gpu()
    import copy

    from psnerf_torch.preprocess import sdps

    old = _cudnn_tf32_default()
    try:
        gen = torch.Generator().manual_seed(0)
        nets = {"cpu": (sdps.LCNet(generator=gen, device="cpu"),
                        sdps.NENet(generator=gen, device="cpu"))}
        nets["cuda"] = tuple(copy.deepcopy(n).cuda() for n in nets["cpu"])
        rng = np.random.default_rng(n_lights)
        imgs = rng.uniform(size=(n_lights, 3, 128, 128)).astype(np.float32)
        mask = (rng.uniform(size=(1, 128, 128)) > 0.2).astype(np.float32)
        crop = rng.uniform(size=(n_lights, 3, 96, 120)).astype(np.float32)
        out = {}
        with torch.no_grad():
            pred = nets["cpu"][0](torch.as_tensor(imgs), torch.as_tensor(mask))
            for dev, (lc, ne) in nets.items():
                t = lambda a: torch.as_tensor(a, device=dev)
                logits = lc.logits(t(imgs), t(mask))
                # NENet on both devices from the CPU's light estimates
                normals = ne(t(crop), pred["dirs"].to(dev),
                             pred["intens"].to(dev))
                out[dev] = ({k: v.cpu() for k, v in logits.items()},
                            normals.cpu())
        (lc_c, n_c), (lc_g, n_g) = out["cpu"], out["cuda"]
        for k in lc_c:
            scale = lc_c[k].abs().max().item()
            assert (lc_g[k] - lc_c[k]).abs().max().item() <= 1e-4 * scale, k
            top2 = lc_c[k].topk(2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > 1e-3 * scale
            assert clear.any()
            assert torch.equal(lc_g[k].argmax(1)[clear],
                               lc_c[k].argmax(1)[clear]), k
        assert (n_g - n_c).abs().max().item() <= 1e-4
    finally:
        torch.backends.cudnn.allow_tf32 = old


def test_lpips_cuda_matches_cpu():
    """LPIPS of a 512x512 pair on the card against the CPU, from random
    AlexNet+LPIPS weights, cuDNN's TF32 left at PyTorch's default: within
    1e-5 relative; 0 for a pair of the same image."""
    _need_gpu()
    from psnerf_torch.eval import lpips_torch

    old = _cudnn_tf32_default()
    try:
        rng = np.random.default_rng(3)
        params, cin = {}, 3
        for i, (k, cout) in enumerate(zip([11, 5, 3, 3, 3],
                                          lpips_torch._TAP_CHANNELS)):
            params[f"conv{i}_w"] = torch.as_tensor(rng.normal(
                0, 0.05, (cout, cin, k, k)).astype(np.float32))
            params[f"conv{i}_b"] = torch.as_tensor(rng.normal(
                0, 0.01, cout).astype(np.float32))
            params[f"lin{i}_w"] = torch.as_tensor(rng.random(
                (1, cout, 1, 1)).astype(np.float32))
            cin = cout
        a = rng.uniform(size=(512, 512, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        got = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.to(dev) for k, v in params.items()}
            t = lambda x: torch.as_tensor(x, device=dev)
            with torch.no_grad():
                got[dev] = float(lpips_torch.lpips_distance(p, t(a), t(b)))
                if dev == "cuda":
                    assert float(lpips_torch.lpips_distance(p, t(a),
                                                            t(a))) == 0.0
        assert got["cpu"] > 0
        assert abs(got["cuda"] - got["cpu"]) <= 1e-5 * got["cpu"], got
    finally:
        torch.backends.cudnn.allow_tf32 = old


def test_stage1_runner_on_two_gloo_ranks_matches_one_process(tmp_path):
    """Stage1Runner(mesh=...) on two gloo ranks sharing cuda:0 (NCCL
    refuses two ranks on one device), the kernels K1 and K2/K3 on each
    rank's block: 5 steps at the default (f32-operand) field and 2 at the
    bf16 field on a 24x24 scene, against one process's runner on the
    card. The first step's loss within 1e-4 relative and every leaf's
    all-reduced gradient within 1e-4 of its max (2e-2 at the bf16 field,
    whose plain autograd rounds each rank's partial weight gradients to
    bf16); the params after the run within Adam's flip bound, 2 lr a step
    (a near-zero gradient whose rounding differs between the two
    summation orders moves its param by up to 2 lr the other way: the
    rule of the stage-2 card-against-CPU test above)."""
    _need_gpu()
    import dataclasses

    from psnerf_torch.config import Stage1Config
    from psnerf_torch.data.synthetic import generate_synthetic_scene
    from psnerf_torch.fields.occupancy import OccFieldConfig
    from psnerf_torch.parallel.launch import launch
    from psnerf_torch.render.unisurf import UnisurfConfig
    from psnerf_torch.runners.stage1 import Stage1Runner
    from psnerf_torch.train.stage1 import Stage1TrainConfig, field_params
    from torch_dist_workers import first_step_stage1, run_jobs

    scene = str(tmp_path / "scene")
    generate_synthetic_scene(scene, n_views=2, n_test=0, n_lights=3,
                             hw=(24, 24))
    cfg = Stage1Config(
        field=OccFieldConfig(),
        render=UnisurfConfig(near=1.2, far=5.0, radius=1.2,
                             interval_start=0.6, interval_end=0.05,
                             ray_marching_steps=32),
        train=Stage1TrainConfig(n_training_points=256, normal_after=0,
                                milestone_iters=()),
        data_dir=scene, inten_normalize=None, checkpoint_every=10 ** 9,
        backup_every=10 ** 9, visualize_every=0)
    cfgs = {"float32": (cfg, 5, 1e-4), "bfloat16": (dataclasses.replace(
        cfg, field=OccFieldConfig(compute_dtype="bfloat16")), 2, 2e-2)}
    jobs = [(name, "stage1_runner", dict(cfg=c, workdir=str(tmp_path / name),
                                        steps=steps, first=True))
            for name, (c, steps, _) in cfgs.items()]
    ranks = launch(run_jobs, 2, jobs, device="cuda:0", timeout=600)
    for name, (c, steps, grad_rel) in cfgs.items():
        r = Stage1Runner(c, str(tmp_path / f"single_{name}"), resume=False)
        assert r.use_fused_occ and r.use_fused_radiance
        first = first_step_stage1(r)
        r.train(steps, log_every=1000)
        lr = c.train.learning_rate
        for rank in ranks:
            got = rank[name]
            assert abs(got["first"]["loss"] - first["loss"]) <= \
                1e-4 * abs(first["loss"]), name
            for k, g in first["grads"].items():
                scale = np.abs(g).max() + 1e-12
                assert np.abs(got["first"]["grads"][k] - g).max() <= \
                    grad_rel * scale, (name, k)
            for k, v in field_params(r.field).items():
                d = np.abs(got["params"][k] - v.detach().cpu().numpy())
                assert d.max() <= 2 * lr * steps * (1 + 1e-3), (name, k)


def test_a_kernel_launched_in_a_span_starts_after_the_span_on_the_device():
    """The spans' clock (time.time_ns()) is the one torch.profiler reports
    device events in: a kernel launched inside a span starts on the card
    after the span's start, and the span's record_function event lies
    inside the span."""
    _need_gpu()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from psnerf_torch.utils import profiling

    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        with profiling.span("gpu.matmul") as sp:
            y = x @ x
        torch.cuda.synchronize()
    assert y.shape == x.shape
    kernels, annotation = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            kernels.append(e.start_ns())
        elif e.name() == "gpu.matmul" and e.device_type() == DeviceType.CPU:
            annotation.append((e.start_ns(),
                               e.start_ns() + e.duration_ns()))
    assert kernels and all(k >= sp.start_ns for k in kernels)
    (a0, a1), = annotation
    assert sp.start_ns <= a0 <= a1 <= sp.end_ns


RENDER_VIEW_OUTPUTS = ("rgb", "rgb_sum", "albedo", "rough", "sg_weight",
                       "visibility", "normal_pred")


@pytest.fixture(scope="module")
def card_stage2(tmp_path_factory):
    """A Stage2Runner on the card over a 32x32 synthetic scene (81% of
    each view on the surface) with small PSNet widths; the visibility
    trunk is 64 wide, the kernels' narrowest."""
    _need_gpu()
    import os

    from psnerf_torch.config import Stage2Config
    from psnerf_torch.data.synthetic import (generate_synthetic_scene,
                                             write_stage1_exports)
    from psnerf_torch.fields.psnet import PSNetConfig
    from psnerf_torch.runners.stage2 import Stage2Runner
    from psnerf_torch.train.stage2 import Stage2TrainConfig

    d = str(tmp_path_factory.mktemp("s2_scene"))
    generate_synthetic_scene(d, n_views=3, n_test=1, n_lights=6,
                             hw=(32, 32), ragged_lights=True)
    write_stage1_exports(d, os.path.join(d, "exports"), n_vis_plus=6)
    cfg = Stage2Config(
        net=PSNetConfig(mlp_width=32, sg_mlp_width=16, normal_mlp_width=32,
                        vis_mlp_width=64, vis_mlp_depth=4, vis_mlp_skip_at=2,
                        n_freqs_xyz=4, normal_n_freqs_xyz=4, light_int=1.2),
        train=Stage2TrainConfig(warmup_iters=10), data_dir=d,
        stage1_shape_path=os.path.join(d, "exports"), inten_normalize=None,
        light_bs=4, vis_train_num=4, num_pixels=256, train_all_pixels=False)
    return Stage2Runner(cfg, str(tmp_path_factory.mktemp("s2_wd")),
                        resume=False, device="cuda")


@pytest.mark.parametrize("compact", [True, False])
def test_render_view_assembles_on_the_card_into_pinned_host_memory(
        card_stage2, monkeypatch, tmp_path, compact):
    """Every output kind, compact and full: the arrays equal a numpy
    assembly of the same frame's outputs bit for bit, view page-locked
    host tensors, and a kept result survives two later renders of another
    view of the same shapes unchanged; those views' read-backs all count
    as pinned bytes."""
    from frame_assembly import capture_frames, host_assembly
    from psnerf_torch.utils import profiling

    r = card_stage2
    data = r._eval_data("train")
    lights = r.trained_lights_for_view(data, 0)
    kw = dict(tile=256, outputs=RENDER_VIEW_OUTPUTS, compact=compact)
    frames = capture_frames(monkeypatch)
    got = r.render_view(data, 0, *lights, **kw)
    h, w = data["img_res"]
    want = host_assembly(
        frames[0], data["surface_mask"][0].cpu().numpy().reshape(h, w) > 0,
        len(lights[0]), data["normals"][0].cpu().numpy(), compact)
    assert set(got) == set(want) == set(RENDER_VIEW_OUTPUTS) | {
        "mask", "normal_values"}
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
        if k != "mask":
            base = got[k]
            while isinstance(base, np.ndarray):
                base = base.base
            assert isinstance(base, torch.Tensor) and base.is_pinned(), k
    before = {k: a.copy() for k, a in got.items()}
    with profiling.trace(str(tmp_path)):
        for _ in range(2):
            later = r.render_view(data, 1, *lights, **kw)
    for k, a in before.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    pinned = sum(a.nbytes for k, a in later.items() if k != "mask")
    counted = profiling.counters()
    assert counted["d2h_pinned_bytes"] == 2 * pinned
    assert counted["d2h_bytes"] == 2 * (pinned + later["mask"].nbytes)


# ------------------------------------------------- multi-tensor Adam (adam.cu)

def _adam_copies(params: dict, steps: dict | None = None):
    """Two copies of params on the card with their fresh optimizer states
    (the step counters preset from `steps`): the fused route's and the plain
    loop's."""
    from psnerf_torch.train.optim import adam_init

    out = []
    for _ in range(2):
        p = {k: v.detach().to("cuda", torch.float32).clone()
             for k, v in params.items()}
        s = adam_init(p)
        for k, n in (steps or {}).items():
            s["step"][k].fill_(n)
        out.append((p, s))
    return out


def _adam_grads(params: dict, seed: int) -> dict:
    """Gradients of each leaf's own scale (10^-6 to 10^0, and 10^-20 on
    every eleventh leaf, whose squares are subnormal), some exactly 0."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, (k, p) in enumerate(params.items()):
        scale = 1e-20 if i % 11 == 10 else 10.0 ** -(i % 7)
        g = torch.randn(p.shape, generator=gen) * scale
        g[torch.rand(p.shape, generator=gen) < 0.05] = 0.0
        out[k] = g.to("cuda")
    return out


def _adam_bits(p: dict, s: dict) -> dict:
    out = {f"p/{k}": v.detach().clone() for k, v in p.items()}
    for part in ("m", "v", "step"):
        out.update({f"{part}/{k}": v.clone() for k, v in s[part].items()})
    return out


def _assert_adam_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        bad = (a[k] != b[k]).sum().item()
        assert bad == 0, (k, bad, (a[k] - b[k]).abs().max().item())


def _adam_kernels(fn) -> list:
    """The names of the device kernels fn() launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def _adam_case(name):
    """(params, [per step: [(lr, {leaf: gate} or None, leaves)]], preset
    steps) of a case: each step is adam_update calls as the train steps
    make them."""
    from psnerf_torch.fields.occupancy import (OccFieldConfig,
                                               init_occupancy_field)
    from psnerf_torch.fields.psnet import PSNetConfig, init_psnet
    from psnerf_torch.train.optim import row_mask_from_indices
    from psnerf_torch.train.stage1 import field_params
    from psnerf_torch.train.stage2 import model_params

    gen = torch.Generator().manual_seed(0)
    if name == "stage1":
        params = field_params(init_occupancy_field(OccFieldConfig(),
                                                   generator=gen))
        assert len(params) == 42
        return params, [[(5e-4, None, list(params))]] * 3, {}
    if name == "psnet":
        params = dict(model_params(init_psnet(PSNetConfig(), generator=gen)))
        names = list(params)
        params["light_dirs"] = torch.randn(40, 3, generator=gen)
        params["light_ints"] = torch.rand(40, 1, generator=gen) + 1.5
        rows = lambda idx: row_mask_from_indices(40, torch.tensor(
            idx, dtype=torch.long)).to("cuda")
        plan = []
        for live, idx_d, idx_i in ((0.0, [1, 5, 9], []), (1.0, [], [2, 3]),
                                   (1.0, [0, 5, 39], [7])):
            gate = {k: (live if k.split("/")[0] in ("albedo", "rough")
                        else 0.0 if k.startswith("normal/") else 1.0)
                    for k in names}
            plan.append([(5e-4, gate, names),
                         (5e-3, {"light_dirs": rows(idx_d)}, ["light_dirs"]),
                         (1e-3, {"light_ints": rows(idx_i)}, ["light_ints"])])
        return params, plan, {}
    if name == "small":
        shapes = [(1,), (3,), (9,), (5,), (7, 3), (1023,), (1025,), (4097,),
                  (33, 31)]
        params = {f"s/{i}": torch.randn(s, generator=gen)
                  for i, s in enumerate(shapes)}
        return params, [[(1e-2, None, list(params))]] * 3, {
            "s/1": 12345, "s/5": 99999, "s/7": 4321, "s/8": 1000}
    # past one table: 48, 48, 4 leaves a call; every 25th leaf of 2^20 + 3
    # values, 1,025 CTAs that must all take one step
    assert name == "many"
    params = {f"l/{i}": torch.randn((1 << 20) + 3 if i % 25 == 0
                                    else 1 + 37 * (i % 5), generator=gen)
              for i in range(100)}
    return params, [[(1e-3, None, list(params))]] * 3, {}


@pytest.mark.parametrize("case", ["stage1", "psnet", "small", "many"])
def test_fused_adam_matches_plain_bit_for_bit(case):
    """The fused route of adam_update against adam_update_plain on the card,
    over 3 steps: p, m, v and step bit for bit, gates included (a frozen
    head, the warm-up's live gate, light-table row masks selecting some
    rows and none, so a table keeps its step 0), steps preset far from 0;
    each call makes two launches (the step bump, then the update) per 48
    leaves and no other kernel; the fused counter counts every updated
    leaf."""
    _need_gpu()
    from psnerf_torch.ops import adam
    from psnerf_torch.train.optim import adam_update, adam_update_plain
    from psnerf_torch.utils import profiling

    params, plan, steps = _adam_case(case)
    (pf, sf), (pp, sp) = _adam_copies(params, steps)
    # a first launch before any profiling: the profiler records no kernel
    # of a module that the card first loaded inside a profiled region
    (wp, ws), _ = _adam_copies({"w": torch.zeros(3)})
    adam_update(wp, wp, ws, 1e-3)
    for it, calls in enumerate(plan):
        grads = _adam_grads(params, it)
        for lr, gate, names in calls:
            sub = lambda d: {k: d[k] for k in names}
            state = lambda s: {part: sub(s[part]) for part in s}
            frozen = {k for k in names if gate is not None
                      and isinstance(gate[k], float) and not gate[k]}
            kept = _adam_bits(sub(pf), state(sf))
            before = adam.fused_adam.launches
            profiling.count("optim.fused_leaves", 0)  # off: a new session
            kernels = _adam_kernels(lambda: adam_update(
                sub(pf), grads, state(sf), lr, gate=gate))
            counted = profiling.counters()
            tables = -(-(len(names) - len(frozen)) // adam.MAX_LEAVES)
            assert adam.fused_adam.launches - before == 2 * tables
            # demangled names, e.g. "(anonymous namespace)::adam_kernel(...)"
            short = [next((n for n in ("adam_step_kernel", "adam_kernel")
                           if n in k), k) for k in kernels]
            assert short == ["adam_step_kernel", "adam_kernel"] * tables, \
                kernels
            assert counted["optim.fused_leaves"] == len(names) - len(frozen)
            assert counted["optim.plain_leaves"] == 0
            adam_update_plain(sub(pp), grads, state(sp), lr, gate=gate)
            now = _adam_bits(sub(pf), state(sf))
            for k in frozen:
                for part in ("p", "m", "v", "step"):
                    key = f"{part}/{k}"
                    assert torch.equal(now[key], kept[key]), key
        torch.cuda.synchronize()
        _assert_adam_equal(_adam_bits(pf, sf), _adam_bits(pp, sp))
    if case == "psnet":
        assert int(sf["step"]["normal/0/w"]) == 0
        assert int(sf["step"]["albedo/0/w"]) == 2
        assert int(sf["step"]["light_dirs"]) == 2
        assert int(sf["step"]["light_ints"]) == 2


def test_fused_adam_raises_for_a_card_leaf_it_cannot_take():
    """A float32 leaf on the card that the kernel cannot take (a strided
    param) raises, and no leaf of the call moves."""
    _need_gpu()
    from psnerf_torch.train.optim import adam_init, adam_update

    params = {"a": torch.randn(5, device="cuda"),
              "b": torch.randn(4, 2, device="cuda")[:, 0]}
    state = adam_init(params)
    kept = _adam_bits(params, state)
    with pytest.raises(ValueError, match="not contiguous"):
        adam_update(params, {k: torch.ones_like(p) for k, p in params.items()},
                    state, 1e-3)
    torch.cuda.synchronize()
    _assert_adam_equal(_adam_bits(params, state), kept)
