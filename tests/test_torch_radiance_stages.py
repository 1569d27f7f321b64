"""The f32 fused_radiance kernels' stages, as their plain versions on the CPU
(hidden 128, 4 layers, skip (2,), 256 points):
  * the backward as the composition of the sweep (radiance_sweep_plain:
    every weight-gradient operand) and the weight-gradient products
    (weight_grads_plain: x^T y and column sums), whole and over chunks with
    a ragged last one, against psnerf_tpu's fused_radiance_and_alpha in
    interpret mode and against torch.autograd of the packed forward (each
    leaf within 2e-4 of its max);
  * the workspace layout the sweep's operands fill;
  * the prologue's tf32 split (split_weights_plain): cvt.rna rounding,
    hi + lo within 2^-22 of each weight, and the slab layout;
  * the wrapper's launch sequence over chunks (split, then sweep and wgrad
    per chunk with their row offsets and split-K slots, then reduce), with
    the launches replaced by a recorder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.ops.fused_radiance import fused_radiance_and_alpha as jfused
from psnerf_torch.ops import fused_radiance as fr
from torch_helpers import flatten_jax, j, port_occ_field, t, unit

torch.set_num_threads(1)
N = 256
JCFG = jocc.OccFieldConfig(num_layers=4, hidden_dim=128, feat_size=128,
                           skips=(2,))
SKIP = JCFG.skips[0] - 1


@pytest.fixture(scope="module")
def setup():
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    cfg, field = port_occ_field(jp, JCFG)
    rng = np.random.default_rng(1)
    p = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = unit(rng, (N, 3))
    w_rgb = rng.normal(size=(N, 3)).astype(np.float32)
    w_a = rng.normal(size=(N,)).astype(np.float32)
    em, de, vpe, p3 = fr.radiance_inputs(t(p), t(rd), cfg)
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.float32)
        _, g_e = fr.radiance_forward_plain(packed, em, de, vpe, p3, SKIP,
                                           "float32")
    return dict(jp=jp, cfg=cfg, field=field, p=p, rd=rd, w_rgb=w_rgb,
                w_a=w_a, ins=(em, de, vpe, p3), g_e=g_e, packed=packed)


def _assert_close(got, ref, atol):
    assert set(got) == set(ref)
    for k, a in ref.items():
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(got[k] / scale, a / scale, rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("chunk", [None, 100])
def test_composition_matches_jax_interpret(setup, chunk, monkeypatch):
    """The packed gradients of sum(rgb w_rgb) + sum(alpha w_a) by the
    sweep and weight-gradient stages (whole, or over chunks of 100
    points), chained to the field's weight-norm leaves by autograd, against
    JAX's interpret-mode gradients."""
    if chunk:
        monkeypatch.setattr(fr, "CHUNK", chunk)
    s = setup
    field, cfg = s["field"], s["cfg"]

    def loss(params):
        rgb, a = jfused(params, j(s["p"]), j(s["rd"]), JCFG, tile=128,
                        interpret=True, compute="float32")
        return jnp.sum(rgb * s["w_rgb"]) + jnp.sum(a * s["w_a"])

    ref = flatten_jax(jax.grad(loss)(s["jp"]))
    field.zero_grad()
    packed = fr.pack_radiance(field, cfg, torch.float32)
    em, de, vpe, p3 = s["ins"]
    with torch.no_grad():
        out, g_e = fr.radiance_forward_plain(packed, em, de, vpe, p3, SKIP,
                                             "float32")
    # d loss / d out, through the tanh and sigmoid heads
    rgb_lin, logit = out[:, :3], out[:, 3]
    g_rgb = t(s["w_rgb"]) * 0.5 * (1 - torch.tanh(rgb_lin) ** 2)
    sig = torch.sigmoid(-10.0 * logit)
    g_logit = t(s["w_a"]) * sig * (1 - sig) * -10.0
    g_out = torch.cat([g_rgb, g_logit[:, None]], dim=1)
    d = fr.radiance_backward_plain(packed, em, de, vpe, p3, g_e, g_out, SKIP,
                                   "float32")
    torch.autograd.backward([packed[k] for k in fr.PACK_ORDER],
                            [d[k] for k in fr.PACK_ORDER])
    got = {k.replace(".", "/"): v.grad.numpy().copy()
           for k, v in field.named_parameters()}
    _assert_close(got, ref, 2e-4)


@pytest.mark.parametrize("chunk", [None, 64, 100])
def test_composition_is_the_packed_autograd_gradient(setup, chunk,
                                                     monkeypatch):
    """radiance_backward_plain (sweep then weight gradients, whole or
    chunked) returns d sum(out * g_out) / d packed, as autograd of the
    plain forward does."""
    if chunk:
        monkeypatch.setattr(fr, "CHUNK", chunk)
    em, de, vpe, p3 = setup["ins"]
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in setup["packed"].items()}
    with torch.enable_grad():
        r, cast = fr._ops(leaves, "float32")
        c = fr._forward_core(r, cast, em, de, vpe, p3, SKIP)
        out = torch.cat([c["rgb"], c["logit"][:, None]], dim=1)
    g_out = torch.as_tensor(np.random.default_rng(5).normal(
        size=(N, 4)).astype(np.float32))
    ref = dict(zip(leaves, torch.autograd.grad(
        (out * g_out).sum(), list(leaves.values()))))
    got = fr.radiance_backward_plain(setup["packed"], em, de, vpe, p3,
                                     c["g_e"].detach(), g_out, SKIP,
                                     "float32")
    _assert_close({k: v.numpy() for k, v in got.items()},
                  {k: v.numpy() for k, v in ref.items()}, 2e-4)


@pytest.mark.parametrize("chunk", [37, 100, 255])
def test_chunks_sum_to_the_whole(setup, chunk, monkeypatch):
    """Ragged chunks (the last one short) give the whole batch's gradients
    up to f32 summation order."""
    em, de, vpe, p3 = setup["ins"]
    g_out = torch.as_tensor(np.random.default_rng(6).uniform(
        0.5, 1.5, size=(N, 4)).astype(np.float32))
    args = (setup["packed"], em, de, vpe, p3, setup["g_e"], g_out, SKIP,
            "float32")
    monkeypatch.setattr(fr, "CHUNK", N)
    whole = fr.radiance_backward_plain(*args)
    monkeypatch.setattr(fr, "CHUNK", chunk)
    got = fr.radiance_backward_plain(*args)
    _assert_close({k: v.numpy() for k, v in got.items()},
                  {k: v.numpy() for k, v in whole.items()}, 1e-5)


def test_sweep_fills_the_workspace_layout(setup):
    """Every workspace row block has its operand, point-major, and the
    padded rows of g8 are zero."""
    em, de, vpe, p3 = setup["ins"]
    g_out = torch.ones((N, 4))
    ws = fr.radiance_sweep_plain(setup["packed"], em, de, vpe, p3,
                                 setup["g_e"], g_out, SKIP, "float32")
    w, ke, kv = 128, em.shape[1], vpe.shape[1]
    nt = JCFG.num_layers - 1
    lay, rows = fr.ws_layout(w, ke, kv, nt)
    assert set(ws) == set(lay)
    for k, (_, r) in lay.items():
        assert ws[k].shape == (N, r), k
    assert rows == sum(r for _, r in lay.values())
    assert rows == 42 * w + 2 * ke + kv + 14 - (7 - nt) * 4 * w
    offs = sorted(lay.values())
    assert all(a[0] + a[1] == b[0] for a, b in zip(offs, offs[1:]))
    assert [lay[k][0] for k in ("feat", "vpe", "p3", "n3")] == \
        [0, w, w + kv, w + kv + 3]
    assert (ws["g8"][:, 4:] == 0).all()
    torch.testing.assert_close(ws["g8"][:, :4], g_out)


def test_tf32_rna_rounding():
    """Round to 10 mantissa bits, ties away from zero, in both signs."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + ulp / 4, -(one + ulp / 2),
                      one + 3 * ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 3.0])
    torch.testing.assert_close(fr._tf32_rna(x), want, rtol=0, atol=0)


def test_split_weights_plain(setup):
    """hi and lo are tf32 values, hi + lo is within 2^-22 of each weight,
    and each k-step slab holds B's hi then lo part in core matrices."""
    packed = setup["packed"]
    words = fr.split_weights_plain(packed)
    mats = fr._split_mats(packed)
    assert words.shape == (sum(b.numel() // 2 for b in mats), 4)
    assert (words & 0x1FFF).eq(0).all()
    f = words.view(torch.float32)
    off = 0
    for b in mats:
        k, n = b.shape
        # [ks, part, n // 8, c, n % 8, kk] -> per part B[8 ks + 4 c + kk, n]
        blk = f[off:off + k * n // 2].reshape(k // 8, 2, n // 8, 2, 8, 4)
        off += k * n // 2
        hi, lo = (blk[:, q].permute(0, 2, 4, 1, 3).reshape(k, n)
                  for q in (0, 1))
        want = b.detach()
        torch.testing.assert_close(hi, fr._tf32_rna(want), rtol=0, atol=0)
        assert ((hi + lo - want).abs() <= 2.0 ** -22 * want.abs() + 1e-30).all()
    assert off == words.shape[0]


def _fake_f32(monkeypatch):
    """Replace the f32 kernels' launches and the card's properties by a
    recorder on the CPU; returns the list of (kernel, ints)."""
    launched = []

    def fake_launch(kernel, dev, tensors, ints):
        assert all(x.dtype in (torch.float32, torch.int32) for x in tensors)
        assert all(x.is_contiguous() for x in tensors)
        launched.append((kernel, list(ints)))
        if kernel == "fwd":
            tensors[-3].zero_()
            tensors[-2].zero_()
        if kernel == "reduce":
            for x in tensors[1:]:
                x.zero_()

    def fake_sizes(w, ke, kv, nt):
        return dict(split_words=8, ws_rows=fr.ws_layout(w, ke, kv, nt)[1],
                    fwd_scratch=8, sweep_scratch=8, slot_floats=8,
                    wgrad_tiles=4)

    monkeypatch.setattr(fr, "route", lambda x: "cuda")
    monkeypatch.setattr(fr, "_need_cuda", lambda dev: None)
    monkeypatch.setattr(fr, "_slots", lambda dev: 6)
    monkeypatch.setattr(fr, "f32_sizes", fake_sizes)
    monkeypatch.setattr(fr, "_launch_f32", fake_launch)
    return launched


def test_f32_launch_sequence_over_chunks(setup, monkeypatch):
    """A batch of 256 points in chunks of 96: split; sweep and wgrad of
    rows 0, 96 and 192 (64 points, ragged), each chunk's split-K slots
    after the last; one reduce over all slots."""
    launched = _fake_f32(monkeypatch)
    monkeypatch.setattr(fr, "CHUNK", 96)
    em, de, vpe, p3 = setup["ins"]
    fr.reset_launches()
    grads = fr.radiance_backward(setup["packed"], em, de, vpe, p3,
                                 setup["g_e"], torch.ones((N, 4)), SKIP,
                                 "float32")
    assert set(grads) == set(fr.PACK_ORDER)
    splits = 3                       # ceil(2 x 6 SMs / 4 tiles)
    names = [k for k, _ in launched]
    assert names == ["split"] + ["sweep", "wgrad"] * 3 + ["reduce"]
    sweeps = [i for k, i in launched if k == "sweep"]
    wgrads = [i for k, i in launched if k == "wgrad"]
    assert [(i[0], i[1], i[2]) for i in sweeps] == \
        [(96, 0, 128), (96, 96, 128), (64, 192, 128)]
    assert [(i[0], i[1], i[7], i[8]) for i in wgrads] == \
        [(128, 128, splits, 0), (128, 128, splits, 3), (64, 128, splits, 6)]
    assert launched[-1][1][-1] == 3 * splits
    assert fr.radiance_backward.launches == {"bfloat16": 0, "float32": 1}
    fr.reset_launches()
