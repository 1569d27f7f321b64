"""The bf16 fused_radiance kernels' stages, as their plain versions and
layouts on the CPU (hidden 128, 4 layers, skip (2,), 256 points):
  * the bf16 backward as the composition of the sweep and the weight-
    gradient products, whole and over ragged chunks, against
    psnerf_tpu's fused_radiance_and_alpha(compute="bfloat16") in interpret
    mode (each leaf within 2e-2 of its max: both round every product
    operand to bf16 at the same points, and f32 summation order moves the
    roundings);
  * the bf16 workspace: its rows (ws_layout(..., "bfloat16")) and its
    core-matrix tiles of 8 features x 8 points (ws_index, pack_workspace,
    unpack_workspace);
  * the packed slabs the forward and the sweep stream, unpacking to the
    operands and their transposes;
  * the wrapper's bf16 launch sequence over chunks (fwd; sweep and wgrad
    per chunk with their row offsets, split-K slots and column-sum slots;
    the fixed-order sum), with the launches replaced by a recorder."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.ops.fused_radiance import fused_radiance_and_alpha as jfused
from psnerf_torch.ops import build
from psnerf_torch.ops import fused_radiance as fr
from torch_helpers import flatten_jax, j, port_occ_field, t, unit

torch.set_num_threads(1)
N = 256
JCFG = jocc.OccFieldConfig(num_layers=4, hidden_dim=128, feat_size=128,
                           skips=(2,), compute_dtype="bfloat16")
SKIP = JCFG.skips[0] - 1
BF = torch.bfloat16


@pytest.fixture(scope="module")
def setup():
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    cfg, field = port_occ_field(jp, JCFG)
    rng = np.random.default_rng(1)
    p = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = unit(rng, (N, 3))
    w_rgb = rng.uniform(0.5, 1.5, size=(N, 3)).astype(np.float32)
    w_a = rng.uniform(0.5, 1.5, size=(N,)).astype(np.float32)
    em, de, vpe, p3 = fr.radiance_inputs(t(p), t(rd), cfg)
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, BF)
        _, g_e = fr.radiance_forward_plain(packed, em, de, vpe, p3, SKIP)
    return dict(jp=jp, cfg=cfg, field=field, p=p, rd=rd, w_rgb=w_rgb,
                w_a=w_a, ins=(em, de, vpe, p3), g_e=g_e, packed=packed)


def _dims(setup):
    em, _, vpe, _ = setup["ins"]
    return 128, em.shape[1], vpe.shape[1], JCFG.num_layers - 1


@pytest.mark.parametrize("chunk", [None, 100])
def test_bf16_composition_matches_jax_interpret(setup, chunk, monkeypatch):
    """The packed bf16 gradients of sum(rgb w_rgb) + sum(alpha w_a) by the
    sweep and weight-gradient stages (whole, or over chunks of 100 points,
    as the kernels chunk), chained to the field's weight-norm leaves by
    autograd, against JAX's interpret-mode bf16 kernel."""
    if chunk:
        monkeypatch.setattr(fr, "CHUNK", chunk)
    s = setup
    field, cfg = s["field"], s["cfg"]

    def loss(params):
        rgb, a = jfused(params, j(s["p"]), j(s["rd"]), JCFG, tile=128,
                        interpret=True, compute="bfloat16")
        return jnp.sum(rgb * s["w_rgb"]) + jnp.sum(a * s["w_a"])

    ref = flatten_jax(jax.grad(loss)(s["jp"]))
    field.zero_grad()
    rgb, a = fr.fused_radiance_and_alpha(field, t(s["p"]), t(s["rd"]), cfg,
                                         compute="bfloat16")
    (torch.sum(rgb * t(s["w_rgb"])) + torch.sum(a * t(s["w_a"]))).backward()
    got = {k.replace(".", "/"): v.grad.numpy().copy()
           for k, v in field.named_parameters()}
    assert set(got) == set(ref)
    for k, r in ref.items():
        scale = np.abs(r).max() + 1e-8
        assert np.abs(got[k] - r).max() / scale < 2e-2, k
        if r.size > 8:
            assert np.corrcoef(got[k].ravel(), r.ravel())[0, 1] > 0.999, k


@pytest.mark.parametrize("chunk", [37, 100, 255])
def test_bf16_chunks_sum_to_the_whole(setup, chunk, monkeypatch):
    """Ragged chunks (the last one short) give the whole batch's bf16
    gradients up to f32 summation order."""
    em, de, vpe, p3 = setup["ins"]
    g_out = torch.as_tensor(np.random.default_rng(6).uniform(
        0.5, 1.5, size=(N, 4)).astype(np.float32))
    args = (setup["packed"], em, de, vpe, p3, setup["g_e"], g_out, SKIP)
    monkeypatch.setattr(fr, "CHUNK", N)
    whole = fr.radiance_backward_plain(*args)
    monkeypatch.setattr(fr, "CHUNK", chunk)
    got = fr.radiance_backward_plain(*args)
    for k, v in whole.items():
        scale = v.abs().max().item() + 1e-8
        assert (got[k] - v).abs().max().item() / scale < 1e-5, k


def test_bf16_workspace_layout(setup):
    """The bf16 workspace has the f32 form's rows less p3, n3 and w8lt
    (taken by the sweep's f32 column sums), [feat; vpe] one block; it
    holds them in core matrices of 8 features x 8 points, an 8-feature
    group's points contiguous; pack and unpack are inverses on the
    sweep's bf16-rounded operands, zero past the points."""
    w, ke, kv, nt = dims = _dims(setup)
    lay, rows = fr.ws_layout(*dims, "bfloat16")
    lay32, rows32 = fr.ws_layout(*dims)
    assert set(lay32) - set(lay) == {"p3", "n3", "w8lt"}
    assert rows == rows32 - w - 6 == 41 * w + 2 * ke + kv + 8 - (7 - nt) * 4 * w
    offs = sorted(lay.values())
    assert offs[0][0] == 0
    assert all(a[0] + a[1] == b[0] for a, b in zip(offs, offs[1:]))
    assert all(o % 8 == 0 and r % 8 == 0 for o, r in lay.values())
    assert [lay[k][0] for k in ("feat", "vpe")] == [0, w]
    ld = fr.round_up(N, fr.BF16_TILE)
    f = torch.arange(rows)[:, None]
    p = torch.arange(ld)[None, :]
    idx = fr.ws_index(f, p, ld)
    assert torch.equal(idx.flatten().sort().values, torch.arange(rows * ld))
    # one 8-feature group's run of 8 points is one 128-byte core matrix
    assert torch.equal(idx[8:16, 16:24].flatten().sort().values,
                       idx[8, 16] + torch.arange(64))
    assert (idx[8:16, 24] - idx[8:16, 16] == 64).all()

    em, de, vpe, p3 = setup["ins"]
    g_out = torch.ones((N, 4))
    ws = fr.radiance_sweep_plain(setup["packed"], em, de, vpe, p3,
                                 setup["g_e"], g_out, SKIP)
    flat = fr.pack_workspace(ws, dims, ld)
    assert flat.dtype == BF and flat.numel() == rows * ld
    back = fr.unpack_workspace(flat, dims, ld, N)
    assert set(back) == set(lay)
    for k, (o, r) in lay.items():
        assert back[k].shape == (N, r), k
        assert torch.equal(back[k], ws[k].to(BF).float()), k
        # element (feature o + c, point q) sits at ws_index
        c, q = r - 1, N - 1
        assert flat[fr.ws_index(o + c, q, ld)].float() == \
            ws[k][q, c].to(BF).float(), k
    mat = flat.float()[fr.ws_index(f, p, ld)]
    assert (mat[:, N:] == 0).all()


@pytest.mark.parametrize("width", [128, 256])
def test_bf16_slabs_unpack_to_the_operands(width):
    """The packed slabs are every product weight of the forward and the
    sweep as [N, K] (outputs, inputs): w0, wskip, wv transposed; trunk_w[i],
    w8f, wf, wa[j] transposed; then trunk_w[i], wskip and w0 (ke rows
    padded to the width with zeros), wa[j], wf, w8f as packed; in k-step
    slabs that build.unpack_slabs inverts bit for bit, each stacked run
    packed as its matrices one by one would be."""
    rng = np.random.default_rng(4)
    ke, kv, nt = 48, 32, 7 if width == 256 else 3
    shapes = fr._GRAD_SHAPES(width, ke, kv, nt)
    packed = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()}
    for k in ("w0", "wskip", "trunk_w", "w8f", "wv", "wf", "wa", "wa4"):
        packed[k] = packed[k].to(BF)
    slabs = fr.bf16_slabs(packed)
    assert slabs.dtype == BF and slabs.is_contiguous()
    runs = fr.bf16_slab_mats(packed)
    mats = [m for r in runs for m in (r if r.dim() == 3 else [r])]
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, width - ke))
    want = ([packed["w0"].T, packed["wskip"].T, packed["wv"].T]
            + [m.T for m in packed["trunk_w"]]
            + [packed["w8f"].T, packed["wf"].T]
            + [m.T for m in packed["wa"]] + list(packed["trunk_w"])
            + [pad(packed["wskip"]), pad(packed["w0"])] + list(packed["wa"])
            + [packed["wf"], packed["w8f"]])
    assert len(mats) == len(want) == 2 * nt + 15
    assert all(torch.equal(a, b) for a, b in zip(mats, want))
    assert torch.equal(slabs, build.pack_slabs(want))
    assert slabs.numel() == sum(m.numel() for m in mats)
    at = 0
    for m in mats:
        (got,) = build.unpack_slabs(slabs[at:at + m.numel()], m.shape[0],
                                    [m.shape[1]])
        assert torch.equal(got, m)
        at += m.numel()


def _fake_bf16(monkeypatch, packed):
    """Replace the bf16 library and its launches by a recorder on the CPU;
    returns the list of (what, ints)."""
    launched = []

    def fake_launch(fn, error, dev, tensors, ints, what):
        assert all(x.dtype in (torch.float32, BF) for x in tensors)
        assert all(x.is_contiguous() for x in tensors)
        launched.append((what, list(ints)))
        if what.endswith("fwd"):
            tensors[-3].zero_()
            tensors[-2].zero_()
        if what.endswith("slot sum"):
            tensors[1].zero_()

    def fake_sizes(w, ke, kv, nt):
        leaves, p_floats, c_floats = fr.bf16_slot_layout(w, ke, kv, nt)
        return dict(slab_bytes=2 * sum(m.numel() for m in
                                       fr.bf16_slab_mats(packed)),
                    ws_rows=fr.ws_layout(w, ke, kv, nt, "bfloat16")[1],
                    fwd_scratch=8, sweep_scratch=8, p_floats=p_floats,
                    c_floats=c_floats, wgrad_tiles=4)

    lib = types.SimpleNamespace(
        psnerf_radiance_fwd=None, psnerf_radiance_sweep=None,
        psnerf_radiance_wgrad=None, psnerf_radiance_slot_sum=None,
        psnerf_cuda_error_string=None)
    monkeypatch.setattr(fr, "route", lambda x: "cuda")
    monkeypatch.setattr(fr, "_need_cuda", lambda dev: None)
    monkeypatch.setattr(fr, "_slots", lambda dev: 6)
    monkeypatch.setattr(fr, "_lib", lambda: lib)
    monkeypatch.setattr(fr, "bf16_sizes", fake_sizes)
    monkeypatch.setattr(fr, "launch", fake_launch)
    return launched


def test_bf16_launch_sequence_over_chunks(setup, monkeypatch):
    """A batch of 256 points in chunks of 96 through the autograd op: the
    forward kernel; sweep and wgrad of rows 0, 96 and 192 (64 points,
    ragged), each chunk's split-K slots after the last, every chunk's
    column sums onto the same two slots (one 128-point CTA, zeroed before
    the first chunk), which the last chunk's weight-gradient pass folds
    into its split-K slots; one fixed-order sum over the split-K slots.
    The slabs are packed once, in the forward."""
    launched = _fake_bf16(monkeypatch, setup["packed"])
    monkeypatch.setattr(fr, "CHUNK", 96)
    packs = []
    real = fr.bf16_slabs
    monkeypatch.setattr(fr, "bf16_slabs", lambda p: packs.append(1) or real(p))
    fr.reset_launches()
    field, cfg = setup["field"], setup["cfg"]
    field.zero_grad()
    rgb, a = fr.fused_radiance_and_alpha(field, t(setup["p"]),
                                         t(setup["rd"]), cfg,
                                         compute="bfloat16")
    (rgb.sum() + a.sum()).backward()
    names = [w.split()[-1] if "bf16" in w else "slot_sum"
             for w, _ in launched]
    assert names == ["fwd"] + ["sweep", "wgrad"] * 3 + ["slot_sum"]
    assert len(packs) == 1
    splits = 3                       # ceil(2 x 6 SMs / 4 tiles)
    ints = [i for _, i in launched]
    sweeps, wgrads = ints[1:7:2], ints[2:7:2]
    assert [(i[0], i[1], i[2]) for i in sweeps] == \
        [(96, 0, 128), (96, 96, 128), (64, 192, 128)]
    assert [(i[0], i[1], i[7], i[8], i[9], i[10]) for i in wgrads] == \
        [(128, 128, splits, 0, 2, 0), (128, 128, splits, 3, 2, 0),
         (128, 128, splits, 6, 2, 1)]
    leaves, p_floats, c_floats = fr.bf16_slot_layout(*_dims(setup))
    assert ints[-1] == [p_floats + c_floats, 3 * splits]
    assert fr.bf16_launches == {"fwd": 1, "sweep": 3, "wgrad": 3}
    assert fr.slot_sum.launches == 1
    assert fr.radiance_forward.launches == {"bfloat16": 1, "float32": 0}
    assert fr.radiance_backward.launches == {"bfloat16": 1, "float32": 0}
    fr.reset_launches()
    assert fr.bf16_launches == {"fwd": 0, "sweep": 0, "wgrad": 0}
