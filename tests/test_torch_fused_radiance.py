"""The fused radiance+alpha op's plain versions (the CUDA kernels'
arithmetic, and the backward kernel's explicit second-order sweep, in
PyTorch) against psnerf_tpu's fused_radiance_and_alpha in interpret mode,
at hidden 128, 4 layers, skip (2,), on 256 points:
  * forward at compute="float32" within 1e-5, at "bfloat16" within 1e-2
    max abs and corr > 0.9999 (bf16 operands; only summation order and
    the rounding of values that differ by it separate the two);
  * weight gradients at f32 within 2e-4 of each leaf's scale, against
    JAX's interpret-mode gradients and against torch.autograd of the
    port's own radiance_and_alpha;
  * ragged N and leading batch dims; `supports` (both operand forms, the
    architecture refusals); and the routing of compute="float32" on a CUDA
    route to the f32 kernels' launch path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.ops.fused_radiance import fused_radiance_and_alpha as jfused
from psnerf_torch.fields import occupancy as occ
from psnerf_torch.ops import fused_radiance as fr
from torch_helpers import flatten_jax, j, port_occ_field, t, unit

torch.set_num_threads(1)
N = 256
JCFG = jocc.OccFieldConfig(num_layers=4, hidden_dim=128, feat_size=128,
                           skips=(2,))


@pytest.fixture(scope="module")
def setup():
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), JCFG)
    cfg, field = port_occ_field(jp, JCFG)
    rng = np.random.default_rng(1)
    p = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = unit(rng, (N, 3))
    w_rgb = rng.normal(size=(N, 3)).astype(np.float32)
    w_a = rng.normal(size=(N,)).astype(np.float32)
    return jp, cfg, field, p, rd, w_rgb, w_a


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_matches_jax_interpret(setup, compute):
    jp, cfg, field, p, rd, _, _ = setup
    rgb_ref, a_ref = jfused(jp, j(p), j(rd), JCFG, tile=128, interpret=True,
                            compute=compute)
    with torch.no_grad():
        rgb, a = fr.fused_radiance_and_alpha(field, t(p), t(rd), cfg,
                                             compute=compute)
    got = np.concatenate([rgb.numpy(), a.numpy()[:, None]], axis=1)
    ref = np.concatenate([np.asarray(rgb_ref), np.asarray(a_ref)[:, None]],
                         axis=1)
    if compute == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    else:
        assert np.abs(got - ref).max() < 1e-2
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999


def _port_grads(field, cfg, p, rd, w_rgb, w_a, fused):
    field.zero_grad()
    fn = (lambda: fr.fused_radiance_and_alpha(field, t(p), t(rd), cfg,
                                              compute="float32")) if fused \
        else (lambda: occ.radiance_and_alpha(field, t(p), t(rd), cfg))
    rgb, a = fn()
    (torch.sum(rgb * t(w_rgb)) + torch.sum(a * t(w_a))).backward()
    return {k.replace(".", "/"): v.grad.numpy().copy()
            for k, v in field.named_parameters()}


def _assert_close(got, ref, atol):
    assert set(got) == set(ref)
    for k, a in ref.items():
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(got[k] / scale, a / scale, rtol=0,
                                   atol=atol, err_msg=k)


def test_backward_matches_jax_interpret(setup):
    jp, cfg, field, p, rd, w_rgb, w_a = setup

    def loss(params):
        rgb, a = jfused(params, j(p), j(rd), JCFG, tile=128, interpret=True,
                        compute="float32")
        return jnp.sum(rgb * w_rgb) + jnp.sum(a * w_a)

    ref = flatten_jax(jax.grad(loss)(jp))
    _assert_close(_port_grads(field, cfg, p, rd, w_rgb, w_a, True), ref, 2e-4)


def test_backward_matches_port_autograd(setup):
    """The explicit sweep (second-order terms included) against autograd's
    double backward through the port's unfused radiance_and_alpha."""
    _, cfg, field, p, rd, w_rgb, w_a = setup
    ref = _port_grads(field, cfg, p, rd, w_rgb, w_a, False)
    _assert_close(_port_grads(field, cfg, p, rd, w_rgb, w_a, True), ref, 2e-4)


def test_plain_backward_is_the_packed_gradient(setup):
    """radiance_backward_plain returns d sum(out * g_out) / d packed, as
    autograd of the plain forward does."""
    _, cfg, field, p, rd, _, _ = setup
    em, de, vpe, p3 = fr.radiance_inputs(t(p), t(rd), cfg)
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.float32)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in packed.items()}
    with torch.enable_grad():
        r, cast = fr._ops(leaves, "float32")
        c = fr._forward_core(r, cast, em, de, vpe, p3, 1)
        out = torch.cat([c["rgb"], c["logit"][:, None]], dim=1)
    g_out = torch.as_tensor(np.random.default_rng(5).normal(
        size=(N, 4)).astype(np.float32))
    ref = dict(zip(leaves, torch.autograd.grad(
        (out * g_out).sum(), list(leaves.values()))))
    got = fr.radiance_backward_plain(packed, em, de, vpe, p3, c["g_e"].detach(),
                                     g_out, 1, "float32")
    _assert_close({k: v.numpy() for k, v in got.items()},
                  {k: v.numpy() for k, v in ref.items()}, 2e-4)


def test_padding_and_batch_shape(setup):
    jp, cfg, field, p, rd, _, _ = setup
    p2, rd2 = p[:200].reshape(8, 25, 3), rd[:200].reshape(8, 25, 3)
    rgb_ref, a_ref = jocc.radiance_and_alpha(jp, j(p2), j(rd2), JCFG)
    with torch.no_grad():
        rgb, a = fr.fused_radiance_and_alpha(field, t(p2), t(rd2), cfg,
                                             compute="float32")
    assert rgb.shape == (8, 25, 3) and a.shape == (8, 25)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), atol=1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=1e-5)


def test_supports_and_f32_refused_on_cuda(setup, monkeypatch):
    """supports() takes both operand forms and refuses what the kernels'
    layout does not; on a CUDA route compute="float32" reaches the f32
    kernels' launch path (forward and backward, f32 operands), and an
    unknown form is refused."""
    _, cfg, field, p, rd, _, _ = setup
    assert fr.supports(occ.OccFieldConfig())                # f32, default
    assert fr.supports(occ.OccFieldConfig(compute_dtype="bfloat16"))
    assert fr.supports(cfg)
    for bf in ("float32", "bfloat16"):
        assert not fr.supports(occ.OccFieldConfig(
            compute_dtype=bf, feat_size=128))               # split head
        assert not fr.supports(occ.OccFieldConfig(
            compute_dtype=bf, skips=(2, 4)))
        assert not fr.supports(occ.OccFieldConfig(
            compute_dtype=bf, hidden_dim=64, feat_size=64))
    launched = []

    def fake_launch(kernel, dev, tensors, ints):
        assert all(x.dtype in (torch.float32, torch.int32) for x in tensors)
        launched.append(kernel)
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
    monkeypatch.setattr(fr, "_slots", lambda dev: 2)
    monkeypatch.setattr(fr, "f32_sizes", fake_sizes)
    monkeypatch.setattr(fr, "_launch_f32", fake_launch)
    fr.reset_launches()
    field.zero_grad()
    rgb, a = fr.fused_radiance_and_alpha(field, t(p), t(rd), cfg,
                                         compute="float32")
    (rgb.sum() + a.sum()).backward()
    # forward: the prologue, then the forward kernel; backward: the
    # prologue, one chunk's sweep and weight-gradient pass, the reduce
    assert launched == ["split", "fwd", "split", "sweep", "wgrad", "reduce"]
    assert fr.radiance_forward.launches == {"bfloat16": 0, "float32": 1}
    assert fr.radiance_backward.launches == {"bfloat16": 0, "float32": 1}
    fr.reset_launches()
    with pytest.raises(ValueError, match="compute"):
        fr.fused_radiance_and_alpha(field, t(p), t(rd), cfg, compute="f16")


@pytest.mark.parametrize("width,nt", [(256, 7), (128, 3)])
def test_bf16_slot_layout_aligns_every_leaf(width, nt):
    """The bf16 backward's gradients, one flat buffer laid out leaf after
    leaf in two regions: the products' (the split-K slots' floats, a
    multiple of 4: slot_sum's 16-byte loads) and the column sums' (the
    column-sum slots'), every leaf contiguous and inside its region, all
    18 in the packed order's sizes; the CPU route of slot_sum adds the
    slots in order, into a given output too."""
    leaves, p_floats, c_floats = fr.bf16_slot_layout(width, 48, 32, nt)
    shapes = fr._GRAD_SHAPES(width, 48, 32, nt)
    assert list(leaves) == fr.PACK_ORDER
    assert p_floats % 4 == 0 and c_floats % 4 == 0
    runs = sorted((o, int(np.prod(shapes[k])), k) for k, o in leaves.items())
    prods = {"trunk_w", "w0", "wskip", "w8f", "wa", "wf", "wv", "wa4"}
    assert runs[0][0] == 0 and runs[len(prods)][0] == p_floats
    for (o, n, k), (o2, _, _) in zip(runs, runs[1:] + [(None, 0, None)]):
        end = p_floats if k in prods else p_floats + c_floats
        assert (o < p_floats) == (k in prods), k
        assert o + n <= end, k
        if o2 is not None and o2 != p_floats:
            assert o + n == o2, k
    assert leaves["wv"] == leaves["wf"] + width * width    # one product
    slots = torch.as_tensor(np.random.default_rng(3).normal(
        size=(5, p_floats)).astype(np.float32))
    want = slots[0] + slots[1] + slots[2] + slots[3] + slots[4]
    assert torch.equal(fr.slot_sum(slots), want)
    out = torch.empty(p_floats + c_floats)
    fr.slot_sum(slots, out=out[:p_floats])
    assert torch.equal(out[:p_floats], want)
