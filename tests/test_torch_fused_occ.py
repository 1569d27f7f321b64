"""The fused occupancy-logit kernel's plain version (the CUDA kernel's
arithmetic in PyTorch) against psnerf_tpu's fused_occ_logit in interpret
mode at the full bear field on 1024 points (1e-2 max abs: bf16 operands,
rounding points that differ only in summation order), against the unfused
occ_logit at the JAX kernel test's bars, and the closure's outputs on a
ragged N."""

import jax
import numpy as np
import pytest
import torch

from psnerf_tpu.fields import occupancy as jocc
from psnerf_tpu.ops.fused_occ import fused_occ_logit as jfused
from psnerf_torch.fields import occupancy as occ
from psnerf_torch.ops import fused_occ as fo
from torch_helpers import j, port_occ_field, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bear():
    jcfg = jocc.OccFieldConfig()
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), jcfg)
    cfg, field = port_occ_field(jp, jcfg)
    p = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1024, 3)) * 0.8)
    return jcfg, jp, cfg, field, p


def test_plain_matches_jax_interpret(bear):
    jcfg, jp, cfg, field, p = bear
    ref = np.asarray(jfused(jp, j(p), jcfg, tile=1024, interpret=True))
    got = fo.fused_occ_logit(field, t(p), cfg).numpy()
    assert fo.fused_occ_logit.launches == 0      # CPU tensors: plain version
    assert np.abs(got - ref).max() < 1e-2


def test_plain_matches_unfused_logit(bear):
    jcfg, jp, cfg, field, p = bear
    ref = np.asarray(jocc.occ_logit(jp, j(p), jcfg))
    out = fo.fused_occ_logit_plain(field, t(p), cfg).numpy()
    # bf16 trunk: ~1e-2 abs on O(1) logits (tests/test_fused_occ.py:17-21)
    assert np.abs(out - ref).max() < 0.05
    assert np.corrcoef(out, ref)[0, 1] > 0.9999
    far = np.abs(ref) > 0.05
    assert ((out > 0) == (ref > 0))[far].all()


@pytest.mark.parametrize("n", [200, 1000])
def test_closure_outputs_on_ragged_n(n):
    jcfg = jocc.OccFieldConfig(num_layers=6, hidden_dim=128, feat_size=128,
                               octaves_pe=4, octaves_pe_views=2)
    jp = jocc.init_occupancy_field(jax.random.PRNGKey(0), jcfg)
    cfg, field = port_occ_field(jp, jcfg)
    p = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (n, 3)) * 0.5)
    alpha = fo.make_fused_occ_fn(field, cfg)(t(p))
    assert alpha.shape == (n,)
    np.testing.assert_allclose(alpha.numpy(),
                               np.asarray(jocc.occ_alpha(jp, j(p), jcfg)),
                               atol=0.02)
    inside = fo.make_fused_occ_fn(field, cfg, output="inside_logit")(t(p))
    np.testing.assert_array_equal(
        inside.numpy(), -fo.fused_occ_logit(field, t(p), cfg).numpy())
    with torch.no_grad():
        ref = occ.occ_logit(field, t(p), cfg).numpy()
    assert np.abs(-inside.numpy() - ref).max() < 0.05
    with pytest.raises(ValueError, match="output"):
        fo.make_fused_occ_fn(field, cfg, output="logit")


def test_packing_refuses_two_skips():
    cfg = occ.OccFieldConfig(num_layers=6, hidden_dim=64, feat_size=64,
                             skips=(2, 4))
    field = occ.init_occupancy_field(cfg)
    with pytest.raises(ValueError, match="one skip"):
        fo.pack_occ_operands(field, cfg)


@pytest.mark.parametrize("width", [64, 128, 256])
def test_slab_packing_unpacks_to_the_operands(width):
    """The kernel's k-step slabs, unpacked by the plain inverse of their
    layout, give back pack_occ_operands' matrices bit for bit, in the
    order the kernel reads them; and one slab element sits where
    trunk_wgmma.cuh says."""
    from psnerf_torch.ops.build import unpack_slabs

    cfg = occ.OccFieldConfig(num_layers=6, hidden_dim=width,
                             feat_size=width, skips=(3,))
    field = occ.init_occupancy_field(
        cfg, generator=torch.Generator().manual_seed(width))
    ops = fo.pack_occ_operands(field, cfg)
    slabs = fo.occ_slabs(ops)
    ke, k = ops["ke"], ops["n_pre"] + 1
    nt = ops["trunk_wT"].shape[0]
    assert slabs.dtype == torch.bfloat16
    assert slabs.numel() == width * (2 * ke + nt * width)
    got = unpack_slabs(slabs, width, [ke] + [width] * k + [ke]
                       + [width] * (nt - k))
    trunk = list(ops["trunk_wT"])
    want = [ops["w0T"], *trunk[:k], ops["wskipT"], *trunk[k:]]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # w0T[n][ks * 16 + kk] at (n // 8) * 128 + (kk // 8) * 64 + (n % 8) * 8
    # + kk % 8 of slab ks (slabs of 16 * width elements)
    n, kk, ks = 13, 11, 1
    at = ks * 16 * width + (n // 8) * 128 + (kk // 8) * 64 + (n % 8) * 8 + kk % 8
    assert slabs[at] == ops["w0T"][n, ks * 16 + kk]
