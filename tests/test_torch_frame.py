"""psnerf_torch's stage-2 frame renderer against psnerf_tpu's, at the full
PSNetConfig() widths on a 16x32 frame under 6 lights.

Both routes are held: the plain route (use_fused_vis=False, f32 everywhere,
1e-5 abs) and the kernel routes (use_fused_vis=True: the port's kernels'
plain versions on the CPU against the JAX Pallas kernels run with
interpret=True, 1e-3 abs, since both round to bf16 at the same points and
only the f32 summation order differs).
"""

import jax
import numpy as np
import pytest
import torch

from psnerf_tpu.core.rays import pose_to_matrix as jpose_to_matrix
from psnerf_tpu.eval import frame as jframe
from psnerf_tpu.fields.psnet import PSNetConfig as JCfg, init_psnet as jinit
from psnerf_torch.eval import frame
from psnerf_torch.ops import fused_vis as fv
from torch_helpers import j, port_psnet, t, unit

torch.set_num_threads(1)
H, W, L = 16, 32, 6
N = H * W
TILE = 256
ALL_OUTPUTS = ("rgb", "rgb_cnl", "rgb_sum", "albedo", "rough", "visibility",
               "normal_pred", "sg_weight")
# The sharpest SG lobe is exp(e^10 (h.n - 1)): an f32 rounding step in h.n
# moves it by up to 2.2e4 ulp, so outputs that carry the specular term get a
# relative bar beside the absolute one (measured: 2.5e-4 relative at 0.11).
SPECULAR_KEYS = frozenset({"rgb", "rgb_cnl", "rgb_sum", "rough"})
SPECULAR_RTOL = 1e-3


def _frame_inputs(seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    q = unit(rng, (4,))
    pose = np.asarray(jpose_to_matrix(j(np.concatenate(
        [q, [0.1, -0.2, 3.0]]).astype(np.float32))))
    K = np.asarray([[30.0, 0, W / 2, 0], [0, 30.0, H / 2, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float32)
    return dict(
        uv=np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32),
        pose=pose, K=K,
        pts=(rng.normal(size=(N, 3)) * 0.3).astype(np.float32),
        nrm=unit(rng, (N, 3)), msk=rng.uniform(size=N) > 0.35,
        ld=unit(rng, (L, 3)),
        li=(rng.uniform(size=L) * 2 + 0.5).astype(np.float32))


def _render_both(outputs, use_fused_vis, cfg_kw=None, seed=0):
    jcfg = JCfg(**(cfg_kw or {}))
    params = jinit(jax.random.PRNGKey(seed), jcfg)
    model = port_psnet(params, jcfg)
    d = _frame_inputs(seed)
    keys = ("uv", "pose", "K", "pts", "nrm", "msk", "ld", "li")
    ref = jframe.render_frame_stage2(
        params, jcfg, *[j(d[k]) for k in keys], tile=TILE, outputs=outputs,
        use_fused_vis=use_fused_vis, fused_interpret=True)
    got = frame.render_frame_stage2(
        model, model.cfg, *[t(d[k]) for k in keys], tile=TILE,
        outputs=outputs, use_fused_vis=use_fused_vis)
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in got.items()}, d


def _assert_close(ref, got, atol):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        rtol = SPECULAR_RTOL if k in SPECULAR_KEYS else 0
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("cfg_kw", [dict(), dict(render_model="microfacet")])
def test_plain_route_all_outputs(cfg_kw):
    outputs = ALL_OUTPUTS
    ref, got, _ = _render_both(outputs, False, cfg_kw)
    _assert_close(ref, got, 1e-5)


def test_fused_visibility_route():
    """Outputs the shading kernel cannot serve (rough, visibility) take
    fused_visibility, then plain shading tiles."""
    outputs = ("rgb", "albedo", "rough", "visibility", "normal_pred")
    before_vis = fv.fused_visibility.launches
    before_shade = fv.fused_vis_shade.launches
    ref, got, _ = _render_both(outputs, True)
    _assert_close(ref, got, 1e-3)
    # on CPU tensors the wrappers run their plain versions: no launches
    assert fv.fused_visibility.launches == before_vis
    assert fv.fused_vis_shade.launches == before_shade


@pytest.mark.parametrize("outputs", [
    ("rgb",), ("rgb_cnl",), ("rgb_sum",),
    ("rgb", "rgb_cnl", "rgb_sum", "albedo", "sg_weight", "normal_pred"),
    ("rgb_cnl", "rgb_sum")])
def test_fused_shade_route(outputs):
    ref, got, d = _render_both(outputs, True)
    _assert_close(ref, got, 1e-3)
    if "rgb_sum" in outputs:
        # the ones fill outside the mask is on real lights only: sum = L
        assert (got["rgb_sum"][~d["msk"]] == float(L)).all()


def test_fused_routes_agree_with_plain_route():
    """The kernel routes against the port's own f32 route, at the JAX
    kernel tests' rgb bars (max < 2e-2, mean < 2e-3)."""
    outputs = ("rgb", "visibility")
    _, plain, _ = _render_both(outputs, False)
    _, fused, _ = _render_both(outputs, True)
    _, shade, _ = _render_both(("rgb",), True)
    for got in (fused["rgb"], shade["rgb"]):
        err = np.abs(got - plain["rgb"])
        assert err.max() < 2e-2 and err.mean() < 2e-3
    vis = fused["visibility"]
    rel = np.abs(vis - plain["visibility"]) / (
        np.abs(plain["visibility"]) + 1e-2)
    assert rel.max() < 0.05


def test_make_frame_renderer_matches_direct_call():
    jcfg = JCfg()
    params = jinit(jax.random.PRNGKey(4), jcfg)
    model = port_psnet(params, jcfg)
    d = _frame_inputs(4)
    args = [t(d[k]) for k in ("uv", "pose", "K", "pts", "nrm", "msk", "ld",
                              "li")]
    fn = frame.make_frame_renderer(model.cfg, tile=TILE,
                                   outputs=("rgb", "albedo"))
    a = fn(model, *args)
    b = frame.render_frame_stage2(model, model.cfg, *args, tile=TILE,
                                  outputs=("rgb", "albedo"))
    for k in ("rgb", "albedo"):
        assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError, match="divisible"):
        frame.render_frame_stage2(model, model.cfg, *args, tile=300)
