"""The operation and byte counts of the mfu and roofline metrics: one
layer's count by hand at unpadded widths, without recompute, and each
reader on a made-up trace."""

import types

import pytest

from benchmark import harness, work

S1 = harness.load_cell("s1_train_bear")["cfg"]
S2 = harness.load_cell("s2_eval_bear")["cfg"]


def test_stage1_logit_by_hand():
    # PE(6 octaves) of 3 = 39 in; 8 layers of 256 with the skip at 4 (the
    # layer before it narrows to 256 - 39 = 217); the logit row alone
    hand = 2 * (39 * 256 + 256 * 256 + 256 * 256 + 256 * 217 + 256 * 256
                + 3 * 256 * 256 + 256 * 1)
    assert work.Unisurf(S1["model"]).logit == hand


def test_stage1_step_by_hand():
    u = work.Unisurf(S1["model"])
    app = 2 * ((3 + 27 + 3 + 256) * 256 + 3 * 256 * 256 + 256 * 3)
    assert u.app == app
    f = work.unisurf_step(S1)
    # 2048 rays x 96 samples: geometry (logit and feature), its input
    # gradient, appearance; forward once, backward twice
    assert f["radiance"] == 3 * 2048 * 96 * (u.full + u.grad + u.app)
    assert f["march_points"] == 2048 * (256 + 8)
    assert f["bf16"] == 2048 * 264 * u.logit


def test_visibility_pair_by_hand():
    o = work.PSNetOps(S2)
    e = 63                       # PE(10 octaves) of 3
    # 8 layers of 256, skip at 4: layer 5 takes 256 + 2 * 63; the point
    # and light halves of layers 0 and 5 are not per pair
    pair = 2 * (256 * 256 * 7 + 256 * 1)
    assert o.vis_pair == pair
    assert o.vis_point == o.vis_light == 2 * 2 * e * 256
    v = work.psnet_view(S2, 1000, 96)
    assert v["bf16"] == 1000 * (o.vis_point + 96 * pair)


def test_stage2_step_by_hand():
    o = work.PSNetOps(S2)
    albedo = 2 * (63 * 128 + 128 * 128 * 2 + (128 + 63) * 128 + 128 * 3)
    assert o.albedo == albedo
    f = work.psnet_step(S2, 8192, 10, 8)
    heads = 3 * (o.albedo + o.rough + o.normal) + 3 * (o.albedo + o.rough)
    assert f["tf32"] == 8192 * (heads + (10 + 3 * 8) * o.vis)


def fake_run(cfg, params, kernels, steps, window_s, busy_s, **work_):
    summary = {"kernels": kernels, "busy_s": busy_s, "window_s": window_s,
               "device_ops": [], "idle_gaps": []}
    return types.SimpleNamespace(cfg=cfg, params=params,
                                 trace_summary=summary,
                                 window={"attempted": steps}, work=work_,
                                 spans={}, counters={})


def test_readers_on_a_made_up_trace():
    f = work.unisurf_step(S1)
    k1 = f["bf16"] / 989e12                         # seconds a step
    run = fake_run(S1, {}, [["void occ_kernel<256>(P)", 0.0, 2e6 * k1]],
                   steps=10, window_s=2.0, busy_s=1.5)
    occ = harness.metric_reader("occ_roofline.s1_train")(run)
    assert occ == pytest.approx(100 * 10 * k1 / (2 * k1))
    assert harness.metric_reader("idle_share.s1_train")(run) == \
        pytest.approx(25.0)
    assert harness.metric_reader("radiance_f32_roofline.s1_train")(run) \
        is None                                     # no such kernel ran
    mfu = harness.metric_reader("mfu.s1_train")(run)
    assert mfu == pytest.approx(100 * 10 * work.least_seconds(
        {"tf32": f["tf32"], "bf16": f["bf16"]}) / 2.0)
