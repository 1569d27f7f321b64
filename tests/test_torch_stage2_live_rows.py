"""Stage-2 training on the live rows of each batch (train.stage2.live_rows,
Stage2Runner.n_live) on the CPU: every loss term is a masked mean over
object_mask & surface_mask, so the step on the static prefix that holds
every such pixel gives the dense step's terms, gradients and parameters.

The scene has two train views whose loss-mask counts differ, and pixels
that are in the object mask but not in the exported surface mask, and the
reverse (the export's mask edited). The data-parallel case runs two gloo
ranks (tests/torch_dist_workers.py) and holds them against one process.
"""

import copy
import os

import numpy as np
import pytest
import torch

from psnerf_torch.config import Stage2Config
from psnerf_torch.data.synthetic import (generate_synthetic_scene,
                                         write_stage1_exports)
from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.parallel.launch import launch
from psnerf_torch.runners.stage2 import Stage2Runner
from psnerf_torch.train import losses, stage2
from psnerf_torch.utils import profiling
from torch_dist_workers import run_jobs

torch.set_num_threads(1)
HW = (24, 24)
WARMUP = 3
SPAWN_S = 240


def _edit_masks(exports):
    """Take a band of the object out of view 1's surface mask and a wider
    one out of view 2's, and put a band of background into view 1's; the
    larger loss-mask count is made odd, so two ray ranks round it up."""
    loss = {}
    for v, cut in ((1, 2), (2, 4)):
        p = os.path.join(exports, "mask", f"view_{v:02d}.npy")
        hit = np.load(p).reshape(HW)
        m = hit.copy()
        rows = np.where(m.any(1))[0]
        m[rows[0]:rows[0] + cut] = False            # object, not surface
        if v == 1:
            m[0, :5] = True                         # surface, not object
        loss[v] = (m, hit, p)
    m, hit, _ = loss[1]
    if (m & hit).sum() % 2 == 0:
        m[tuple(np.argwhere(m & hit)[-1])] = False
    for m, _, p in loss.values():
        np.save(p, m.reshape(-1))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("live_rows")
    d = str(root / "scene")
    generate_synthetic_scene(d, n_views=2, n_test=1, n_lights=4, hw=HW,
                             focal=30.0)
    exports = os.path.join(d, "exports")
    write_stage1_exports(d, exports, n_vis_plus=4)
    _edit_masks(exports)
    return root, d, exports


def _cfg(d, exports, **kw):
    net = PSNetConfig(mlp_width=16, mlp_depth=2, mlp_skip_at=-1,
                      sg_mlp_width=8, sg_mlp_depth=1, normal_mlp_width=16,
                      normal_mlp_depth=2, normal_mlp_skip_at=-1,
                      vis_mlp_width=16, vis_mlp_depth=3, vis_mlp_skip_at=1,
                      n_freqs_xyz=2, normal_n_freqs_xyz=2,
                      xyz_jitter_std=0.01, normal_jitter_std=0.02)
    train = stage2.Stage2TrainConfig(warmup_iters=WARMUP,
                                     weights=losses.Stage2LossWeights())
    return Stage2Config(**{**dict(
        net=net, train=train, data_dir=d, stage1_shape_path=exports,
        inten_normalize=None, light_init="gt", light_bs=2, vis_train_num=2,
        train_all_pixels=True, ckpt_freq=100000), **kw})


@pytest.fixture(scope="module")
def runner(scene):
    root, d, exports = scene
    return Stage2Runner(_cfg(d, exports), str(root / "one"), resume=False,
                        device="cpu")


def _loss_mask_counts(r):
    return (r.data["object_masks"] & r.data["surface_mask"]).sum(1)


def test_n_live_is_the_largest_view_count(runner):
    counts = _loss_mask_counts(runner)
    om, sm = runner.data["object_masks"], runner.data["surface_mask"]
    assert counts[0] != counts[1]
    assert bool((om & ~sm).any()) and bool((sm & ~om).any())
    assert runner.num_pixels == HW[0] * HW[1]
    assert runner.n_live == int(counts.max()) < runner.num_pixels


def _copy(params, dtype=torch.float32):
    return {"model": copy.deepcopy(params["model"]).to(dtype),
            **{k: params[k].to(dtype, copy=True)
               for k in ("light_dirs", "light_ints")}}


def _cast(tree, dtype):
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


def _leaves(params):
    out = {k: p.detach() for k, p in
           stage2.model_params(params["model"]).items()}
    out.update({k: params[k] for k in ("light_dirs", "light_ints")})
    return out


def _close_to_leaf_max(got, want, rel, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(w.abs().max())
        gap = float((got[k] - w).abs().max())
        assert gap <= rel * max(scale, 1e-30), (what, k, gap, scale)


@pytest.mark.parametrize("it", [0, WARMUP + 1], ids=["warmup", "after"])
def test_live_step_matches_the_dense_step(runner, it):
    """The step on live_rows' prefix against the step on the whole draw, in
    float64, where the two differ only in the order of their sums: every
    term to 1e-6 relative, every gradient and every parameter after Adam
    (the PSNet's leaves and both light tables) to 1e-6 of the leaf's
    largest value. (In float32 the two differ by the step's own rounding,
    ~1e-6 of the larger leaves' largest values and more on leaves whose
    gradient is mostly cancellation; the runner test holds float32.)"""
    bar, dtype = 1e-6, torch.float64
    batch, noise = runner.sample()
    live, lnoise = stage2.live_rows(batch, noise, runner.n_live)
    assert live["uv"].shape[0] == runner.n_live
    loss_px = lambda b: int((b["object_mask"] & b["surface_mask"]).sum())
    assert loss_px(live) == loss_px(batch) > 0
    runs = {"dense": (_cast(batch, dtype), _cast(noise, dtype)),
            "live": (_cast(live, dtype), _cast(lnoise, dtype))}

    params = _copy(runner.params, dtype)
    (t_d, g_d), (t_l, g_l) = (runner.step_fn.loss_and_grads(params, b, it, nz)
                              for b, nz in runs.values())
    assert t_l.keys() == t_d.keys()
    for k, v in t_d.items():
        np.testing.assert_allclose(float(t_l[k]), float(v), rtol=bar,
                                   atol=0, err_msg=k)
    assert any(float(g.abs().max()) > 0 for g in g_d.values())
    _close_to_leaf_max(g_l, g_d, bar, "gradient")

    after = {}
    for name, (b, nz) in runs.items():
        p = _copy(params, dtype)
        init_opt, step = stage2.make_stage2_train_step(runner.cfg.net,
                                                       runner.tcfg)
        step(p, init_opt(p), b, it, nz)
        after[name] = _leaves(p)
    before = _leaves(params)
    assert any(not torch.equal(v, before[k])
               for k, v in after["dense"].items())
    _close_to_leaf_max(after["live"], after["dense"], bar, "parameter")


def test_live_rows_keeps_every_loss_pixel_in_drawn_order(runner):
    batch, noise = runner.sample()
    live, lnoise = stage2.live_rows(batch, noise, runner.n_live)
    m = batch["object_mask"] & batch["surface_mask"]
    k = int(m.sum())
    want = batch["pix"][m]
    assert torch.equal(live["pix"][:k], want)
    rest = batch["pix"][~m][:runner.n_live - k]
    assert torch.equal(live["pix"][k:], rest)
    idx = torch.cat([torch.where(m)[0], torch.where(~m)[0]])[:runner.n_live]
    for key in stage2._PIX0:
        assert torch.equal(live[key], batch[key][idx]), key
    for key in stage2.STAGE2_PIX1:
        assert torch.equal(live[key], batch[key][:, idx]), key
    for key, v in noise.items():
        assert torch.equal(lnoise[key], v[idx]), key
    for key in batch.keys() - {*stage2._PIX0, *stage2.STAGE2_PIX1}:
        assert live[key] is batch[key], key


@pytest.mark.parametrize("extra", [0, 7])
def test_live_rows_is_the_identity_on_a_whole_batch(runner, extra):
    batch, noise = runner.sample()
    b, nz = stage2.live_rows(batch, noise, runner.num_pixels + extra)
    assert b is batch and nz is noise


def test_sampled_batches_are_not_cut(scene, tmp_path):
    """num_pixels under every view's loss-mask count: nothing to cut."""
    _, d, exports = scene
    r = Stage2Runner(_cfg(d, exports, train_all_pixels=False,
                          num_pixels=32), str(tmp_path), resume=False,
                     device="cpu")
    assert r.n_live == r.num_pixels == 32


def test_runner_training_matches_dense_training(scene, tmp_path):
    """Three steps of Stage2Runner.train (one in the warm-up, two after),
    against the same runner made to shade every drawn pixel."""
    _, d, exports = scene
    cfg = _cfg(d, exports)
    live = Stage2Runner(cfg, str(tmp_path / "a"), resume=False,
                        device="cpu")
    dense = Stage2Runner(cfg, str(tmp_path / "b"), resume=False,
                         device="cpu")
    dense.n_live = dense.num_pixels
    assert live.n_live < dense.n_live
    steps = WARMUP + 2
    live.it = dense.it = WARMUP - 1
    live.train(steps, log_every=1000)
    dense.train(steps, log_every=1000)
    want, got = _leaves(dense.params), _leaves(live.params)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_counters_record_only_while_tracing(runner, tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        runner.train(runner.it + 2, log_every=1000)
    c = profiling.counters()
    assert c["stage2.drawn_px"] == 2 * runner.num_pixels
    assert c["stage2.shaded_px"] == 2 * runner.n_live
    runner.train(runner.it + 1, log_every=1000)
    assert profiling.counters() == c


def test_two_ranks_shade_the_live_rows(scene):
    """Two gloo ranks: n_live rounded up to the ray ranks; the step on each
    rank's block of the cut batch gives one process's dense terms and
    gradients; three steps of the mesh runner give the one-process runner's
    parameters."""
    root, d, exports = scene
    cfg = _cfg(d, exports)
    jobs = [("step", "stage2_live_step",
             dict(cfg=cfg, workdir=str(root / "m_step"), it=WARMUP + 1)),
            ("runner", "stage2_runner",
             dict(cfg=cfg, workdir=str(root / "m_run"), steps=3, tile=64))]
    ranks = launch(run_jobs, 2, jobs, device="cpu", timeout=SPAWN_S)

    one = Stage2Runner(cfg, str(root / "single"), resume=False,
                       device="cpu")
    count = int(_loss_mask_counts(one).max())
    assert count % 2 == 1 and one.n_live == count
    batch, noise = one.sample()
    terms, grads = one.step_fn.loss_and_grads(one.params, batch, WARMUP + 1,
                                              noise)
    for r in ranks:
        got = r["step"]
        assert got["n_live"] == count + 1
        for k, v in terms.items():
            np.testing.assert_allclose(got["terms"][k], float(v), rtol=1e-6,
                                       err_msg=k)
        _close_to_leaf_max({k: torch.as_tensor(v)
                            for k, v in got["grads"].items()}, grads, 1e-6,
                           "gradient")

    one = Stage2Runner(cfg, str(root / "single_run"), resume=False,
                       device="cpu")
    one.train(3, log_every=1000)
    want = {k: v.numpy() for k, v in _leaves(one.params).items()}
    for r in ranks:
        got = r["runner"]["params"]
        for k, w in want.items():
            name = k if k.startswith("light_") else f"model/{k}"
            np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=2e-6,
                                       err_msg=k)
