"""The whole slice: psnerf_torch's Stage2Runner.evaluate against
psnerf_tpu's, from one checkpoint written by the JAX package, on a 32x32
synthetic scene with ragged light counts (6, 5, 4 train lights; 6 on the
test view) and small PSNet widths.

Every npy that both runners write is compared at 1e-4 abs (masks exactly);
the port's data/synthetic.py must write the same bytes as the JAX
package's for one seed.
"""

import os

import numpy as np
import pytest
import torch

from psnerf_tpu.config import Stage2Config as JStage2Config
from psnerf_tpu.data.scene import load_scene_params as jload_scene
from psnerf_tpu.data.stage2 import load_stage2_data as jload_stage2
from psnerf_tpu.data.synthetic import (generate_synthetic_scene as jgen,
                                       write_stage1_exports as jexports)
from psnerf_tpu.fields.psnet import PSNetConfig as JPSNetConfig
from psnerf_tpu.runners.stage2 import Stage2Runner as JRunner
from psnerf_tpu.train.losses import Stage2LossWeights as JWeights
from psnerf_tpu.train.stage2 import Stage2TrainConfig as JTrainConfig
from psnerf_torch.config import Stage2Config
from psnerf_torch.data import synthetic
from psnerf_torch.data.scene import load_scene_params
from psnerf_torch.data.stage2 import load_stage2_data
from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.runners.stage2 import Stage2Runner
from psnerf_torch.train.losses import Stage2LossWeights
from psnerf_torch.train.stage2 import Stage2TrainConfig
from torch_helpers import port_config

torch.set_num_threads(1)
SCENE_KW = dict(n_views=3, n_test=1, n_lights=6, hw=(32, 32),
                ragged_lights=True)
TILE = 256


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("t2_scene"))
    jgen(d, **SCENE_KW)
    jexports(d, os.path.join(d, "exports"), n_vis_plus=6)
    return d


def _jcfg(scene):
    return JStage2Config(
        net=JPSNetConfig(mlp_width=32, sg_mlp_width=16, normal_mlp_width=32,
                         vis_mlp_width=32, vis_mlp_depth=4, vis_mlp_skip_at=2,
                         n_freqs_xyz=4, normal_n_freqs_xyz=4, light_int=1.2),
        train=JTrainConfig(warmup_iters=10,
                           weights=JWeights(vis_weight=1.0)),
        data_dir=scene, stage1_shape_path=os.path.join(scene, "exports"),
        inten_normalize=None, light_bs=4, vis_train_num=4, num_pixels=256,
        train_all_pixels=False, ckpt_freq=100000)


def _port_cfg(jcfg):
    """The same run config as the port's dataclasses."""
    fields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    tr = jcfg.train
    fields["net"] = port_config(jcfg.net, PSNetConfig)
    fields["train"] = Stage2TrainConfig(**{
        **{f: getattr(tr, f) for f in tr.__dataclass_fields__},
        "weights": port_config(tr.weights, Stage2LossWeights)})
    return Stage2Config(**fields)


def _tree_files(root):
    out = []
    for dp, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(dp, f), root) for f in fs]
    return sorted(out)


def test_synthetic_scene_files_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jgen(a, seed=3, **SCENE_KW)
    jexports(a, os.path.join(a, "exports"), n_vis_plus=6)
    synthetic.generate_synthetic_scene(b, seed=3, **SCENE_KW)
    synthetic.write_stage1_exports(b, os.path.join(b, "exports"),
                                   n_vis_plus=6)
    files = _tree_files(a)
    assert files == _tree_files(b) and len(files) > 50
    for f in files:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_stage2_data_matches(scene, split):
    """Ragged light counts, padding, u8 image store: identical arrays."""
    exports = os.path.join(scene, "exports")
    ref = jload_stage2(jload_scene(scene), exports, split,
                       inten_normalize=None)
    got = load_stage2_data(load_scene_params(scene), exports, split,
                           inten_normalize=None, device="cpu")
    assert set(got) == set(ref)
    assert got["imgs"].dtype == torch.uint8
    for k, r in ref.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        if isinstance(r, (int, tuple)):
            assert tuple(np.atleast_1d(g)) == tuple(np.atleast_1d(r)), k
        else:
            np.testing.assert_array_equal(g, np.asarray(r), err_msg=k)
    if split == "train":
        assert list(got["light_count"]) == [6, 5, 4]


@pytest.fixture(scope="module")
def runners(scene, tmp_path_factory):
    """A JAX runner that writes its initial checkpoint, and a port runner
    on the CPU that resumes from it."""
    wd = str(tmp_path_factory.mktemp("t2_wd"))
    jcfg = _jcfg(scene)
    jr = JRunner(jcfg, wd, resume=False)
    jr.save(7)
    pr = Stage2Runner(_port_cfg(jcfg), wd, device="cpu")
    return jr, pr


def test_runner_resumes_from_jax_checkpoint(runners):
    jr, pr = runners
    assert pr.it == 7
    np.testing.assert_array_equal(pr.params["light_dirs"].numpy(),
                                  np.asarray(jr.params["light_dirs"]))
    np.testing.assert_array_equal(pr.params["light_ints"].numpy(),
                                  np.asarray(jr.params["light_ints"]))
    w = pr.params["model"]["visibility"][0].w.detach().numpy()
    np.testing.assert_array_equal(
        w, np.asarray(jr.params["model"]["visibility"][0]["w"]))


def test_evaluate_matches_jax(runners, tmp_path):
    jr, pr = runners
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jr.evaluate(out_j, split="test", tile=TILE)
    pr.evaluate(out_t, split="test", tile=TILE)
    files = _tree_files(out_j)
    assert files == _tree_files(out_t)
    npys = [f for f in files if f.endswith(".npy")]
    subs = {f.split(os.sep)[0] for f in npys}
    assert subs == {"rgb", "albedo", "rough", "visibility", "normal", "mask"}
    # the test view renders one png per light of its own (6)
    assert len([f for f in files if f.startswith(os.path.join(
        "rgb", "img"))]) == 6
    for f in npys:
        a = np.load(os.path.join(out_j, f))
        b = np.load(os.path.join(out_t, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f.startswith("mask"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=f)


def test_trained_lights_for_view_match(runners):
    jr, pr = runners
    for split in ("train", "test"):
        jd, pd = jr._eval_data(split), pr._eval_data(split)
        for v in range(len(jd["views"])):
            jdirs, jints = jr.trained_lights_for_view(jd, v)
            dirs, ints = pr.trained_lights_for_view(pd, v)
            np.testing.assert_allclose(dirs, jdirs, atol=1e-6)
            np.testing.assert_array_equal(ints, jints)


@pytest.mark.parametrize("use_fused_vis", [False, True])
def test_compact_render_matches_full(runners, use_fused_vis):
    """Mask compaction gathers the in-mask pixels and scatters them back
    with the reference fills; per-pixel math is independent, so the full
    render is reproduced, on the plain route and the kernel route."""
    _, pr = runners
    data = pr._eval_data("test")
    dirs, ints = pr.trained_lights_for_view(data, 0)
    outs = ("rgb", "rgb_sum", "albedo", "visibility", "normal_pred",
            "sg_weight", "rough")
    kw = dict(tile=TILE, outputs=outs, use_fused_vis=use_fused_vis)
    full = pr.render_view(data, 0, dirs, ints, compact=False, **kw)
    comp = pr.render_view(data, 0, dirs, ints, compact=True, **kw)
    assert set(full) == set(comp)
    for k in full:
        np.testing.assert_allclose(comp[k], full[k], atol=1e-5, err_msg=k)
    outside = ~full["mask"]
    assert (full["rgb_sum"][outside] == float(len(dirs))).all()
    assert (full["sg_weight"][outside] == 0.0).all()


def test_render_view_matches_jax_for_rgb_sum(runners):
    """The rgb and rgb_sum outputs that serve relighting, on the plain
    route of both packages."""
    jr, pr = runners
    jd, pd = jr._eval_data("test"), pr._eval_data("test")
    dirs, ints = pr.trained_lights_for_view(pd, 0)
    outs = ("rgb", "rgb_sum")
    ref = jr.render_view(jd, 0, dirs, ints, tile=TILE, outputs=outs)
    got = pr.render_view(pd, 0, dirs, ints, tile=TILE, outputs=outs)
    for k in outs:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=0,
                                   err_msg=k)


ALL_OUTPUTS = ("rgb", "rgb_sum", "albedo", "rough", "sg_weight",
               "visibility", "normal_pred")


@pytest.mark.parametrize("compact", [True, False])
def test_render_view_assembles_the_host_frames_bit_for_bit(
        runners, monkeypatch, compact):
    """The device assembly gives what a numpy scatter of the same frame's
    outputs into full frames of the reference fills gives, value for
    value, dtype and shape."""
    from frame_assembly import capture_frames, host_assembly

    _, pr = runners
    data = pr._eval_data("train")
    dirs, ints = pr.trained_lights_for_view(data, 1)
    frames = capture_frames(monkeypatch)
    got = pr.render_view(data, 1, dirs, ints, tile=TILE, outputs=ALL_OUTPUTS,
                         compact=compact)
    h, w = data["img_res"]
    want = host_assembly(
        frames[0], data["surface_mask"][1].numpy().reshape(h, w) > 0,
        len(dirs), data["normals"][1].numpy(), compact)
    assert set(got) == set(want) == set(ALL_OUTPUTS) | {"mask",
                                                        "normal_values"}
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)


def test_render_view_result_is_not_overwritten_by_later_views(runners):
    """A result kept across later render_views of another view, of the
    same shapes (one set of lights), is unchanged and shares no memory
    with theirs."""
    _, pr = runners
    data = pr._eval_data("train")
    lights = pr.trained_lights_for_view(data, 0)
    kept = pr.render_view(data, 0, *lights, tile=TILE, outputs=ALL_OUTPUTS)
    before = {k: a.copy() for k, a in kept.items()}
    for _ in range(2):
        later = pr.render_view(data, 1, *lights, tile=TILE,
                               outputs=ALL_OUTPUTS)
        for k, a in later.items():
            assert not np.shares_memory(a, kept[k]), k
    for k, a in before.items():
        np.testing.assert_array_equal(kept[k], a, err_msg=k)


def test_render_view_counts_its_read_back_bytes(runners, tmp_path):
    """Under a trace, d2h_bytes counts the whole frame that render_view
    returns (every output at full-frame shape, the normals, the mask);
    on the CPU nothing goes through page-locked memory."""
    from psnerf_torch.utils import profiling

    _, pr = runners
    data = pr._eval_data("test")
    dirs, ints = pr.trained_lights_for_view(data, 0)
    with profiling.trace(str(tmp_path)):
        r = pr.render_view(data, 0, dirs, ints, tile=TILE,
                           outputs=ALL_OUTPUTS, compact=True)
    counted = profiling.counters()
    assert counted["d2h_bytes"] == sum(a.nbytes for a in r.values())
    assert counted["d2h_pinned_bytes"] == 0
