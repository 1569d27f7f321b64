"""The port's end-to-end pipeline on the CPU, the twin of
tests/test_pipeline.py on the same synthetic sphere scene and toy shapes:
stage-1 training -> shape export -> mesh extraction and Chamfer -> the
guided export -> stage-2 joint training -> eval outputs -> metrics ->
relighting and a material edit. Held by outcome, at test_pipeline.py's
gates: mask IoU > 0.7 (:83), the median surface radius within 0.08 of 0.6
(:104), Chamfer < 0.05 to the analytic sphere (:126), guided vis_plus
agreement > 0.93 with the train-light visibility bit for bit (:129-157),
stage-2 PSNR > 14 and normal MAE < 15 on the trained stage-1 export
(:214-215), the envmap and edit outputs written (:218-229).
"""

import json
import os

import numpy as np
import pytest
import torch

from psnerf_torch.config import Stage1Config, Stage2Config
from psnerf_torch.data.synthetic import generate_synthetic_scene
from psnerf_torch.fields.occupancy import OccFieldConfig
from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.render.unisurf import UnisurfConfig
from psnerf_torch.train.losses import Stage1LossWeights, Stage2LossWeights
from psnerf_torch.train.stage1 import Stage1TrainConfig
from psnerf_torch.train.stage2 import Stage2TrainConfig

torch.set_num_threads(1)
HW = (32, 32)
N_LIGHTS = 6
RADIUS = 0.6


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipeline_scene"))
    generate_synthetic_scene(d, n_views=3, n_test=1, n_lights=N_LIGHTS, hw=HW,
                             radius=RADIUS, focal=40.0)
    return d


@pytest.fixture(scope="module")
def stage1_cfg(scene_dir):
    return Stage1Config(
        field=OccFieldConfig(num_layers=6, hidden_dim=128, feat_size=128,
                             octaves_pe=4, octaves_pe_views=2),
        render=UnisurfConfig(near=1.2, far=5.0, radius=1.2,
                             interval_start=0.6, interval_end=0.05,
                             interval_decay=1e-3, num_points_in=24,
                             num_points_out=8, ray_marching_steps=64),
        train=Stage1TrainConfig(learning_rate=1e-3, milestone_iters=(),
                                n_training_points=256, normal_after=0,
                                weights=Stage1LossWeights(
                                    use_mask_loss=True, lambda_mask=1.0)),
        data_dir=scene_dir,
        inten_normalize=None,
        checkpoint_every=100000, backup_every=100000,
    )


@pytest.fixture(scope="module")
def trained_stage1(stage1_cfg, tmp_path_factory):
    from psnerf_torch.runners.stage1 import Stage1Runner

    wd = str(tmp_path_factory.mktemp("stage1_wd"))
    runner = Stage1Runner(stage1_cfg, wd, resume=False, device="cpu")
    losses = []
    runner.train(400, log_every=50, ckpt_every=100000,
                 on_log=lambda it, t: losses.append(t["loss"]))
    assert losses[-1] < losses[0]
    return runner


def test_stage1_learns_sphere(trained_stage1, tmp_path_factory):
    r = trained_stage1.render_view(0, tile=1024)
    strip_path = str(tmp_path_factory.mktemp("vis") / "strip.png")
    strip = trained_stage1.render_visdata(strip_path, views=(0,), tile=1024)
    assert os.path.exists(strip_path)
    assert strip.shape[1] == strip.shape[0] * 8  # 8 panels

    gt_mask = trained_stage1.data["masks"][0].numpy() > 0.5
    pred = r["mask"]
    iou = (pred & gt_mask).sum() / max((pred | gt_mask).sum(), 1)
    assert iou > 0.7, f"mask IoU {iou:.3f}"


@pytest.fixture(scope="module")
def export_dir(trained_stage1, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("exports"))
    trained_stage1.shape_extract(d, visibility=True, vis_plus=True,
                                 vis_plus_num=8, tile=1024, n_steps=64)
    return d


def test_stage1_exports_and_mesh(trained_stage1, export_dir):
    from psnerf_torch.mesh.chamfer import chamfer_distance
    from psnerf_torch.mesh.extractor import extract_mesh, make_field_value_fn
    from psnerf_torch.mesh.meshio import save_ply

    pts = np.load(os.path.join(export_dir, "points", "view_01.npy"))
    mask = np.load(os.path.join(export_dir, "mask", "view_01.npy"))
    vis = np.load(os.path.join(export_dir, "visibility", "view_01.npy"))
    assert pts.shape == (*HW, 3) and mask.shape == HW
    assert vis.shape == (N_LIGHTS, *HW)
    radii = np.linalg.norm(pts[mask], axis=-1)
    assert abs(np.median(radii) - RADIUS) < 0.08
    with open(os.path.join(export_dir, "vis_plus", "light_dir.json")) as f:
        vp = json.load(f)
    assert len(vp["view_01"]) == 8

    mesh_path = os.path.join(export_dir, "mesh.ply")
    value_fn = make_field_value_fn(trained_stage1.field,
                                   trained_stage1.cfg.field)
    verts, tris = extract_mesh(value_fn, resolution0=16, upsampling_steps=1,
                               points_batch=8192)
    save_ply(mesh_path, verts, tris)
    assert os.path.exists(mesh_path)
    v_gt, t_gt = extract_mesh(
        lambda p: RADIUS - np.linalg.norm(p, axis=-1),
        resolution0=16, upsampling_steps=1)
    cd = chamfer_distance(verts, tris, v_gt, t_gt, num_samples=2000)
    assert cd < 0.05, f"chamfer {cd:.4f}"


def test_stage1_guided_export_agrees(trained_stage1, export_dir,
                                     tmp_path_factory):
    """The guided vis_plus export (grid-shrunk march intervals, 16 steps by
    default, guide_res 32) binary-agrees with the faithful export on the
    surface pixels and keeps the faithful train-light visibility bit for
    bit."""
    d = str(tmp_path_factory.mktemp("exports_guided"))
    timings = trained_stage1.shape_extract(
        d, visibility=True, vis_plus=True, vis_plus_num=8, tile=1024,
        n_steps=64, vis_plus_guided=True, guide_res=32)
    assert timings["guide_s"] > 0
    for name in ("view_01", "view_02"):
        base_vis = np.load(os.path.join(export_dir, "visibility",
                                        name + ".npy"))
        got_vis = np.load(os.path.join(d, "visibility", name + ".npy"))
        np.testing.assert_array_equal(got_vis, base_vis)
        mask = np.load(os.path.join(export_dir, "mask", name + ".npy"))
        base_vp = np.load(os.path.join(export_dir, "vis_plus",
                                       name + ".npy"))[:, mask]
        got_vp = np.load(os.path.join(d, "vis_plus", name + ".npy"))[:, mask]
        agree = ((base_vp > 0.5) == (got_vp > 0.5)).mean()
        assert agree > 0.93, f"{name}: guided vis_plus agreement {agree:.4f}"


@pytest.fixture(scope="module")
def stage2_cfg(scene_dir, export_dir):
    return Stage2Config(
        net=PSNetConfig(mlp_width=48, sg_mlp_width=16, normal_mlp_width=48,
                        vis_mlp_width=48, vis_mlp_depth=4, vis_mlp_skip_at=2,
                        n_freqs_xyz=6, normal_n_freqs_xyz=6,
                        light_int=1.2, xyz_jitter_std=0.01),
        train=Stage2TrainConfig(
            sg_learning_rate=1e-3, light_learning_rate=5e-4,
            train_order=True, warmup_iters=40,
            weights=Stage2LossWeights(),
        ),
        data_dir=scene_dir,
        stage1_shape_path=export_dir,
        inten_normalize=None,
        light_bs=4, vis_train_num=4,
        num_pixels=256, train_all_pixels=False,
        ckpt_freq=100000,
    )


@pytest.fixture(scope="module")
def trained_stage2(stage2_cfg, tmp_path_factory):
    from psnerf_torch.runners.stage2 import Stage2Runner

    wd = str(tmp_path_factory.mktemp("stage2_wd"))
    runner = Stage2Runner(stage2_cfg, wd, resume=False, device="cpu")
    logs = []
    runner.train(160, log_every=40, ckpt_every=100000,
                 on_log=lambda it, t: logs.append(t))
    # past warm-up the rgb loss must be real and improving
    assert logs[-1]["sg_rgb_loss"] < 0.2
    return runner


def test_stage2_eval_and_metrics(trained_stage2, scene_dir, tmp_path_factory):
    from psnerf_torch.eval.evaluation import evaluate_outputs

    out = str(tmp_path_factory.mktemp("test_out"))
    trained_stage2.evaluate(out, split="test", tile=256)
    assert os.path.exists(os.path.join(out, "rgb", "img", "view_04", "001.png"))
    assert os.path.exists(os.path.join(out, "mask", "img", "view_04.png"))
    assert os.path.exists(os.path.join(out, "normal", "npy", "view_04.npy"))

    stats = trained_stage2.plot_to_disk(str(tmp_path_factory.mktemp("plots")
                                            / "p.png"), tile=256)
    assert "train_psnr" in stats and "test_psnr" in stats

    res = evaluate_outputs(scene_dir, out)
    assert "psnr" in res and "ssim" in res and "normal_mae" in res
    assert res["psnr"] > 14, res
    assert res["normal_mae"] < 15, res


def test_stage2_envmap_and_edit(trained_stage2, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("relight"))
    env = np.full((16, 32, 3), 0.02, np.float32)
    env[4:8, 10:16] = [1.0, 0.8, 0.5]  # a warm window
    trained_stage2.render_envmap(out, env, tile=256)
    assert os.path.exists(os.path.join(out, "rgb", "img", "view_04.png"))

    out2 = str(tmp_path_factory.mktemp("edit"))
    trained_stage2.edit_material(out2, albedo_new=np.asarray([0.8, 0.1, 0.1]),
                                 basis_new=2)
    assert os.path.exists(os.path.join(out2, "rgb", "img", "view_04", "001.png"))
