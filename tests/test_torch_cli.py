"""The port's command line end to end on the CPU: the twin of
tests/test_cli.py:163-209, on the same 32x32 scene and the same configs
(torch_helpers.CLI_STAGE1_YAML / CLI_STAGE2_CONF), each command with
`--device cpu`: stage1-train -> shape-extract --vis_plus -> extract-mesh
-> stage2-train -> stage2-eval (plain, --render_envmap, --edit_albedo
--edit_specular) -> evaluation (a finite PSNR) -> chamfer, with the same
file contract. Also: plot_metrics draws the stage-1 metrics into a PNG of
one panel per scalar; trace writes its spans beside its Chrome trace; the
MetricLogger mirrors to TensorBoard and keeps its JSONL when the writer is
missing;
stage1-train and stage2-train with `--mesh-devices 2` train on two CPU
ranks as a fresh process (and stage1-train as two torchrun processes)
and write the checkpoint of a single-device run;
`--device` defaults to the card. The preprocessing commands:
sdps-preprocess from a converted .npz and from a reference .pth.tar of
each net (convert-ckpt writing the npz),
light-avg as the JAX CLI's, evaluation --lpips_weights on the workflow's
output; sdps-preprocess and LPIPS raise without CUDA unless `--device
cpu` is given.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from psnerf_torch.cli.main import main
from psnerf_torch.data.synthetic import generate_synthetic_scene
from psnerf_torch.train.checkpoints import load_checkpoint
from torch_helpers import (CLI_STAGE1_YAML, CLI_STAGE2_CONF,
                           random_lpips_state_dict, sdps_reference_state_dict)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_ws")
    scene = root / "scene"
    generate_synthetic_scene(str(scene), n_views=2, n_test=1, n_lights=4,
                             hw=(32, 32), radius=0.6, focal=50.0)
    kw = dict(scene=scene, root=root)
    (root / "s1.yaml").write_text(CLI_STAGE1_YAML.format(**kw))
    (root / "s2.conf").write_text(CLI_STAGE2_CONF.format(**kw))
    return root


@pytest.fixture(scope="module")
def workflow(workspace):
    """tests/test_cli.py's workflow through the port's CLI; returns the
    evaluation's printed JSON."""
    import contextlib
    import io

    root = str(workspace)
    scene = os.path.join(root, "scene")
    main(["stage1-train", f"{root}/s1.yaml", "--max-iters", "60",
          "--workdir", f"{root}/s1_out", *CPU])
    main(["shape-extract", f"{root}/s1.yaml", "--workdir", f"{root}/s1_out",
          "--vis_plus", "--vis_plus_num", "4", *CPU])
    main(["extract-mesh", f"{root}/s1.yaml", "--workdir", f"{root}/s1_out",
          "--resolution0", "12", "--upsampling", "1", *CPU])
    main(["stage2-train", "--conf", f"{root}/s2.conf", "--max-iters", "50",
          "--workdir", f"{root}/s2_out", *CPU])
    main(["stage2-eval", "--conf", f"{root}/s2.conf",
          "--workdir", f"{root}/s2_out", "--out", f"{root}/test_out", *CPU])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["evaluation", "--data_path", scene,
              "--test_out_path", f"{root}/test_out"])
    envmap = os.path.join(root, "env.npy")
    env = np.full((16, 32, 3), 0.002, np.float32)
    env[4:8, 10:16] = 0.03
    np.save(envmap, env)
    main(["stage2-eval", "--conf", f"{root}/s2.conf",
          "--workdir", f"{root}/s2_out", "--out", f"{root}/relight",
          "--render_envmap", "--envmap_path", envmap, *CPU])
    main(["stage2-eval", "--conf", f"{root}/s2.conf",
          "--workdir", f"{root}/s2_out", "--out", f"{root}/edit",
          "--edit_albedo", "--color", "#cc2010", "--edit_specular",
          "--basis", "3", *CPU])
    return json.loads("{" + out.getvalue().rsplit("{", 1)[1])


def test_cli_full_workflow(workspace, workflow):
    root = str(workspace)
    assert os.path.exists(f"{root}/s1_out/checkpoints/model.npz")
    assert os.path.exists(f"{root}/s1_out/shape_out/points/view_01.npy")
    assert os.path.exists(f"{root}/s1_out/shape_out/vis_plus/light_dir.json")
    assert os.path.exists(f"{root}/s1_out/mesh.ply")
    assert os.path.exists(f"{root}/s2_out/checkpoints/model.npz")
    assert os.path.exists(f"{root}/test_out/rgb/img/view_03/001.png")
    assert "psnr" in workflow and np.isfinite(workflow["psnr"])
    assert os.path.exists(f"{root}/relight/rgb/img/view_03.png")
    assert os.path.exists(f"{root}/relight/light_probe.png")
    assert os.path.exists(f"{root}/edit/rgb/img/view_03/001.png")
    # the checkpoints hold the iterations the commands asked for
    for wd, it in (("s1_out", 60), ("s2_out", 50)):
        _, scalars = load_checkpoint(f"{root}/{wd}/checkpoints/model.npz")
        assert scalars["it"] == it


def test_stage1_eval_and_chamfer(workspace, workflow, capsys):
    root = str(workspace)
    main(["stage1-eval", f"{root}/s1.yaml", "--workdir", f"{root}/s1_out",
          *CPU])
    with open(f"{root}/s1_out/eval/metrics.json") as f:
        metrics = json.load(f)
    assert '"psnr"' in capsys.readouterr().out
    assert metrics and all(np.isfinite(m["psnr"]) for m in metrics)
    assert os.path.exists(f"{root}/s1_out/eval/rgb/view_03.png")
    main(["chamfer", "--mesh_gt", f"{root}/s1_out/mesh.ply",
          "--mesh_pred", f"{root}/s1_out/mesh.ply", "--num_samples", "500"])
    assert "Chamfer Distance (mm):  0.00" in capsys.readouterr().out


def test_plot_metrics_draws_one_panel_per_scalar(workspace, workflow):
    from PIL import Image

    from psnerf_torch.cli import plot_metrics

    root = str(workspace)
    path = f"{root}/s1_out/metrics.jsonl"
    series = plot_metrics.read_series(path)
    assert "loss" in series and len(series["loss"][0]) >= 1
    plot_metrics.main([path])
    img = Image.open(path.replace(".jsonl", ".png"))
    cols = min(plot_metrics.COLS, len(series))
    rows = -(-len(series) // cols)
    assert img.size == (cols * plot_metrics.PANEL_W,
                        rows * plot_metrics.PANEL_H)
    px = np.asarray(img.convert("RGB"))
    # every panel has a frame and ink inside it; the unused cells are blank
    for i in range(rows * cols):
        y0 = (i // cols) * plot_metrics.PANEL_H
        x0 = (i % cols) * plot_metrics.PANEL_W
        cell = px[y0:y0 + plot_metrics.PANEL_H, x0:x0 + plot_metrics.PANEL_W]
        assert (cell < 128).any() == (i < len(series)), i


def test_python_m_entry_point(workspace, workflow):
    """`python -m psnerf_torch.cli.main` in a fresh process."""
    root = str(workspace)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "psnerf_torch.cli.main", "chamfer",
         "--mesh_gt", f"{root}/s1_out/mesh.ply", "--mesh_pred",
         f"{root}/s1_out/mesh.ply", "--num_samples", "200"],
        capture_output=True, text=True, timeout=120, env=env, cwd=root)
    assert res.returncode == 0, res.stderr
    assert "Chamfer Distance (mm):" in res.stdout


@pytest.mark.parametrize("argv", [
    ["stage1-train", "{root}/s1.yaml", "--max-iters", "5"],
    ["stage2-train", "--conf", "{root}/s2.conf", "--max-iters", "5"],
])
def test_unported_subcommands_raise(workspace, workflow, tmp_path, argv):
    """`--mesh-devices 2` (once unported, now two data-parallel CPU ranks)
    exits 0 as `python -m psnerf_torch.cli.main`, and its checkpoint holds
    the params of a single-device run of the same steps (rtol 2e-4, atol
    2e-6, the runners' mesh bar); stage 2 trains on the workflow's
    export."""
    argv = [a.format(root=workspace) for a in argv] + CPU
    main(argv + ["--workdir", str(tmp_path / "single")])
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "psnerf_torch.cli.main", *argv,
         "--workdir", str(tmp_path / "mesh"), "--mesh-devices", "2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(workspace))
    assert res.returncode == 0, res.stderr[-4000:]
    single, s_single = load_checkpoint(
        str(tmp_path / "single" / "checkpoints" / "model.npz"))
    mesh, s_mesh = load_checkpoint(
        str(tmp_path / "mesh" / "checkpoints" / "model.npz"))
    assert s_mesh["it"] == s_single["it"] == 5
    keys = [k for k in single if k.startswith("params/")]
    assert keys and sorted(keys) == sorted(
        k for k in mesh if k.startswith("params/"))
    for k in keys:
        np.testing.assert_allclose(mesh[k], single[k], rtol=2e-4,
                                   atol=2e-6, err_msg=k)


def test_mesh_devices_under_torchrun(workspace, tmp_path):
    """Under torchrun each process is one rank already: `--mesh-devices 2`
    builds its mesh from torchrun's environment (env://, gloo on the CPU)
    instead of spawning, and writes the checkpoint of a one-process run
    (rtol 2e-4, atol 2e-6)."""
    argv = ["stage1-train", f"{workspace}/s1.yaml", "--max-iters", "3",
            *CPU]
    main(argv + ["--workdir", str(tmp_path / "single")])
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "psnerf_torch.cli.main", *argv,
         "--workdir", str(tmp_path / "mesh"), "--mesh-devices", "2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(workspace))
    assert res.returncode == 0, res.stderr[-4000:]
    single, _ = load_checkpoint(
        str(tmp_path / "single" / "checkpoints" / "model.npz"))
    mesh, scalars = load_checkpoint(
        str(tmp_path / "mesh" / "checkpoints" / "model.npz"))
    assert scalars["it"] == 3
    for k in (k for k in single if k.startswith("params/")):
        np.testing.assert_allclose(mesh[k], single[k], rtol=2e-4,
                                   atol=2e-6, err_msg=k)


def test_device_defaults_to_the_card(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(workspace)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["stage1-eval", f"{root}/s1.yaml", "--workdir",
              f"{root}/nowhere"])


def test_phase_timer_and_trace_on_the_cpu(tmp_path):
    """trace() writes the Chrome trace and the session's spans beside it."""
    from psnerf_torch.utils.profiling import span, trace

    x = torch.ones(64, 64)
    with trace(str(tmp_path / "trace")) as prof:
        with span("cli.matmul") as sp:
            y = x @ x
    assert prof is not None and y.shape == (64, 64)
    assert any(e.key == "cli.matmul" for e in prof.key_averages())
    files = sorted(os.listdir(tmp_path / "trace"))
    assert len(files) == 2 and files[0] == f"spans_{os.getpid()}.jsonl"
    assert files[1].startswith("trace_") and files[1].endswith(".json")
    with open(tmp_path / "trace" / files[1]) as f:
        assert "traceEvents" in json.load(f)
    with open(tmp_path / "trace" / files[0]) as f:
        lines = [json.loads(line) for line in f]
    assert lines[-1] == {"counters": {}}
    (rec,) = lines[:-1]
    assert rec["name"] == "cli.matmul" and rec["id"] == sp.id
    assert rec["cause"] is None and rec["root"] == sp.id
    assert rec["end_ns"] - rec["start_ns"] == sp.end_ns - sp.start_ns > 0
    with trace(None) as nothing:
        assert nothing is None


def test_metric_logger_tensorboard_mirror(tmp_path, monkeypatch, capsys):
    import builtins

    from psnerf_torch.train.logging import MetricLogger

    log = MetricLogger(str(tmp_path / "a" / "m.jsonl"),
                       tb_dir=str(tmp_path / "tb"))
    log.log(1, {"loss": 0.5})
    log.close()
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "tb"))
    real_import = builtins.__import__

    def no_tensorboard(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    monkeypatch.setenv("PSNERF_TENSORBOARD", "1")
    log = MetricLogger(str(tmp_path / "b" / "m.jsonl"))
    log.log(2, {"loss": 0.25, "skip": None})
    log.close()
    assert "tensorboard unavailable" in capsys.readouterr().out
    with open(tmp_path / "b" / "m.jsonl") as f:
        rec = json.loads(f.read())
    assert rec["it"] == 2 and rec["loss"] == 0.25 and "skip" not in rec


def _sdps_checkpoints(root):
    """Reference-layout LCNet and NENet .pth.tar files from seed 0, and
    their npz conversions by convert-ckpt; returns {(kind, fmt): path}."""
    from psnerf_torch.preprocess import sdps
    from psnerf_torch.train.checkpoints import flatten_tree

    gen = torch.Generator().manual_seed(0)
    paths = {}
    for kind, make in (("lcnet", sdps.LCNet), ("nenet", sdps.NENet)):
        net = make(generator=gen, device="cpu")
        tar = os.path.join(root, f"{kind}.pth.tar")
        torch.save({"state_dict": sdps_reference_state_dict(
            flatten_tree(net), kind)}, tar)
        npz = os.path.join(root, f"{kind}.npz")
        main(["convert-ckpt", "--stage", kind, "--model", tar, "--out", npz])
        paths[kind, "tar"], paths[kind, "npz"] = tar, npz
    return paths


def test_sdps_preprocess_from_npz_and_pth_tar(tmp_path):
    """sdps-preprocess with LCNet from its npz and NENet from its .pth.tar,
    and the other way round: the same files as run_sdps on the nets."""
    from psnerf_torch.preprocess.runner import run_sdps
    from psnerf_torch.preprocess.sdps import load_sdps_net

    ckpt = _sdps_checkpoints(str(tmp_path))
    scene = str(tmp_path / "scene")
    generate_synthetic_scene(scene, n_views=2, n_test=0, n_lights=4,
                             hw=(40, 40))
    ref = run_sdps(scene, load_sdps_net(ckpt["lcnet", "tar"], "lcnet", "cpu"),
                   load_sdps_net(ckpt["nenet", "tar"], "nenet", "cpu"),
                   out_dir=str(tmp_path / "ref"))
    for lc, ne in (("npz", "tar"), ("tar", "npz")):
        main(["sdps-preprocess", "--obj", scene, "--lcnet", ckpt["lcnet", lc],
              "--nenet", ckpt["nenet", ne], *CPU])
        out = os.path.join(scene, "sdps_out_l4")
        for rel in ("outnpy/view_01.npy", "outnpy/view_02.npy",
                    "light_direction_pred.npy", "light_intensity_pred.npy"):
            np.testing.assert_array_equal(np.load(os.path.join(out, rel)),
                                          np.load(os.path.join(ref, rel)))
        assert os.path.exists(os.path.join(out, "outimg", "view_02.png"))
        shutil.rmtree(out)


def test_sdps_preprocess_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = _sdps_checkpoints(str(tmp_path))
    argv = ["sdps-preprocess", "--obj", str(tmp_path / "nowhere"),
            "--lcnet", ckpt["lcnet", "npz"], "--nenet", ckpt["nenet", "tar"]]
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv)
    with pytest.raises(FileNotFoundError, match="params.json"):
        main(argv + CPU)          # past the device: no dataset there


@pytest.mark.parametrize("intnorm", [False, True])
def test_light_avg_matches_the_jax_cli(tmp_path, monkeypatch, intnorm):
    from PIL import Image

    from psnerf_tpu.cli import main as jcli

    monkeypatch.setattr("psnerf_tpu.utils.profiling.enable_compilation_cache",
                        lambda *a, **k: None)
    src = tmp_path / "src"
    generate_synthetic_scene(str(src), n_views=2, n_test=0, n_lights=4,
                             hw=(20, 24))
    with open(src / "params.json") as f:
        para = json.load(f)
    para["light_intensity"] = np.random.default_rng(0).uniform(
        0.5, 1.5, (4, 3)).tolist()
    with open(src / "params.json", "w") as f:
        json.dump(para, f)
    flag = ["--intnorm"] if intnorm else []
    for name, cli in (("port", main), ("jax", jcli.main)):
        shutil.copytree(src, tmp_path / name)
        cli(["light-avg", "--obj", str(tmp_path / name), *flag])
    sub = "img_intnorm_gt" if intnorm else "img"
    files = sorted(Path(tmp_path / "jax" / sub).rglob("*.png"))
    assert len(files) == 10        # 8 light images and 2 averages
    for f in files:
        rel = f.relative_to(tmp_path / "jax")
        got = np.asarray(Image.open(tmp_path / "port" / rel))
        np.testing.assert_array_equal(got, np.asarray(Image.open(f)),
                                      err_msg=str(rel))


def test_evaluation_with_lpips_weights(workspace, workflow, tmp_path,
                                       monkeypatch, capsys):
    """evaluation --lpips_weights on the workflow's stage-2 output: a
    finite LPIPS, "computed", and the same psnr as without weights; the
    default device is the card, which a run without weights never needs."""
    sys.path.insert(0, str(ROOT / "tools"))
    from export_lpips_npz import export_from_state_dict

    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    npz = str(tmp_path / "lpips.npz")
    export_from_state_dict(random_lpips_state_dict(), npz)
    capsys.readouterr()
    root = str(workspace)
    argv = ["evaluation", "--data_path", os.path.join(root, "scene"),
            "--test_out_path", f"{root}/test_out"]
    main(argv + ["--lpips_weights", npz, *CPU])
    res = json.loads("{" + capsys.readouterr().out.rsplit("{", 1)[1])
    assert res["lpips_status"] == "computed" and np.isfinite(res["lpips"])
    assert res["psnr"] == workflow["psnr"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv + ["--lpips_weights", npz])
    main(argv)
    res = json.loads("{" + capsys.readouterr().out.rsplit("{", 1)[1])
    assert res["lpips"] is None and res["psnr"] == workflow["psnr"]
