"""The port's command line end to end on the CPU: the twin of
tests/test_cli.py:163-209, on the same 32x32 scene and the same configs
(torch_helpers.CLI_STAGE1_YAML / CLI_STAGE2_CONF), each command with
`--device cpu`: stage1-train -> shape-extract --vis_plus -> extract-mesh
-> stage2-train -> stage2-eval (plain, --render_envmap, --edit_albedo
--edit_specular) -> evaluation (a finite PSNR) -> chamfer, with the same
file contract. Also: plot_metrics draws the stage-1 metrics into a PNG of
one panel per scalar; PhaseTimer and trace run on the CPU; the MetricLogger
mirrors to TensorBoard and keeps its JSONL when the writer is missing; the
subcommands not ported yet raise NotImplementedError; `--device` defaults
to the card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from psnerf_torch.cli.main import main
from psnerf_torch.data.synthetic import generate_synthetic_scene
from psnerf_torch.train.checkpoints import load_checkpoint
from torch_helpers import CLI_STAGE1_YAML, CLI_STAGE2_CONF

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
    ["light-avg", "--obj", "x"],
    ["convert-ckpt", "--stage", "stage1", "--model", "m.pt", "--out", "o"],
    ["sdps-preprocess", "--obj", "x", "--lcnet", "a", "--nenet", "b"],
    ["stage1-train", "c.yaml", "--mesh-devices", "2", *CPU],
    ["stage2-train", "--conf", "c.conf", "--mesh-devices", "2", *CPU],
    ["evaluation", "--data_path", "d", "--test_out_path", "o",
     "--lpips_weights", "w.npz"],
])
def test_unported_subcommands_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        main(argv)


def test_device_defaults_to_the_card(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(workspace)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["stage1-eval", f"{root}/s1.yaml", "--workdir",
              f"{root}/nowhere"])


def test_phase_timer_and_trace_on_the_cpu(tmp_path):
    from psnerf_torch.utils.profiling import PhaseTimer, trace

    timer = PhaseTimer()
    x = torch.ones(64, 64)
    with trace(str(tmp_path / "trace")) as prof:
        y = x @ x
        timer.mark("matmul", {"out": [y]})
        timer.mark("none")
    assert prof is not None
    assert any(e.key for e in prof.key_averages())
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    s = timer.summary()
    assert set(s) == {"matmul", "none"} and all(v >= 0 for v in s.values())
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
