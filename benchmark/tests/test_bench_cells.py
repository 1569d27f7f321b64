"""Each traffic kind once at a toy size on the CPU's plain routes: the
cell is found by name, its result has the contract's keys, and a sound
run is correct. A new workload file is picked up with no other file
edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from toy import toy

torch.set_num_threads(2)
BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def check_line(res, checks, cell, trace):
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(cell, trace)}
    assert set(res["metrics"]) <= want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(checks) == set(harness.load_cell(cell)["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    res, checks = run_cell(cell, 2_500_000_123, 0.3, 0, device="cpu",
                           overrides=toy(cell))
    check_line(res, checks, cell, False)
    assert {"setup_s"} < set(res["metrics"])
    assert res["correct"], checks


def test_traced_run_reports_per_layer_metrics():
    cell = "s2_eval_bear"
    res, checks = run_cell(cell, 7, 0.3, 1, device="cpu",
                           overrides=toy(cell))
    check_line(res, checks, cell, True)
    assert "host_assembly_ms.s2_eval" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_cell_finds_its_files():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"] and cell["chips"] == w["chips"]
        harness.traffic_module(cell["traffic"])
    for m in SPEC["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_a_new_workload_file_is_picked_up(tmp_path):
    """In a copy of the benchmark, a new cell is one new workload file and
    its BENCHMARK.json entry; no other file changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = dict(json.loads((BENCH / "workloads" / "s1_train_bear.json")
                          .read_text()))
    new["why"] = "a second stage-1 training cell from a later checkpoint"
    new["params"] = dict(new["params"], resume_it=7000)
    (tmp_path / "benchmark" / "workloads" / "s1_train_late.json").write_text(
        json.dumps(new))
    spec["workloads"].append({"name": "s1_train_late",
                              "config": "unisurf_bear",
                              "traffic": "train_stage1", "chips": 1,
                              "why": new["why"]})
    for m in spec["end_to_end"]:
        if "s1_train_bear" in m.get("workloads", []):
            m["workloads"].append("s1_train_late")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r},"
        f" {str(BENCH / 'tests')!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "import benchmark\n"
        f"assert benchmark.__file__.startswith({str(tmp_path)!r})\n"
        "from benchmark.run import run_cell\n"
        "from toy import toy\n"
        "res, checks = run_cell('s1_train_late', 11, 0.3, 0, device='cpu',"
        " overrides=toy('s1_train_bear'))\n"
        "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=600)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and "stage1_step_ms" in res["metrics"]


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]


def test_without_the_program_the_command_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]
