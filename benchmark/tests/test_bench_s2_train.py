"""The stage-2 training cell at its toy size on the CPU: a traced run
reports every per-layer metric the CPU can give (the device's memory peak
reads as nothing without a card; a CPU trace holds no device kernel), and
the optimizer's spans lie inside the steps'."""

import math

import torch

from benchmark import harness
from benchmark.run import run_cell
from toy import toy

torch.set_num_threads(2)
CELL = "s2_train_bear"
ON_THE_CPU = ("step_host_ms.s2_train", "optim_host_ms.s2_train",
              "launches_per_step.s2_train", "idle_share.s2_train",
              "mfu.s2_train")


def test_traced_run_reports_the_stage2_metrics():
    res, checks = run_cell(CELL, 2_718_281_829, 0.3, 1, device="cpu",
                           overrides=toy(CELL))
    assert res["correct"], checks
    names = {m["name"] for m in harness.cell_metrics(CELL, True)}
    assert set(ON_THE_CPU) | {"peak_mem_gb.s2_train"} == names
    for name in ON_THE_CPU:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    assert "peak_mem_gb.s2_train" not in res["metrics"]
    step = res["metrics"]["step_host_ms.s2_train"]["value"]
    assert 0 < res["metrics"]["optim_host_ms.s2_train"]["value"] < step
