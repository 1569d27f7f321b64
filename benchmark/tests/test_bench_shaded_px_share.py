"""shaded_px_share.s2_train: the share of the drawn pixels a stage-2 step
shades, from the program's counters stage2.shaded_px and stage2.drawn_px,
on a toy traced run of the cell on the CPU and on counts made by hand;
nothing without the counters."""

import types

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from toy import toy

torch.set_num_threads(2)
NAME = "shaded_px_share.s2_train"
read = harness.metric_reader(NAME)
profiling = pytest.importorskip("psnerf_torch.utils.profiling")


def _run(units):
    return types.SimpleNamespace(window={"attempted": units})


def test_toy_traced_run_reads_shaded_over_drawn():
    cell = "s2_train_bear"
    res, checks = run_cell(cell, 3_141_592_653, 0.3, 1, device="cpu",
                           overrides=toy(cell))
    assert res["correct"], checks
    c = profiling.counters()
    want = 100.0 * c["stage2.shaded_px"] / c["stage2.drawn_px"]
    assert 0 < want < 100          # the toy object covers part of the frame
    assert res["metrics"][NAME] == {"value": pytest.approx(want),
                                    "unit": "%"}


def test_counts_by_hand(tmp_path):
    with profiling.trace(str(tmp_path)):
        for _ in range(4):
            profiling.count("stage2.drawn_px", 768)
            profiling.count("stage2.shaded_px", 160)
    assert read(_run(4)) == pytest.approx(100.0 * 160 / 768)


def test_nothing_without_the_counters(tmp_path):
    with profiling.trace(str(tmp_path)):
        profiling.count("d2h_bytes", 12)
    assert read(_run(3)) is None
    assert read(_run(0)) is None
