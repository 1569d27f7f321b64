"""The control fails: the reference one precision lower (float32 products
in TF32, the bf16 trunks' operands in fp8), put in the program's place,
reads above at least one of each cell's limits. On the card, at the
cell's widths with a smaller scene and batch (the full-size readings are
PERF.md's); skips without a card."""

import pytest
import torch

from benchmark import harness
from benchmark.calibrate import calibrate

SMALL_SCENE = {"hw": [128, 153], "focal_px": 1825.0}
SMALL = {
    "s1_train_bear": {"cfg": {"training": {"n_training_points": 512},
                              "dataset_shape": SMALL_SCENE}},
    "s2_train_bear": {"cfg": {"dataset_shape": SMALL_SCENE}},
    "s2_eval_bear": {"cfg": {"dataset_shape": SMALL_SCENE},
                     "params": {"pick_from": 2, "pixels": 512}},
    "s1_export_bear": {"cfg": {"dataset_shape": SMALL_SCENE},
                       "params": {"vis_plus_num": 32, "pixels": 2048,
                                  "vis_pixels": 64}},
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows, _ = calibrate(cell, [17], 1, 1.5, overrides=SMALL[cell])
    limits = harness.load_cell(cell)["limits"]
    prog = next(r for r in rows if r["variant"] == "program")["numbers"]
    ctrl = next(r for r in rows if r["variant"] == "control")["numbers"]
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl
