"""The lights SDPS-Net hands on are part of what decides s0_sdps_bear's
`correct`: on the CPU at the cell's toy size, a run whose light decoding
is off by one bin, or whose lights are the previous view's, comes out not
correct, while LCNet's logits and NENet's normals (fed those same lights)
agree with the reference."""

import pytest
import torch

from benchmark.run import run_cell
from toy import toy

torch.set_num_threads(2)
CELL = "s0_sdps_bear"


def run():
    return run_cell(CELL, 2_600_000_077, 0.3, 0, device="cpu",
                    overrides=toy(CELL))


def test_sound_lights_agree():
    res, checks = run()
    assert res["correct"], checks
    assert checks["light_dir_err"]["value"] < 1e-6
    assert checks["light_int_err"]["value"] < 1e-6


@pytest.mark.parametrize("head", ["dirs", "intens"])
def test_decoding_off_by_one_bin_fails(monkeypatch, head):
    import psnerf_torch.preprocess.sdps as sdps

    if head == "dirs":
        decode = sdps.spherical_class_to_dirs
        monkeypatch.setattr(sdps, "spherical_class_to_dirs",
                            lambda x, y, n=36: decode((x + 1) % n, y, n))
        key = "light_dir_err"
    else:
        decode = sdps.class_to_light_ints
        monkeypatch.setattr(sdps, "class_to_light_ints",
                            lambda c, n=20: decode((c + 1) % n, n))
        key = "light_int_err"
    res, checks = run()
    assert not res["correct"]
    assert checks[key]["value"] > 10 * checks[key]["limit"]
    assert checks["lcnet_logit_rel"]["value"] <= \
        checks["lcnet_logit_rel"]["limit"]


def test_previous_views_lights_fail(monkeypatch):
    import psnerf_torch.preprocess.runner as runner

    view, last = runner.sdps_view, {}

    def stale(*a, **kw):
        r = view(*a, **kw)
        prev = last.get("r", r)
        last["r"] = dict(r)
        return dict(r, dirs=prev["dirs"], intens=prev["intens"])

    monkeypatch.setattr(runner, "sdps_view", stale)
    res, checks = run()
    assert not res["correct"]
    assert max(checks["light_dir_err"]["value"],
               checks["light_int_err"]["value"]) > 1e-3
