"""The comparison that decides `correct` fails a broken program: each
cell's run on the CPU, the harness's look for a card skipped, with the
timed path broken underneath, comes out not correct. Faults: a training
step that returns its state unchanged; half of each batch left out, the
mean taken over the rest; an answer altered where it is produced. (The
cells run on one card: there is no exchange between cards to leave out.)
"""

import pytest
import torch

from benchmark.run import run_cell
from toy import toy

torch.set_num_threads(2)


def run(cell):
    return run_cell(cell, 1_234_567_891, 0.3, 0, device="cpu",
                    overrides=toy(cell))


def no_update(monkeypatch, module):
    monkeypatch.setattr(module, "adam_update", lambda *a, **kw: None)


def half_batch(monkeypatch, runners, name, n_key, fields, light_fields):
    """Wrap the runner module's step factory: the step sees every other
    row of each batch and its jitter draws. (Not the first half: the
    stage-2 sampler puts the object's pixels first, and where a batch holds
    every pixel of a view its first half holds all of them.)"""
    make = getattr(runners, name)

    def wrapped(*a, **kw):
        init, step = make(*a, **kw)

        def half(*args, **kwargs):
            args = list(args)
            batch, noise = dict(args[2]), dict(args[4])
            half = slice(0, batch[n_key].shape[0], 2)
            for k in fields:
                if k in batch:
                    batch[k] = batch[k][half]
            for k in light_fields:
                if k in batch:
                    batch[k] = batch[k][:, half]
            for k, v in noise.items():
                if v.ndim:
                    noise[k] = v[half]
            args[2], args[4] = batch, noise
            return step(*args, **kwargs)

        return init, half

    monkeypatch.setattr(runners, name, wrapped)


def test_stage1_state_unchanged(monkeypatch):
    import psnerf_torch.train.stage1 as s1
    no_update(monkeypatch, s1)
    res, checks = run("s1_train_bear")
    assert not res["correct"]
    assert checks["change_norm_gap"]["value"] >= 0.99


def test_stage1_half_batch(monkeypatch):
    import psnerf_torch.runners.stage1 as r1
    half_batch(monkeypatch, r1, "make_stage1_train_step", "pixels",
               ("pixels", "rgb_gt", "mask_gt", "mask_valid", "normal_gt",
                "norm_mask"), ())
    res, checks = run("s1_train_bear")
    assert not res["correct"], checks


def test_stage2_state_unchanged(monkeypatch):
    import psnerf_torch.train.stage2 as s2
    no_update(monkeypatch, s2)
    res, checks = run("s2_train_bear")
    assert not res["correct"]
    assert checks["change_norm_gap"]["value"] >= 0.99


def test_stage2_half_batch(monkeypatch):
    import psnerf_torch.runners.stage2 as r2
    half_batch(monkeypatch, r2, "make_stage2_train_step", "uv",
               ("uv", "object_mask", "points", "normal", "surface_mask"),
               ("rgb_gt", "visibility", "vis_train_gt"))
    res, checks = run("s2_train_bear")
    assert not res["correct"], checks


@pytest.mark.parametrize("output", ["rgb", "visibility", "albedo"])
def test_eval_answer_altered(monkeypatch, output):
    from psnerf_torch.runners.stage2 import Stage2Runner
    render = Stage2Runner.render_view

    def altered(self, *a, **kw):
        r = render(self, *a, **kw)
        r[output] = r[output] + 0.01
        return r

    monkeypatch.setattr(Stage2Runner, "render_view", altered)
    res, checks = run("s2_eval_bear")
    assert not res["correct"]
    assert checks[f"{output}_err"]["value"] > checks[f"{output}_err"][
        "limit"]


@pytest.mark.parametrize("what", ["points", "visibility"])
def test_export_answer_altered(monkeypatch, what):
    import psnerf_torch.runners.stage1 as r1
    if what == "points":
        march = r1.render_shape_extract

        def altered(*a, **kw):
            out = march(*a, **kw)
            out["points"] = out["points"] + 0.01
            return out

        monkeypatch.setattr(r1, "render_shape_extract", altered)
    else:
        vis = r1.light_visibility
        monkeypatch.setattr(r1, "light_visibility",
                            lambda *a, **kw: vis(*a, **kw) * 0.9)
    res, checks = run("s1_export_bear")
    assert not res["correct"], checks
