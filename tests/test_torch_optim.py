"""The port's Adam (train/optim.py) and the host side of its multi-tensor
kernel (ops/adam.py), on the CPU:
  * CPU leaves take the plain route, whatever their gates: the counters
    read optim.fused_leaves 0 and optim.plain_leaves the leaves updated, and
    adam_update gives adam_update_plain's bits;
  * with the route faked to "cuda" and the launch recorded, the kernel's
    tables: float32 leaves in order, frozen leaves left out, leaves of
    another dtype on the plain loop, MAX_LEAVES leaves a call, the scalars'
    f32 bits; and an emulation of csrc/adam.cu's two launches over the
    recorded tables gives adam_update_plain's bits;
  * a float32 leaf there that the kernel cannot take (a gate that is not a
    row mask, an empty or non-contiguous operand, a step that is not int32,
    an lr given as a tensor) raises before anything is launched or moved;
  * a checkpoint of the optimizer state loads back unchanged, under the JAX
    package's keys.
The kernel itself runs on the card only: tests/test_torch_gpu.py holds it
against adam_update_plain bit for bit.
"""

import copy
import struct

import jax
import numpy as np
import pytest
import torch

from psnerf_tpu.fields.psnet import PSNetConfig as JCfg, init_psnet as jinit
from psnerf_tpu.train.optim import adam_init as jadam_init
from psnerf_tpu.train.stage2 import init_stage2_params as jinit_stage2
from psnerf_torch.fields.psnet import PSNetConfig, init_psnet
from psnerf_torch.ops import adam
from psnerf_torch.train import checkpoints as ck
from psnerf_torch.train import optim
from psnerf_torch.train.optim import (adam_init, adam_update,
                                      adam_update_plain,
                                      row_mask_from_indices)
from psnerf_torch.train.stage2 import init_stage2_params, model_params
from psnerf_torch.utils import profiling
from torch_helpers import flatten_jax, port_config

torch.set_num_threads(1)
# sizes of 1, 3 and 9 values, and sizes that are not a multiple of 4 or of
# the kernel's 1,024-value CTA
SHAPES = [(1,), (3,), (9,), (4, 3), (257,), (1025,), (33, 31), (2, 3, 5)]


def _leaves(shapes, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return {f"leaf/{i}": torch.randn(s, generator=gen).to(dtype)
            for i, s in enumerate(shapes)}


def _grads(params, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(p.shape, generator=gen).to(p.dtype)
            for k, p in params.items()}


def _counted(fn):
    """The counters of a new tracing session around fn()."""
    profiling.count("optim.fused_leaves", 0)    # off: the next session is new
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
        return profiling.counters()


def _assert_same_bits(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def _state_bits(params, state):
    out = {f"p/{k}": v.clone() for k, v in params.items()}
    for part in ("m", "v", "step"):
        out.update({f"{part}/{k}": v.clone() for k, v in state[part].items()})
    return out


def _gates(params, kind):
    names = list(params)
    if kind == "none":
        return None
    if kind == "host":      # stage 2's head gates: live, frozen, no gate
        return {k: (1.0, 0.0, 1)[i % 3] for i, k in enumerate(names)}
    # a row mask on every leaf with rows, some rows on (none on leaf 1)
    gate = {}
    for i, k in enumerate(names):
        p = params[k]
        if p.dim() == 0 or p.shape[0] == 1:
            gate[k] = 1.0
            continue
        rows = p.shape[0]
        on = (torch.arange(0, rows, 2) if i != 1
              else torch.zeros(0, dtype=torch.long))
        mask = row_mask_from_indices(rows, on)
        gate[k] = mask.reshape((rows,) + (1,) * (p.dim() - 1))
    return gate


@pytest.mark.parametrize("kind", ["none", "host", "rows"])
def test_cpu_leaves_take_the_plain_route(kind):
    params = _leaves(SHAPES)
    state = adam_init(params)
    ref_p, ref_s = copy.deepcopy(params), copy.deepcopy(state)
    gate = _gates(params, kind)
    frozen = sum(1 for g in (gate or {}).values()
                 if isinstance(g, float) and not g)
    before = adam.fused_adam.launches
    for it in range(3):
        grads = _grads(params, it)
        counted = _counted(lambda: adam_update(params, grads, state, 1e-2,
                                               gate=gate))
        adam_update_plain(ref_p, grads, ref_s, 1e-2, gate=gate)
        assert counted["optim.fused_leaves"] == 0
        assert counted["optim.plain_leaves"] == len(params) - frozen
    assert adam.fused_adam.launches == before
    _assert_same_bits(_state_bits(params, state), _state_bits(ref_p, ref_s))


@pytest.mark.parametrize("p_shape,g_shape,cols", [
    ((5, 3), (5, 1), 3), ((5, 1), (5, 1), 1), ((5, 3), (5, 3), 1),
    ((4, 2, 3), (4, 1, 1), 6), ((4, 2, 3), (4, 2, 1), 3),
    ((4, 2, 3), (1, 1, 1), 24), ((), (), 1), ((1, 3), (1, 1), 3),
    ((5, 3), (1, 3), None), ((5, 3), (3,), None), ((5, 3), (5,), None),
    ((4, 2, 3), (4, 1, 3), None)])
def test_gate_cols(p_shape, g_shape, cols):
    assert adam.gate_cols(torch.zeros(g_shape), torch.zeros(p_shape)) == cols


def _f32(bits: int) -> torch.Tensor:
    return torch.tensor(struct.unpack("<f", struct.pack("<i", bits))[0],
                        dtype=torch.float32)


def _emulate(tensors, ints):
    """csrc/adam.cu's two launches over one recorded table, in f32 ATen
    operations in the kernel's order: the step counts, then the update."""
    n_leaves = ints[0]
    lr, b1, c1, b2, c2, eps = (_f32(x) for x in ints[1:7])
    for i in range(n_leaves):
        p, g, m, v, step, gate = tensors[6 * i:6 * i + 6]
        n, cols = ints[7 + 2 * i], ints[8 + 2 * i]
        assert p.numel() == n
        gt = None if cols == 0 else gate.reshape(-1)
        step += 1 if gt is None else int(bool((gt > 0).any()))
        t = torch.clamp_min(step, 1).to(torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        pf, gf, mf, vf = (x.view(-1) for x in (p, g, m, v))
        m1 = b1 * mf + c1 * gf
        v1 = b2 * vf + c2 * gf * gf
        upd = lr * (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
        if gt is None:
            pf.sub_(upd)
            mf.copy_(m1)
            vf.copy_(v1)
        else:
            rows = gt.repeat_interleave(cols)
            pf.sub_(rows * upd)
            mf.copy_(torch.where(rows > 0, m1, mf))
            vf.copy_(torch.where(rows > 0, v1, vf))


def test_kernel_tables_and_their_arithmetic(monkeypatch):
    """100 kernel leaves (split 48, 48, 4), a frozen one, a float64 one and
    a row-gated table; the route faked to "cuda", each C call's table
    recorded and emulated."""
    shapes = [SHAPES[i % len(SHAPES)] for i in range(100)]
    params = _leaves(shapes)
    params["f64"] = torch.randn(6, 2, dtype=torch.float64)
    params["frozen"] = torch.randn(7)
    params["table"] = torch.randn(10, 3)
    state = adam_init(params)
    ref_p, ref_s = copy.deepcopy(params), copy.deepcopy(state)
    frozen_bits = _state_bits({"frozen": params["frozen"]},
                              {k: {"frozen": v["frozen"]}
                               for k, v in state.items()})
    gate = {k: 1.0 for k in params}
    gate["frozen"] = 0.0
    gate["table"] = row_mask_from_indices(10, torch.tensor([1, 4, 5]))
    kernel = [k for k in params if k not in ("f64", "frozen")]
    calls = []
    monkeypatch.setattr(optim, "route", lambda t: "cuda")
    monkeypatch.setattr(adam, "_launch",
                        lambda tensors, ints: calls.append((tensors, ints)))
    lr, b1, b2, eps = 3e-3, 0.9, 0.999, 1e-8
    for it in range(3):
        grads = _grads(params, it)
        calls.clear()
        before = adam.fused_adam.launches
        counted = _counted(lambda: adam_update(params, grads, state, lr,
                                               gate=gate))
        assert counted["optim.fused_leaves"] == len(kernel) == 101
        assert counted["optim.plain_leaves"] == 1
        assert [c[1][0] for c in calls] == [48, 48, 5]
        assert adam.fused_adam.launches - before == 2 * len(calls)
        scalars = [adam.f32_bits(x) for x in (lr, b1, 1 - b1, b2, 1 - b2,
                                              eps)]
        names = iter(kernel)
        for tensors, ints in calls:
            assert ints[1:7] == scalars
            assert len(tensors) == 6 * ints[0]
            assert len(ints) == 7 + 2 * ints[0]
            for i in range(ints[0]):
                k = next(names)
                leaf = tensors[6 * i:6 * i + 6]
                for got, want in zip(leaf[:5], (
                        params[k], grads[k], state["m"][k], state["v"][k],
                        state["step"][k])):
                    assert got is want, k
                assert ints[7 + 2 * i] == params[k].numel()
                if k == "table":
                    assert ints[8 + 2 * i] == 3
                    assert torch.equal(leaf[5], gate[k])
                else:
                    assert ints[8 + 2 * i] == 0
                    assert leaf[5] is params[k]
            _emulate(tensors, ints)
        adam_update_plain(ref_p, grads, ref_s, lr, gate=gate)
    _assert_same_bits(_state_bits(params, state), _state_bits(ref_p, ref_s))
    _assert_same_bits(frozen_bits, _state_bits(
        {"frozen": params["frozen"]},
        {k: {"frozen": v["frozen"]} for k, v in state.items()}))


def _bad_leaf(case, params, grads, state, gate):
    """Make leaf/1 (3 values) one the kernel cannot take; returns the lr."""
    k = "leaf/1"
    if case == "column_gate":
        params[k] = torch.randn(3, 2)
        grads[k] = torch.randn(3, 2)
        state["m"][k], state["v"][k] = torch.zeros(3, 2), torch.zeros(3, 2)
        gate[k] = torch.ones(1, 2)
    elif case == "empty":
        params[k] = torch.zeros(0, 3)
        grads[k] = torch.zeros(0, 3)
        state["m"][k], state["v"][k] = torch.zeros(0, 3), torch.zeros(0, 3)
    elif case == "strided_param":
        params[k] = torch.randn(3, 2)[:, 0]
    elif case == "strided_grad":
        grads[k] = torch.randn(3, 2)[:, 0]
    elif case == "grad_shape":
        grads[k] = torch.randn(1, 3)
    elif case == "v_dtype":
        state["v"][k] = torch.zeros(3, dtype=torch.float64)
    elif case == "step_dtype":
        state["step"][k] = torch.zeros((), dtype=torch.int64)
    else:
        assert case == "tensor_lr"
        return torch.tensor(1e-2)
    return 1e-2


@pytest.mark.parametrize("case", [
    "column_gate", "empty", "strided_param", "strided_grad", "grad_shape",
    "v_dtype", "step_dtype", "tensor_lr"])
def test_card_leaves_the_kernel_cannot_take_raise(monkeypatch, case):
    """With the route faked to "cuda", a float32 leaf the kernel cannot take
    raises ValueError: nothing is launched, and no leaf moves, not even a
    float64 leaf of the same call that the plain loop would take."""
    params = _leaves(SHAPES[:4])
    params["f64"] = torch.randn(5, dtype=torch.float64)
    state = adam_init(params)
    grads = _grads(params, 0)
    gate = {k: 1.0 for k in params}
    lr = _bad_leaf(case, params, grads, state, gate)
    kept = _state_bits(params, state)
    calls = []
    monkeypatch.setattr(optim, "route", lambda t: "cuda")
    monkeypatch.setattr(adam, "_launch",
                        lambda tensors, ints: calls.append(ints))
    before = adam.fused_adam.launches
    with pytest.raises(ValueError):
        adam_update(params, grads, state, lr, gate=gate)
    assert calls == [] and adam.fused_adam.launches == before
    _assert_same_bits(_state_bits(params, state), kept)


def test_host_scalars_route_and_zero_leaf_calls(monkeypatch):
    """An lr given as a tensor raises on card leaves and is the plain loop's
    on CPU leaves; a call whose leaves are all frozen launches nothing and
    counts 0 and 0."""
    params = _leaves(SHAPES[:3])
    state = adam_init(params)
    calls = []
    monkeypatch.setattr(adam, "_launch",
                        lambda tensors, ints: calls.append(ints))
    with monkeypatch.context() as card:
        card.setattr(optim, "route", lambda t: "cuda")
        with pytest.raises(ValueError, match="host numbers"):
            adam_update(params, _grads(params, 0), state, torch.tensor(1e-2))
    assert all(int(s) == 0 for s in state["step"].values())
    counted = _counted(lambda: adam_update(
        params, _grads(params, 0), state, torch.tensor(1e-2)))
    assert (counted["optim.fused_leaves"], counted["optim.plain_leaves"]) \
        == (0, 3)
    monkeypatch.setattr(optim, "route", lambda t: "cuda")
    counted = _counted(lambda: adam_update(
        params, _grads(params, 1), state, 1e-2,
        gate={k: 0 for k in params}))
    assert (counted["optim.fused_leaves"], counted["optim.plain_leaves"]) \
        == (0, 0)
    assert calls == []
    assert all(int(s) == 1 for s in state["step"].values())


def test_optimizer_state_checkpoint_loads_back_unchanged(tmp_path):
    """Stage 2's optimizer state after three gated steps (the normal head
    frozen at step 0, the light tables under row masks) written with the
    params and loaded into a fresh state: every m, v and step bit for bit,
    under the keys of the JAX package's state."""
    cfg = PSNetConfig()
    model = init_psnet(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    params = init_stage2_params(model, rng.normal(size=(12, 3)),
                                np.full((12, 1), 2.0))
    mp = model_params(model)
    light = lambda t: {k: v[""] for k, v in adam_init({"": t}).items()}
    state = {"model": adam_init(mp),
             "light_dirs": light(params["light_dirs"]),
             "light_ints": light(params["light_ints"])}
    gate = {k: 0.0 if k.startswith("normal/") else 1.0 for k in mp}
    for it in range(3):
        adam_update(mp, _grads(mp, it), state["model"], 1e-3, gate=gate)
        row = row_mask_from_indices(12, torch.tensor([it, it + 3]))
        for name in ("light_dirs", "light_ints"):
            t = params[name]
            adam_update({name: t}, {name: torch.randn(t.shape)},
                        {k: {name: v} for k, v in state[name].items()},
                        1e-3, gate={name: row})
    path = str(tmp_path / "model.npz")
    ck.save_checkpoint(path, {"params": params, "opt": state}, {"it": 3})
    flat, scalars = ck.load_checkpoint(path)
    assert scalars == {"it": 3}
    fresh = {"model": adam_init(mp),
             "light_dirs": light(params["light_dirs"]),
             "light_ints": light(params["light_ints"])}
    loaded = ck.load_tree(fresh, flat, "opt/")
    want, got = ck.flatten_tree(state), ck.flatten_tree(loaded)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(loaded["model"]["step"]["normal/0/w"]) == 0
    assert int(loaded["model"]["step"]["albedo/0/w"]) == 3
    jcfg = JCfg()
    assert port_config(jcfg, PSNetConfig) == cfg
    jparams = jinit_stage2(jinit(jax.random.PRNGKey(0), jcfg),
                           np.zeros((12, 3), np.float32),
                           np.zeros((12, 1), np.float32))
    jstate = {k: jadam_init(jparams[k])
              for k in ("model", "light_dirs", "light_ints")}
    jflat = flatten_jax(jstate)
    assert set(jflat) == set(want)
    for k, v in jflat.items():
        assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
