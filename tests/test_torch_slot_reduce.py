"""What the wrappers of the slot reduction engine (csrc/slot_reduce.cuh)
decide on the host, on the CPU: the f32 backward's weight-gradient slot
layout (`f32_slot_layout`, the library's `wplan` mirrored), the f32
backward's launches on its buffers, and the launch helper they share
(`build.launch`). The engine itself runs on the card
(tests/test_torch_gpu.py)."""

import contextlib
import math
import types

import numpy as np
import pytest
import torch

from psnerf_torch.ops import build
from psnerf_torch.ops import fused_radiance as fr


@pytest.mark.parametrize("w,ke,kv,nt", [(256, 48, 32, 7), (128, 48, 32, 3),
                                        (256, 16, 16, 1)])
def test_f32_slot_layout_is_leaf_after_leaf(w, ke, kv, nt):
    """The f32 weight-gradient slot: every leaf contiguous, none
    overlapping, all of them and 4 zero columns filling the slot, a
    multiple of 4 floats (the engine's 16-byte loads); the rgb head's
    column sums ba4 and b8l adjacent, as its product writes them."""
    leaves, total = fr.f32_slot_layout(w, ke, kv, nt)
    assert list(leaves) == fr.PACK_ORDER
    shapes = fr._GRAD_SHAPES(w, ke, kv, nt)
    spans = sorted((o, o + math.prod(shapes[k])) for k, o in leaves.items())
    assert spans[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert total == spans[-1][1] + 4 and total % 4 == 0
    assert leaves["b8l"] == leaves["ba4"] + 3
    assert leaves["trunk_b"] == leaves["trunk_w"] + nt * w * w
    assert leaves["wv"] == leaves["wf"] + w * w


def _fake_lib(calls, fail=None):
    """A stand-in for the f32 library: each entry records (kernel, the
    pointers and ints it was given) and returns 0, or 2 for `fail`."""
    lib = types.SimpleNamespace(
        psnerf_rf32_error_string=lambda rc: b"invalid argument")
    for k in fr.F32_KERNELS:
        def entry(ptrs, ints, stream, k=k):
            calls.append((k, list(ptrs), list(ints)))
            return 2 if k == fail else 0
        setattr(lib, f"psnerf_rf32_{k}", entry)
    return lib


def _f32_backward(monkeypatch, n, calls, fail=None):
    from psnerf_torch.fields import occupancy as occ

    cfg = occ.OccFieldConfig(num_layers=4, hidden_dim=128, feat_size=128,
                             skips=(2,))
    field = occ.init_occupancy_field(cfg, generator=torch.Generator()
                                     .manual_seed(0))
    with torch.no_grad():
        packed = fr.pack_radiance(field, cfg, torch.float32)
    w, ke, kv, nt = fr._dims(packed, cfg.skips[0] - 1)
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.as_tensor(rng.normal(size=shape)
                                       .astype(np.float32))

    def fake_sizes(w, ke, kv, nt):
        return dict(split_words=8, ws_rows=fr.ws_layout(w, ke, kv, nt)[1],
                    fwd_scratch=8, sweep_scratch=8,
                    slot_floats=fr.f32_slot_layout(w, ke, kv, nt)[1],
                    wgrad_tiles=4)

    monkeypatch.setattr(fr, "_lib_f32", lambda: _fake_lib(calls, fail))
    monkeypatch.setattr(fr, "f32_sizes", fake_sizes)
    monkeypatch.setattr(fr, "_need_cuda", lambda dev: None)
    monkeypatch.setattr(fr, "_slots", lambda dev: 4)
    # a CPU tensor's device has no index; the stand-in lib takes stream 0
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda i=None: types.SimpleNamespace(cuda_stream=0))
    return fr.F32Backward(packed, t(n, ke), t(n, ke), t(n, kv), t(n, 3),
                          t(n, ke), t(n, 4), cfg.skips[0] - 1)


def test_f32_backward_launches_on_its_buffers(monkeypatch):
    """Each launch of F32Backward passes the pointers of its own buffers:
    the sweeps and weight-gradient passes chunk by chunk, then the reduce
    of every split-K slot of its partial buffer into the sum whose views
    are the gradients; a second run makes the same launches (on new split
    weights, which each split allocates)."""
    calls = []
    monkeypatch.setattr(fr, "CHUNK", 96)
    b = _f32_backward(monkeypatch, 200, calls)
    assert calls == []                      # nothing launched yet
    ptr = lambda ts: [x.data_ptr() for x in ts]
    grads = b.run()
    fr.reset_launches()
    names = [k for k, _, _ in calls]
    assert names == ["split"] + ["sweep", "wgrad"] * 3 + ["reduce"]
    assert calls[0][1][-1] == b.frags.data_ptr()
    for c in range(3):
        sweep, wgrad = calls[1 + 2 * c], calls[2 + 2 * c]
        assert sweep[1] == ptr([*b.ins, b.frags, *b.vec, *b.grad_ins, b.ws,
                                b.scratch])
        assert sweep[2][:2] == [min(96, 200 - 96 * c), 96 * c]
        assert wgrad[1] == ptr([b.ws, b.partial])
        assert wgrad[2][-1] == c * b.splits
    assert calls[-1][1] == ptr([b.partial, b.sum])
    assert calls[-1][2] == [b.slot_floats, b.n_chunks * b.splits]
    leaves, total = fr.f32_slot_layout(*b.dims)
    assert b.sum.shape == (total,) and b.partial.shape[1] == total
    for k, x in grads.items():
        assert x.data_ptr() == b.sum.data_ptr() + 4 * leaves[k], k
        assert x.is_contiguous(), k
    n_calls = len(calls)
    b.run()
    fr.reset_launches()
    again = calls[n_calls:]
    assert [(k, i) for k, _, i in again] == [(k, i) for k, _, i in
                                            calls[:n_calls]]
    assert again[-1][1] == ptr([b.partial, b.sum])


def test_f32_launch_failure_raises(monkeypatch):
    """A non-zero return of a C entry raises with its error text."""
    b = _f32_backward(monkeypatch, 64, [], fail="reduce")
    b.split()
    with pytest.raises(RuntimeError, match="f32 reduce kernel launch "
                                           "failed: invalid argument"):
        b.reduce()
    fr.reset_launches()


@pytest.mark.parametrize("current", [0, 1])
def test_launch_enters_the_device_only_when_not_current(monkeypatch,
                                                        current):
    """build.launch passes the tensors' pointers and the ints with the
    stream of the tensors' device (here 0), and enters that device only
    when another one is current."""
    entered, got = [], []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda i=None: types.SimpleNamespace(cuda_stream=7 + i))
    x, y = torch.ones(8), torch.zeros(4)
    dev = types.SimpleNamespace(index=0)
    build.launch(lambda p, i, s: got.append((list(p), list(i), s)) or 0,
                 None, dev, [x, y], [3, 5], "t")
    assert got == [([x.data_ptr(), y.data_ptr()], [3, 5], 7)]
    assert entered == ([] if current == 0 else [dev])
