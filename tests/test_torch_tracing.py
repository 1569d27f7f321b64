"""The port's spans and counters (psnerf_torch/utils/profiling.py) on the
CPU: off, a span records nothing and never enters record_function; under
torch.profiler, spans nest with their cause and root on the profiler's own
clock; work handed to a thread keeps its cause; each tracing session holds
only its own records; counters add only while tracing, and
d2h_pinned_bytes reads 0 in a session that pinned nothing. And one traced toy
run of each benchmark cell reports the per-layer metrics that read them.
"""

import importlib.util
import math
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import profile

from psnerf_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def test_off_a_span_records_nothing_and_skips_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before, counted = profiling.spans(), profiling.counters()
    with profiling.span("off.outer") as outer:
        with profiling.span("off.inner") as inner:
            assert profiling.current() is None
            profiling.count("off.count", 3)
    assert outer.seconds >= inner.seconds >= 0
    assert outer.id is inner.id is inner.cause is None
    assert [s.name for s in profiling.spans()] == [s.name for s in before]
    assert profiling.counters() == counted


def _events(prof) -> dict:
    out = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_nested_spans_carry_cause_and_root_on_the_profiler_clock():
    x = torch.ones(32, 32)
    with profile() as prof:
        for _ in range(2):
            with profiling.span("t.step") as step:
                with profiling.span("t.forward") as fwd:
                    with profiling.span("t.inner") as inner:
                        x = x @ x / 32
                with profiling.span("t.optim") as opt:
                    x = x + 1
    got = profiling.spans()
    assert [s.name for s in got] == ["t.inner", "t.forward", "t.optim",
                                     "t.step"] * 2
    assert step.cause is None and step.root == step.id
    assert fwd.cause == step.id and opt.cause == step.id
    assert inner.cause == fwd.id and inner.root == step.id
    assert len({s.root for s in got}) == 2        # one root a step
    events = _events(prof)
    slack = 1_000_000                             # 1 ms
    for name in {s.name for s in got}:
        mine = sorted((s.start_ns, s.end_ns) for s in got if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) == 2
        for (s0, s1), (e0, e1) in zip(mine, theirs):
            assert s0 - slack <= e0 <= e1 <= s1 + slack
    assert all(s.seconds == pytest.approx((s.end_ns - s.start_ns) * 1e-9)
               for s in got)


def test_a_span_on_a_worker_thread_keeps_the_cause_it_was_given():
    seen = {}
    with profile():
        with profiling.span("w.root") as root:
            cause = profiling.current()
            assert cause is root

            def work():
                with profiling.span("w.write", cause=cause) as sp:
                    seen["thread_current"] = profiling.current()
                seen["span"] = sp

            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    sp = seen["span"]
    assert sp.cause == root.id and sp.root == root.id
    assert sp.thread != root.thread
    assert seen["thread_current"] is sp
    assert [s.name for s in profiling.spans() if s.root == root.id] == [
        "w.write", "w.root"]


def test_each_traced_session_returns_only_its_own_spans(tmp_path):
    """A session starts at trace(), or when a span or count finds the
    profiler on after it last found it off."""
    profiling.count("off")
    with profile():
        with profiling.span("first"):
            pass
    assert [s.name for s in profiling.spans()] == ["first"]
    with profiling.span("between"):      # off: ends nothing, starts nothing
        pass
    assert [s.name for s in profiling.spans()] == ["first"]
    with profiling.trace(str(tmp_path)):
        with profiling.span("second"):
            pass
    assert [s.name for s in profiling.spans()] == ["second"]


def test_count_adds_only_while_tracing():
    profiling.count("c.n", 5)            # off: and the next session is new
    with profile():
        profiling.count("c.n", 2)
        profiling.count("c.n")
        profiling.to_host(torch.zeros(4, 3))
    profiling.count("c.n", 7)
    assert profiling.counters() == {"c.n": 3, "d2h_bytes": 48,
                                    "d2h_pinned_bytes": 0}


def test_pinned_bytes_is_a_named_counter_that_reads_zero_unpinned(tmp_path):
    """Every session names d2h_pinned_bytes from its start, so a reader
    tells "nothing pinned" (0) from a program without the counter; a CPU
    read-back through to_pinned_host counts as d2h_bytes alone and returns
    the tensor itself."""
    with profile():
        profiling.count("other")
        assert profiling.counters() == {"other": 1, "d2h_pinned_bytes": 0}
    x = torch.arange(6.0)
    with profiling.trace(str(tmp_path)):
        assert profiling.counters() == {"d2h_pinned_bytes": 0}
        assert profiling.to_pinned_host(x) is x
    assert profiling.counters() == {"d2h_bytes": 24, "d2h_pinned_bytes": 0}


def _toy():
    spec = importlib.util.spec_from_file_location(
        "bench_toy", ROOT / "benchmark" / "tests" / "toy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.toy


@pytest.mark.parametrize("cell,names", [
    ("s1_train_bear", ("optim_host_ms.s1_train", "step_host_ms.s1_train")),
    ("s2_eval_bear", ("scatter_ms.s2_eval", "copy_ms.s2_eval",
                      "d2h_mb.s2_eval")),
    ("s1_export_bear", ("load_s.s1_export", "write_wait_s.s1_export"))])
def test_traced_toy_cell_reports_the_program_span_metrics(cell, names):
    from benchmark.run import run_cell

    torch.set_num_threads(2)
    res, _ = run_cell(cell, 3_000_000_017, 0.3, 1, device="cpu",
                      overrides=_toy()(cell))
    for name in names:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    if cell == "s2_eval_bear":
        assert res["metrics"]["d2h_mb.s2_eval"]["value"] > 0
