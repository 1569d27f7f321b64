"""What the program's spans cost: a span's host time with tracing off and
on (a tight loop), the spans a stage-1 step opens, and the stage-1 step of
the benchmark's s1_train_bear cell with the spans and with them replaced
by a bare context manager, in turns.

    python3 tools/span_cost.py [--seed 7] [--steps 200] [--rounds 3]

Prints one JSON line. Needs a CUDA card, except with --cpu-toy (the
benchmark tests' toy sizes, to rehearse).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from psnerf_torch.utils import profiling  # noqa: E402


class _Bare:
    """A context manager that does nothing: the spans' stand-in."""

    seconds = 0.0

    def __init__(self, name, cause=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def per_call_ns(factory, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with factory("cost.span"):
            pass
    return (time.perf_counter_ns() - t0) / n


def step_ms(run, runner, steps: int) -> float:
    run.sync()
    t0 = time.perf_counter()
    runner.train(runner.it + steps, log_every=10 ** 9, ckpt_every=10 ** 9)
    run.sync()
    return 1e3 * (time.perf_counter() - t0) / steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=200_000)
    ap.add_argument("--cpu-toy", action="store_true")
    args = ap.parse_args(argv)

    from benchmark import harness
    from benchmark.traffic import train_stage1

    out = {"device": "cpu" if args.cpu_toy else
           torch.cuda.get_device_name(0)}
    real = profiling.span
    n = args.calls
    out["bare_ns"] = per_call_ns(_Bare, n)
    out["span_off_ns"] = per_call_ns(real, n)
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [] if args.cpu_toy else [torch.profiler.ProfilerActivity.CUDA])
    with torch.profiler.profile(activities=acts):
        out["span_on_ns"] = per_call_ns(real, min(n, 50_000))

    cell = harness.load_cell("s1_train_bear")
    overrides, device = None, "cuda"
    if args.cpu_toy:
        sys.path.insert(0, os.path.join(ROOT, "benchmark", "tests"))
        from toy import toy
        overrides, device = toy("s1_train_bear"), "cpu"
    run = harness.Run(cell, args.seed, 0.0, False, device, overrides)
    try:
        runner = train_stage1.setup(run)["runner"]
        with torch.profiler.profile(activities=acts):
            it0 = runner.it
            runner.train(it0 + 3, log_every=10 ** 9, ckpt_every=10 ** 9)
            out["spans_per_step"] = len(profiling.spans()) / (
                runner.it - it0)
        step_ms(run, runner, args.steps)                  # warm
        rounds = []
        for _ in range(args.rounds):
            pair = {}
            for side in ("spans", "bare", "bare", "spans"):
                profiling.span = real if side == "spans" else _Bare
                try:
                    pair.setdefault(side, []).append(
                        step_ms(run, runner, args.steps))
                finally:
                    profiling.span = real
            rounds.append(pair)
        out["step_ms"] = rounds
    finally:
        run.cleanup()
    out["off_us_per_step"] = (out["span_off_ns"] - out["bare_ns"]) * \
        out["spans_per_step"] / 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
