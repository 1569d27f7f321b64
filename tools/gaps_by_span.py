"""Run one benchmark cell traced and put each of its longest device idle
gaps down to the program span the host was in, on the clock the profiler
and the spans share (time.time_ns(), Unix epoch).

    python3 tools/gaps_by_span.py --workload s2_eval_bear --seed 7 \
        --seconds 30 --out out/gaps_s2_eval_bear.json

Prints the cell's result line (as `benchmark/run.py --trace 1` would), the
ten longest idle gaps each with the innermost span open on the main
thread at the gap's middle (and its chain of causes up to the root, and
any other thread's span open then), and each span name's count and
seconds a unit of the window. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from benchmark import trace as btrace  # noqa: E402


def device_gaps(prof, top: int) -> list:
    """[(start_ns, end_ns)] of the `top` longest device idle gaps inside
    the benchmark's window annotation, as benchmark/trace.py finds them."""
    dev_s, dev_e, w = [], [], None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name() == btrace.WINDOW:
                continue
            dev_s.append(s)
            dev_e.append(s + d)
        elif e.name() == btrace.WINDOW:
            w = (s, s + d)
    dev_s, dev_e = np.asarray(dev_s, float), np.asarray(dev_e, float)
    inside = (dev_e > w[0]) & (dev_s < w[1])
    ms, me = btrace._merge(np.clip(dev_s[inside], *w),
                           np.clip(dev_e[inside], *w))
    g0 = np.concatenate([[w[0]], me])
    g1 = np.concatenate([ms, [w[1]]])
    order = np.argsort(g0 - g1)[:top]
    return [(float(g0[i]), float(g1[i])) for i in order if g1[i] > g0[i]]


def innermost(spans, t: float, thread=None, other=False):
    """The latest-started span covering time t on `thread` (or, with
    other, on any other thread)."""
    cover = [s for s in spans if s.start_ns <= t <= s.end_ns
             and ((s.thread != thread) if other else (s.thread == thread))]
    return max(cover, key=lambda s: s.start_ns) if cover else None


def chain(span, by_id) -> list:
    names = []
    while span is not None:
        names.append(span.name)
        span = by_id.get(span.cause)
    return names[::-1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--out")
    ap.add_argument("--cpu-toy", action="store_true",
                    help="rehearse on the CPU at the benchmark tests' toy "
                         "sizes")
    args = ap.parse_args(argv)

    from benchmark.run import run_cell
    from psnerf_torch.utils import profiling

    gaps = []
    orig = btrace.summarize

    def summarize(prof, top=10):
        gaps.extend(device_gaps(prof, args.top))
        return orig(prof, top)

    btrace.summarize = summarize
    main_thread = threading.get_ident()
    kw = {}
    if args.cpu_toy:
        sys.path.insert(0, os.path.join(ROOT, "benchmark", "tests"))
        from toy import toy
        kw = {"device": "cpu", "overrides": toy(args.workload)}
    result, checks = run_cell(args.workload, args.seed, args.seconds, 1,
                              **kw)
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    rows = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = innermost(spans, mid, main_thread)
        other = innermost(spans, mid, main_thread, other=True)
        rows.append({"gap_s": (g1 - g0) / 1e9,
                     "span": inner.name if inner else None,
                     "chain": chain(inner, by_id),
                     "other_thread": other.name if other else None})
    units = result["attempted"]
    totals = {}
    for s in spans:
        n, t = totals.get(s.name, (0, 0.0))
        totals[s.name] = (n + 1, t + s.seconds)
    per_unit = {k: {"count": n, "s_per_unit": t / units}
                for k, (n, t) in sorted(totals.items())}
    out = {"workload": args.workload, "seed": args.seed, "result": result,
           "checks": checks, "counters": profiling.counters(),
           "gaps_by_span": rows, "spans": per_unit}
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({"gaps_by_span": rows, "spans": per_unit,
                      "counters": out["counters"]}))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
