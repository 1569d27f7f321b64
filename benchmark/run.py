"""Run one benchmark cell of psnerf_torch and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (scene and weights from the seed, the program's runner, the first
steps or views the comparison reads, the warm-up) counts as setup_s, from
process start to the window's start. The window then drives the program
for --seconds; --trace 1 profiles it and reports the per-layer metrics,
--trace 0 the end-to-end ones. After the window the plain reference
decides `correct`. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error. A run without a CUDA card, or without the program, exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import counters, harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(name, seed, seconds, trace, device="cuda", overrides=None,
             t_start=None):
    """Run one cell; returns (result dict, checks dict). device="cpu" and
    overrides (toy sizes, runner options) serve the CPU tests."""
    import torch

    from benchmark.trace import Traced, summarize

    t_start = T_START if t_start is None else t_start
    cell = harness.load_cell(name)
    chips = cell["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device != "cpu" and found < chips:
        raise SystemExit(f"cell {name} needs {chips} CUDA device(s); "
                         f"found {found}")
    traffic = harness.traffic_module(cell["traffic"])
    run = harness.Run(cell, seed, seconds, bool(trace), device, overrides)
    try:
        state = traffic.setup(run)
        run.sync()
        setup_s = time.perf_counter() - t_start
        before = counters.read()
        with Traced(run.trace, cuda=device != "cpu") as tr:
            run.window = traffic.window(run, state)
        after = counters.read()
        run.counters = {k: after[k] - before.get(k, 0) for k in after}
        if tr.prof is not None:
            run.trace_summary = summarize(tr.prof)
            del tr.prof
        dev = harness.device_info(run, chips)
        if run.trace_summary is not None:
            dev["busy_s"] = run.trace_summary["busy_s"]
            dev["window_s"] = run.trace_summary["window_s"]
        outputs = traffic.collect(run, state)
        del state
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        checks = traffic.check(run, outputs)
        correct, checks = harness.check_lines(checks)
        metrics = {}
        for m in harness.cell_metrics(name, bool(trace)):
            if m["name"] == "setup_s":
                value = setup_s
            elif trace:
                value = harness.metric_reader(m["name"])(run)
            else:
                value = run.window["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result = {"correct": correct, "attempted": run.window["attempted"],
                  "failed": run.window["failed"], "metrics": metrics,
                  "device": dev}
        if run.trace_summary is not None:
            result["breakdown"] = {
                "device_ops": run.trace_summary["device_ops"],
                "idle_gaps": run.trace_summary["idle_gaps"]}
        return result, checks
    finally:
        run.cleanup()


def main(argv=None):
    args = parse(argv)
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              args.trace)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures psnerf_torch "
              "alone", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
