"""Read the numbers that decide a cell's `correct` over many seeds in one
process, for setting their limits: the program's (sound runs), the
control's (the reference one precision lower, in the program's place)
and, for a training cell, the half-batch fault's (half of each batch left
out, the mean over the rest).

    python3 benchmark/calibrate.py --workload <cell> --seeds 12
        --control 3 --seconds 2 [--first-seed N] [--out FILE]

Each seed builds the cell's set-up and a short window (--seconds), then
prints one JSON line per variant. The last line is a summary: each
number's largest program reading and smallest control or fault reading.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def calibrate(name, seeds, n_control, seconds, device="cuda",
              overrides=None, out=sys.stdout):
    """Readings of the program on every seed, and of the control and the
    cell's faults on the first n_control seeds; returns (rows, summary)."""
    import gc

    import torch

    traffic = harness.traffic_module(harness.load_cell(name)["traffic"])
    faults = ["control", *getattr(traffic, "FAULTS", ())]
    rows = []
    for i, seed in enumerate(seeds):
        run = harness.Run(harness.load_cell(name), seed, seconds, False,
                          device, overrides)
        try:
            state = traffic.setup(run)
            run.window = traffic.window(run, state)
            o = traffic.collect(run, state)
            del state
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
            for variant in ["program"] + (faults if i < n_control else []):
                r = traffic.readings(run, o, variant)
                row = {"seed": seed, "variant": variant,
                       "numbers": {k: v for k, v in r.items()
                                   if isinstance(v, float)},
                       "detail": {k: v for k, v in r.items()
                                  if not isinstance(v, float)}}
                rows.append(row)
                print(json.dumps(row), file=out, flush=True)
        finally:
            run.cleanup()
    summary = {}
    for row in rows:
        for k, v in row["numbers"].items():
            s = summary.setdefault(k, {})
            key = "lower" if row["variant"] == "program" else row["variant"]
            s[key] = (max(s.get(key, v), v) if key == "lower"
                      else min(s.get(key, v), v))
    print(json.dumps({"summary": summary}), file=out, flush=True)
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--params", default="{}",
                    help="JSON of workload params to override, e.g. "
                         "'{\"pick_from\": 2}'")
    args = ap.parse_args(argv)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    calibrate(args.workload, seeds, args.control, args.seconds,
              overrides={"params": json.loads(args.params)})


if __name__ == "__main__":
    main()
