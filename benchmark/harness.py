"""The benchmark's general machinery: finding a cell's files by name, the
run's context and directories, the program's config files written from a
configuration, the window's timing, the result line.

A cell is benchmark/workloads/<cell>.json; it names its configuration
(benchmark/configs/<config>.json) and its traffic kind
(benchmark/traffic/<kind>.py). The metrics a cell reports, and each
per-layer metric's reader (benchmark/metrics/<metric>.py), are found from
BENCHMARK.json by the cell's name.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "psnerf_tpu")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    w = read_json(os.path.join(BENCH, "workloads", name + ".json"))
    w["name"] = name
    w["cfg"] = read_json(os.path.join(BENCH, "configs", w["config"] + ".json"))
    return w


def traffic_module(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def cell_metrics(name: str, trace: bool) -> list:
    """The BENCHMARK.json entries this cell reports: its end-to-end metrics
    (setup_s first) or its per-layer ones."""
    spec = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in mine
                             else [])]


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# ----------------------------------------------------------- config files

def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "True" if v else "False"
    if v is None:
        return "null"
    if isinstance(v, float):
        s = repr(v)
        if "e" in s and "." not in s:      # YAML 1.1 floats need a dot
            s = s.replace("e", ".0e")
        return s
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    if isinstance(v, str) and ("/" in v or ":" in v):
        return json.dumps(v)
    return str(v)


def write_yaml(path: str, tree: dict) -> str:
    lines = []

    def emit(d, indent):
        for k, v in d.items():
            if isinstance(v, dict):
                lines.append(" " * indent + f"{k}:")
                emit(v, indent + 2)
            else:
                lines.append(" " * indent + f"{k}: {_yaml_scalar(v)}")

    emit(tree, 0)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _hocon_scalar(v) -> str:
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_hocon_scalar(x) for x in v) + "]"
    if isinstance(v, str) and ("/" in v or ":" in v):
        return json.dumps(v)
    return repr(v) if isinstance(v, float) else str(v)


def write_hocon(path: str, tree: dict) -> str:
    lines = []

    def emit(d, indent):
        for k, v in d.items():
            if isinstance(v, dict):
                lines.append(" " * indent + k + "{")
                emit(v, indent + 4)
                lines.append(" " * indent + "}")
            else:
                lines.append(" " * indent + f"{k} = {_hocon_scalar(v)}")

    emit(tree, 0)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


STAGE1_BLOCKS = ("model", "rendering", "dataloading", "training",
                 "extraction")
STAGE2_BLOCKS = ("dataset", "train", "loss", "brdf", "normal", "visibility")


def stage1_yaml(cfg: dict, path: str, data_dir: str, out_dir: str) -> str:
    tree = {k: dict(cfg[k]) for k in STAGE1_BLOCKS}
    tree["dataloading"]["data_dir"] = data_dir
    tree["training"]["out_dir"] = out_dir
    return write_yaml(path, tree)


def stage2_conf(cfg: dict, path: str, data_dir: str, shape_dir: str) -> str:
    tree = json.loads(json.dumps({k: cfg[k] for k in STAGE2_BLOCKS}))
    tree["dataset"]["data_dir"] = data_dir
    tree["train"]["stage1_shape_path"] = shape_dir
    return write_hocon(path, tree)


def scene_spec(cfg: dict) -> dict:
    return dict(cfg["dataset_shape"], n_views_train=cfg["n_views_train"],
                n_views_test=cfg["n_views_test"])


# ------------------------------------------------------------- the run

class Run:
    """What a traffic kind and a metric reader see of one run."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", overrides: dict | None = None):
        self.cell = cell
        self.name = cell["name"]
        self.cfg = cell["cfg"]
        self.params = dict(cell.get("params", {}))
        if overrides:
            self.params.update(overrides.get("params", {}))
            for block, kv in overrides.get("cfg", {}).items():
                if isinstance(kv, dict):
                    self.cfg[block] = dict(self.cfg[block], **kv)
                else:
                    self.cfg[block] = kv
            self.runner_kw = overrides.get("runner", {})
        else:
            self.runner_kw = {}
        self.limits = cell.get("limits", {})
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.dir = tempfile.mkdtemp(prefix=f"bench-{self.name}-")
        self.spans = {}          # name -> list of seconds
        self.work = {}           # facts of the window the readers need
        self.counters = {}       # program counters, window deltas
        self.trace_summary = None
        self.window = None

    def path(self, *parts):
        p = os.path.join(self.dir, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def span(self, name: str, seconds: float):
        self.spans.setdefault(name, []).append(seconds)

    def sync(self):
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()

    def cleanup(self):
        shutil.rmtree(self.dir, ignore_errors=True)


def timed_loop(run: Run, one, seconds: float) -> dict:
    """Call one() until `seconds` have passed (each call does whole units
    of work and returns how many), then wait for the device: the window
    runs to the end of the last unit it counts."""
    run.sync()
    t0 = time.perf_counter()
    units = 0
    while True:
        units += one()
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    return {"units": units, "elapsed": time.perf_counter() - t0}


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def check_lines(checks: list) -> tuple:
    """(correct, {name: {value, limit}}) of [(name, value, limit)]: each
    value must be finite and at most its limit."""
    ok = bool(checks)
    out = {}
    for name, value, limit in checks:
        value = float(value)
        good = finite(value) and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def device_info(run: Run, chips: int) -> dict:
    import torch
    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def emit(result: dict, checks: dict, out=sys.stdout, err=sys.stderr):
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=err)
    err.flush()
    result = dict(result, checks=checks)
    print(json.dumps(result), file=out)
    out.flush()
