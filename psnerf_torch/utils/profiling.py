"""Profiling and timing (counterpart of psnerf_tpu/utils/profiling.py): a
torch.profiler trace context whose Chrome/Perfetto trace lands under a
directory, and a per-phase wall timer that synchronises the device first.

The JAX package's `enable_compilation_cache` (XLA's persistent program
cache) has no counterpart: the port compiles nothing per program, and its
kernels are built once into their build directories
(psnerf_torch/ops/_build, psnerf_torch/mesh/_build), which later processes
reuse.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the block with torch.profiler (CPU activities, and CUDA ones
    when a card is present) and write its Chrome trace as
    `logdir/trace_<pid>_<ns>.json`; a no-op when logdir is None:

        with profiling.trace("out/trace") as prof:
            step(...)
    """
    if logdir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _first_tensor(result):
    if isinstance(result, torch.Tensor):
        return result
    items = (result.values() if isinstance(result, dict)
             else result if isinstance(result, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class PhaseTimer:
    """Wall seconds per phase. `mark(phase, result)` first waits for the
    device of `result`'s first tensor (a tensor, or one inside nested dicts,
    lists and tuples) when `sync` is on, then books the time since the last
    mark to `phase`; `summary()` gives each phase's mean."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times: dict[str, list] = {}
        self._t = time.perf_counter()

    def mark(self, phase: str, result=None):
        if self.sync and result is not None:
            first = _first_tensor(result)
            if first is not None and first.device.type == "cuda":
                torch.cuda.synchronize(first.device)
        now = time.perf_counter()
        self.times.setdefault(phase, []).append(now - self._t)
        self._t = now

    def summary(self) -> dict:
        return {k: float(np.mean(v)) for k, v in self.times.items()}
