"""The traced window: torch.profiler over the device and the host, reduced
to what the per-layer readers and the result line need.

Device time is the union of the device's busy intervals (kernels, copies,
sets) inside the window, never their sum, so overlapping work counts
once. The window is the benchmark's own annotation around it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"


class Traced:
    """Context that profiles the window under the annotation WINDOW."""

    def __init__(self, on: bool, cuda: bool = True):
        self.on = on
        self.cuda = cuda
        self.prof = None
        self.rf = None

    def __enter__(self):
        if self.on:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.rf = record_function(WINDOW)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            if self.cuda:
                torch.cuda.synchronize()
            self.rf.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False


def _merge(starts, ends):
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    seg_e = np.append(run_end[idx[1:] - 1], run_end[-1]) if len(s) else e
    return s[idx], seg_e


def _host_at(names, cs, ce, by_end, ends, g0, g1) -> str:
    """What the host was doing in a device gap [g0, g1]: the innermost host
    operation spanning its middle, or else the operation that ended last
    before it and the one that began first after it."""
    mid = 0.5 * (g0 + g1)
    cover = [j for j in np.flatnonzero((cs <= mid) & (ce >= mid))
             if names[j] != WINDOW]
    if cover:
        return names[max(cover, key=lambda j: cs[j])][:120]
    k = np.searchsorted(ends, g0, side="right") - 1
    before = names[by_end[k]][:56] if k >= 0 else "start"
    after = np.flatnonzero(cs >= g1)
    nxt = names[after[np.argmin(cs[after])]][:56] if len(after) else "end"
    return f"host: {before} .. {nxt}"


def summarize(prof, top: int = 10) -> dict:
    """Kernels [(name, start_us, dur_us)], busy_s (union), window_s, the
    device ops that took most time and the longest idle gaps, each named by
    the innermost host operation that spans its middle."""
    evs = prof.profiler.kineto_results.events()
    dev_n, dev_s, dev_e = [], [], []
    cpu_n, cpu_s, cpu_e = [], [], []
    w0 = w1 = None
    for e in evs:
        s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name() == WINDOW:
                continue
            dev_n.append(e.name())
            dev_s.append(s)
            dev_e.append(s + d)
        else:
            n = e.name()
            if n == WINDOW:
                w0, w1 = s, s + d
            cpu_n.append(n)
            cpu_s.append(s)
            cpu_e.append(s + d)
    dev_s, dev_e = np.asarray(dev_s), np.asarray(dev_e)
    if w0 is None:
        w0, w1 = (dev_s.min(), dev_e.max()) if len(dev_s) else (0.0, 0.0)
    inside = (dev_e > w0) & (dev_s < w1)
    ks, ke = np.clip(dev_s[inside], w0, w1), np.clip(dev_e[inside], w0, w1)
    names = [n for n, i in zip(dev_n, inside) if i]
    ms, me = _merge(ks, ke) if len(ks) else (ks, ke)
    busy = float(np.sum(me - ms)) / 1e6
    by_op = {}
    for n, a, b in zip(names, ks, ke):
        key = n[:120]
        by_op[key] = by_op.get(key, 0.0) + (b - a) / 1e6
    gap_s = np.concatenate([[w0], me])
    gap_e = np.concatenate([ms, [w1]])
    glen = gap_e - gap_s
    cs, ce = np.asarray(cpu_s), np.asarray(cpu_e)
    by_end = np.argsort(ce, kind="stable")
    ends = ce[by_end]
    gaps = []
    for i in np.argsort(-glen)[:top]:
        if glen[i] <= 0:
            break
        gaps.append([_host_at(cpu_n, cs, ce, by_end, ends, gap_s[i],
                              gap_e[i]), float(glen[i]) / 1e6])
    return {
        "kernels": list(zip(names, ks.tolist(), (ke - ks).tolist())),
        "busy_s": busy, "window_s": float(w1 - w0) / 1e6,
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": gaps}


def device_only(cuda: bool = True):
    """A profiler of the device alone (on the CPU, of its operators), for a
    window whose end-to-end metric is read from the device's trace."""
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def kernel_busy_seconds(prof, cuda: bool = True) -> float:
    """The union of the intervals in which the device ran a kernel (on CUDA
    copies and sets left out; on the CPU, for the CPU tests, the aten
    operators)."""
    s, e = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if cuda:
            if (ev.device_type() != DeviceType.CUDA or ev.is_user_annotation()
                    or name.startswith(("Memcpy", "Memset"))):
                continue
        elif not name.startswith("aten::"):
            continue
        t = ev.start_ns() / 1e3
        s.append(t)
        e.append(t + ev.duration_ns() / 1e3)
    if not s:
        return 0.0
    ms, me = _merge(np.asarray(s), np.asarray(e))
    return float(np.sum(me - ms)) / 1e6


def kernel_seconds(summary: dict, patterns) -> tuple:
    """(seconds, launches) of the window's device kernels whose names
    contain any of `patterns`."""
    t, n = 0.0, 0
    for name, _, dur in summary["kernels"]:
        if any(p in name for p in patterns):
            t += dur / 1e6
            n += 1
    return t, n
