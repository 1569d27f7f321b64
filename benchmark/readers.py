"""Helpers the per-layer readers share: the traced window's device time by
kernel name, its idle share, and the window's unit count."""

from __future__ import annotations

from benchmark.trace import kernel_seconds  # noqa: F401  (readers' API)


def traced(run):
    """The trace summary and the window's units, or (None, 0) when the run
    was not traced or did no work."""
    s = run.trace_summary
    units = (run.window or {}).get("attempted", 0)
    if not s or not units or s["window_s"] <= 0:
        return None, 0
    return s, units


def idle_share(run):
    s, _ = traced(run)
    if s is None:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def share(least_s: float, measured_s: float):
    """least over measured as a percentage, or nothing when nothing ran."""
    return 100.0 * least_s / measured_s if measured_s > 0 else None
