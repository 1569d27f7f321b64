"""Readers' helpers for the program's own spans and counters
(psnerf_torch.utils.profiling): the newest tracing session, which in a
traced run is the window's. A program without them, or a session without
the name asked for, reads as nothing."""

from __future__ import annotations


def _profiling():
    try:
        from psnerf_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    return profiling


def _units(run):
    return (run.window or {}).get("attempted", 0)


def seconds_per_unit(run, name: str):
    """The seconds of the spans named `name` over the window's units, or
    None when there are none."""
    prof, units = _profiling(), _units(run)
    if prof is None or not units:
        return None
    found = [s.seconds for s in prof.spans() if s.name == name]
    return sum(found) / units if found else None


def count_per_unit(run, name: str):
    """The counter `name` over the window's units, or None when it was not
    counted."""
    prof, units = _profiling(), _units(run)
    if prof is None or not units:
        return None
    n = prof.counters().get(name)
    return n / units if n is not None else None
