"""The stage-2 step's Adam update in host ms a step: the program's spans
stage2.optim (the per-leaf update of the PSNet's leaves and both light
tables) over the window's steps. Taken in the traced run, whose profiler
inflates aten-heavy host time."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "stage2.optim")
    return None if s is None else 1e3 * s
