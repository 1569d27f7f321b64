"""The stage-2 step in host ms: the program's spans stage2.step (plot,
sample, forward, backward, optimizer, log, checkpoint; the root of each
step) over the window's steps. Taken in the traced run: near the traced
step's time, the host sets the pace."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "stage2.step")
    return None if s is None else 1e3 * s
