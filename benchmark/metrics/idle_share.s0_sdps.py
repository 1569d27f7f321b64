"""The device's idle share of the traced window: 1 minus the union of its
busy intervals (kernels, copies, sets) over the window."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
