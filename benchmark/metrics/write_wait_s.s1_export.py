"""The export's main thread blocked on its npy writer, in s a view: the
program's spans shape_extract.write_wait (the back-pressure past 4 pending
writes and the final drain) over the window's exported views."""

from benchmark import program_spans


def read(run):
    return program_spans.seconds_per_unit(run, "shape_extract.write_wait")
