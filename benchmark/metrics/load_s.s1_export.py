"""The export's dataset load in s a view: the program's spans
shape_extract.load (load_stage1_data, once a call) over the window's
exported views."""

from benchmark import program_spans


def read(run):
    return program_spans.seconds_per_unit(run, "shape_extract.load")
