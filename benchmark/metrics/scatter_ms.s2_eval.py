"""render_view's assembly of its outputs into full frames on the device,
in ms a view: the program's spans render_view.scatter (the enqueue of one
flat device buffer, each output's fill and index_copy_ at the mask's
pixels or its slice copy, and the normals) over the window's views."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "render_view.scatter")
    return None if s is None else 1e3 * s
