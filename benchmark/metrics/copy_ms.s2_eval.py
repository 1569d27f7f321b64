"""render_view's device-to-host copies in ms a view: the program's spans
render_view.copy (each output's .cpu(), which first waits for the frame's
kernels, and the normals') over the window's views."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "render_view.copy")
    return None if s is None else 1e3 * s
