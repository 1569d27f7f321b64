"""render_view's device-to-host read-back in ms a view: the program's
spans render_view.copy (one copy of the assembled frame into page-locked
memory and its wait, which first waits for the frame's device work) over
the window's views."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "render_view.copy")
    return None if s is None else 1e3 * s
