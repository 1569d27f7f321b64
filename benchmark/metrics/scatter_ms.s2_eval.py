"""The host's scatter of render_view's outputs into full frames, in ms a
view: the program's spans render_view.scatter (np.full, the fancy-index
fill and the reshape of each output) over the window's views."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "render_view.scatter")
    return None if s is None else 1e3 * s
