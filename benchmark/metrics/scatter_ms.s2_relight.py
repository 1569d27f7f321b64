"""render_envmap's device assembly of each chunk's outputs, in ms a
relit view: the program's spans render_view.scatter (the enqueue of one
flat device buffer, each output's fill and index_copy_ at the mask's
pixels, and the normals), one a chunk, over the window's views."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "render_view.scatter")
    return None if s is None else 1e3 * s
