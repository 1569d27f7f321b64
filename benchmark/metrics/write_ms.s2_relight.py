"""render_envmap's PNG encoding in ms a view: the program's span
render_envmap.write (each view's PNG and the light probe's) over the
window's views."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "render_envmap.write")
    return None if s is None else 1e3 * s
