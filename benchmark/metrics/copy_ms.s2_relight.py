"""render_envmap's device-to-host read-backs in ms a relit view: the
program's spans render_view.copy (one copy of a chunk's assembled outputs
into page-locked memory and its wait, which first waits for the chunk's
device work), one a chunk, over the window's views."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "render_view.copy")
    return None if s is None else 1e3 * s
