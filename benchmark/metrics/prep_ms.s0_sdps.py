"""sdps_view's host preparation in ms a view: the program's span
sdps.prepare (the crops and pads of every light's image, LCNet's resize
to 128x128, the uploads) over the window's views."""

from benchmark import program_spans


def read(run):
    s = program_spans.seconds_per_unit(run, "sdps.prepare")
    return None if s is None else 1e3 * s
