"""Bytes sdps_view reads back from the device, in MB (1e6) a view: the
program's counter d2h_bytes (the lights, then the normals at the padded
crop) over the window's views."""

from benchmark import program_spans


def read(run):
    n = program_spans.count_per_unit(run, "d2h_bytes")
    return None if n is None else n / 1e6
