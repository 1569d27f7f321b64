"""Bytes render_envmap reads back from the device, in MB (1e6) a relit
view: the program's counter d2h_bytes (each chunk's render_view
read-backs: the mask, then the assembled rgb sum and normals) over the
window's views."""

from benchmark import program_spans


def read(run):
    n = program_spans.count_per_unit(run, "d2h_bytes")
    return None if n is None else n / 1e6
