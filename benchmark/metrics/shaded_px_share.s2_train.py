"""The share of each stage-2 step's drawn pixels that the step shades, in
%: the program's counters stage2.shaded_px over stage2.drawn_px. Nothing
on a program without them."""

from benchmark import program_spans


def read(run):
    shaded = program_spans.count_per_unit(run, "stage2.shaded_px")
    drawn = program_spans.count_per_unit(run, "stage2.drawn_px")
    if shaded is None or not drawn:
        return None
    return 100.0 * shaded / drawn
