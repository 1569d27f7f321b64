"""SDPS-Net's share of the card's peak over the traced window: LCNet's and
NENet's convolution products at the published widths (benchmark/
work_sdps.py, from the program's pixel counters) at float32's TF32 peak,
over the window."""

from benchmark import program_spans, readers, work
from benchmark.work_sdps import conv_flops


def read(run):
    s, units = readers.traced(run)
    if s is None:
        return None
    flops = conv_flops(run.cfg, program_spans.count_per_unit(
        run, "sdps.lcnet_px"), program_spans.count_per_unit(
        run, "sdps.nenet_px"))
    if flops is None:
        return None
    return readers.share(units * work.least_seconds({"tf32": flops}),
                         s["window_s"])
