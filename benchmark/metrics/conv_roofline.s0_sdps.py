"""SDPS-Net's convolutions' share of their roofline in the traced window:
LCNet's and NENet's products at the published widths (benchmark/
work_sdps.py), from the program's counters of the pixels each net ran on
(sdps.lcnet_px, sdps.nenet_px), at float32's TF32 peak (work.py's rule),
over the device time of the window's convolution kernels (work_sdps.
conv_kernel_seconds: cuDNN's implicit-GEMM, FFT and dgrad kernels, every
kernel of the window that is neither PyTorch's own nor a copy)."""

from benchmark import program_spans, readers, work
from benchmark.work_sdps import conv_flops, conv_kernel_seconds


def read(run):
    s, units = readers.traced(run)
    if s is None:
        return None
    flops = conv_flops(run.cfg, program_spans.count_per_unit(
        run, "sdps.lcnet_px"), program_spans.count_per_unit(
        run, "sdps.nenet_px"))
    secs, n = conv_kernel_seconds(s)
    if flops is None or not n:
        return None
    return readers.share(units * work.least_seconds({"tf32": flops}), secs)
