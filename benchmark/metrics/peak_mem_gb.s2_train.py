"""The stage-2 cell's device memory peak in GB (1e9 bytes): the
allocator's largest allocated total over set-up and the window, as the
traffic records it at the window's close. Nothing on a run without a
card."""


def read(run):
    return run.work.get("peak_mem_gb")
