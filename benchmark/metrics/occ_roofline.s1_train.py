"""K1's share of its roofline in the traced window: the march's occupancy
logits (operations at bf16; each point's position in and logit out once)
over K1's device time."""

from benchmark import readers, work


def read(run):
    s, steps = readers.traced(run)
    if s is None:
        return None
    secs, n = readers.kernel_seconds(s, ("occ_kernel",))
    if not n:
        return None
    f = work.unisurf_step(run.cfg)
    least = work.least_seconds({"bf16": f["bf16"]},
                               f["march_points"] * 16)
    return readers.share(least * steps, secs)
