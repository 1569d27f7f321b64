"""The stage-1 step's share of the card's peak: the model's operations of
every step in the traced window (the radiance pass with its normals'
gradient and the backward at TF32, the march's occupancy queries at
bf16) over the window."""

from benchmark import readers, work


def read(run):
    s, steps = readers.traced(run)
    if s is None:
        return None
    f = work.unisurf_step(run.cfg)
    least = work.least_seconds({"tf32": f["tf32"], "bf16": f["bf16"]})
    return readers.share(least * steps, s["window_s"])
