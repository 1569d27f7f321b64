"""The visibility kernels' (K4/K5, whichever the route launches) share of
their roofline in the traced window: the trunk's operations at bf16 (the
point halves once a pixel, the rest once a pixel and light; inputs read
and outputs written once) over the kernels' device time."""

from benchmark import readers, work


def read(run):
    s, _ = readers.traced(run)
    if s is None or "views" not in run.work:
        return None
    secs, n = readers.kernel_seconds(s, ("vis_kernel",))
    if not n:
        return None
    o = work.PSNetOps(run.cfg)
    width = run.cfg["visibility"]["net"]["mlp_width"]
    least = 0.0
    for v in run.work["views"]:
        px, nl = run.work["n_surface"][v], run.work["n_lights"][v]
        flops = px * (o.vis_point + nl * o.vis_pair)
        # point embeddings and the lights' halves in, raw visibility out
        nbytes = 4 * (px * o.e + 2 * nl * width + nl * px)
        least += work.least_seconds({"bf16": flops}, nbytes)
    return readers.share(least, secs)
