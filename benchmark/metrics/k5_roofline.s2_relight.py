"""K5's (fused_vis_shade, the light sum) share of its roofline in the
traced window: the visibility trunk's operations at bf16 over every
surface pixel and texel of each relit view (the point halves once a pixel,
the rest once a pixel and texel; inputs read and the light sums written
once) over the device time of the kernel (vis_kernel)."""

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
    nl = run.work["n_texels"]
    least = 0.0
    for v in run.work["views"]:
        px = run.work["n_surface"][v]
        flops = px * (o.vis_point + nl * o.vis_pair)
        # point embeddings and the texels' halves in, rgb sums out
        nbytes = 4 * (px * o.e + 2 * nl * width + 3 * px)
        least += work.least_seconds({"bf16": flops}, nbytes)
    return readers.share(least, secs)
