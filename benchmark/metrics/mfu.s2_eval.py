"""The evaluated view's share of the card's peak: the operations of every
view in the traced window (the per-pixel heads in float32 at TF32, the
visibility trunk at bf16 once a surface pixel and light) over the
window."""

from benchmark import readers, work


def read(run):
    s, _ = readers.traced(run)
    if s is None or "views" not in run.work:
        return None
    least = sum(work.least_seconds(work.psnet_view(
        run.cfg, run.work["n_surface"][v], run.work["n_lights"][v]))
        for v in run.work["views"])
    return readers.share(least, s["window_s"])
