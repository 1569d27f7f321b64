"""The wall time of an evaluated view in the traced run: the window over
the views render_view returned, the profiler's cost included. The
host's dispatch holds the view, and the host's speed moves this number
too far from run to run to bound it; the card's kernel time per view
(eval_view_kernel_ms) is the cell's end-to-end metric."""


def read(run):
    w = run.window or {}
    if not w.get("attempted"):
        return None
    return w["elapsed"] / w["attempted"]
