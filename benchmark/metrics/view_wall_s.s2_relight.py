"""The wall time of a relit view in the traced run: the window over the
views render_envmap returned, the profiler's cost included. The host's
four render_view enqueues and the PNG hold part of each view; the card's
kernel time per view (eval_view_kernel_ms) is the cell's end-to-end
metric."""


def read(run):
    w = run.window or {}
    if not w.get("attempted"):
        return None
    return w["elapsed"] / w["attempted"]
