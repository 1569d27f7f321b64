"""The host's share of render_view in ms a view: the benchmark's spans
around render_view and around the frame renderer it calls (synchronised
after it), in the traced run; the gap is the device-to-host copies and
the host scatter."""


def read(run):
    rv, fr = run.spans.get("render_view"), run.spans.get("frame")
    if not rv or not fr or len(rv) != len(fr):
        return None
    return 1e3 * (sum(rv) - sum(fr)) / len(rv)
