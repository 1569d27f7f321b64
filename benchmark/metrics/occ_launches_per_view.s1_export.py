"""K1 launches an exported view takes in the window, from the program's
own counter fused_occ_logit.launches."""


def read(run):
    n = run.counters.get("k1")
    views = (run.window or {}).get("attempted", 0)
    if n is None or not views:
        return None
    return n / views
