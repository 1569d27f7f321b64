"""The program's own launch counters, read by name. A counter the program
no longer has reads as absent, and the metric that needs it reports
nothing."""

from __future__ import annotations

import importlib


def read() -> dict:
    out = {}
    for mod, attr, key in (
            ("psnerf_torch.ops.fused_occ", "fused_occ_logit", "k1"),
            ("psnerf_torch.ops.fused_vis", "fused_visibility", "k4"),
            ("psnerf_torch.ops.fused_vis", "fused_vis_shade", "k5")):
        try:
            n = getattr(getattr(importlib.import_module(mod), attr),
                        "launches")
        except (ImportError, AttributeError):
            continue
        if isinstance(n, int):
            out[key] = n
    try:
        fr = importlib.import_module("psnerf_torch.ops.fused_radiance")
        for name, key in (("radiance_forward", "k2"),
                          ("radiance_backward", "k3")):
            d = getattr(getattr(fr, name), "launches")
            out[key] = sum(d.values()) if isinstance(d, dict) else int(d)
    except (ImportError, AttributeError):
        pass
    return out
