"""The yardstick's arithmetic: the H100's published peaks and the model's
operations at unpadded widths, from a configuration's own sizes.

An MLP product [n, din] x [din, dout] is 2 n din dout operations. A
training pass counts each product of the forward graph once forward and
twice backward (the input's and the weight's gradients), and the stage-1
normals' first-order gradient is part of that forward graph. Recompute is
not counted. Each product counts against the peak of the precision the
configuration states for it: bf16 for the hand-written trunks (the
stage-1 march's occupancy queries, the stage-2 visibility trunk at
evaluation), TF32 for float32 products (the fastest rate any
float32-faithful implementation can use on this card).
"""

from __future__ import annotations

from benchmark.reference.common import embed_dim, skip_mlp_dims
from benchmark.reference.stage1 import Field

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12


def products(dims) -> float:
    """Operations of one row through layers [(din, dout), ...]."""
    return 2.0 * sum(i * o for i, o in dims)


def least_seconds(flops: dict, nbytes: float = 0.0) -> float:
    """The least time the card needs for {precision: operations} and
    nbytes of traffic: the larger of the two bounds."""
    t = sum(f / PEAK_FLOPS[p] for p, f in flops.items())
    return max(t, nbytes / PEAK_BYTES)


class Unisurf:
    """Per-point operations of the stage-1 field (model block)."""

    def __init__(self, model: dict):
        fld = Field(model)
        geo, app = fld.geo, fld.app
        logit_dims = geo[:-1] + [(geo[-1][0], 1)]
        self.logit = products(logit_dims)      # the logit alone
        self.full = products(geo)              # logit and feature
        self.grad = products(logit_dims)       # d logit / d p
        self.app = products(app)
        self.n_params = sum(i * o + 2 * o for i, o in geo + app)


def unisurf_step(cfg: dict) -> dict:
    """{precision: operations} of one stage-1 training step at the late
    sample grid (inside and outside points), with its march."""
    u = Unisurf(cfg["model"])
    r, t = cfg["rendering"], cfg["training"]
    n = t["n_training_points"]
    n_rad = n * (r["num_points_in"] + r["num_points_out"])
    radiance = 3 * n_rad * (u.full + u.grad + u.app)
    normals = 3 * 2 * n * (u.logit + u.grad)
    march = n * (r["ray_marching_steps"] + 8) * u.logit
    return {"tf32": radiance + normals, "bf16": march,
            "radiance": radiance, "march_points": n * (
                r["ray_marching_steps"] + 8)}


class PSNetOps:
    """Per-row operations of the stage-2 heads (configuration blocks)."""

    def __init__(self, cfg: dict):
        b, nm, v, tr = cfg["brdf"], cfg["normal"], cfg["visibility"], \
            cfg["train"]
        e = embed_dim(3, b["net"]["n_freqs_xyz"])
        en = embed_dim(3, nm["net"]["n_freqs_xyz"])
        self.e = e
        sk = lambda s: (s,) if s >= 0 else ()
        nw = tr["nbasis"] * (3 if tr["specular_rgb"] else 1)
        self.albedo = products(skip_mlp_dims(
            e, 3, b["net"]["mlp_width"], b["net"]["mlp_depth"],
            sk(b["net"]["mlp_skip_at"])))
        self.rough = products(skip_mlp_dims(
            e, nw, b["sgnet"]["mlp_width"], b["sgnet"]["mlp_depth"],
            sk(b["sgnet"]["mlp_skip_at"])))
        self.normal = products(skip_mlp_dims(
            en, 3, nm["net"]["mlp_width"], nm["net"]["mlp_depth"],
            sk(nm["net"]["mlp_skip_at"])))
        vdims = skip_mlp_dims(2 * e, 1, v["net"]["mlp_width"],
                              v["net"]["mlp_depth"],
                              sk(v["net"]["mlp_skip_at"]))
        self.vis = products(vdims)
        width = v["net"]["mlp_width"]
        skip = v["net"]["mlp_skip_at"] + 1
        # the evaluation form: the point halves of the first and the skip
        # layer once a pixel, the rest once a (pixel, light) pair
        self.vis_point = products([(e, width), (e, width)])
        self.vis_light = products([(e, width), (e, width)])
        self.vis_pair = self.vis - self.vis_point - self.vis_light
        self.jitter = b["net"]["xyz_jitter_std"] > 0
        self.skip = skip


def psnet_step(cfg: dict, n_pixels: int, n_lights: int, n_vis: int) -> dict:
    """{precision: operations} of one stage-2 training step: the heads and
    their jittered copies trained; the visibility of the rendering lights
    forward only (its clipped output is detached from the rgb), that of
    the vis_plus rows trained."""
    o = PSNetOps(cfg)
    heads = 3 * (o.albedo + o.rough + o.normal)
    if o.jitter:
        heads += 3 * (o.albedo + o.rough)
    vis = (n_lights + 3 * n_vis) * o.vis
    return {"tf32": n_pixels * (heads + vis)}


def psnet_view(cfg: dict, n_surface: int, n_lights: int) -> dict:
    """{precision: operations} of one evaluated view: the per-pixel heads
    in float32, the visibility trunk at bf16 once a (pixel, light)."""
    o = PSNetOps(cfg)
    return {"tf32": n_surface * (o.albedo + o.rough + o.normal)
            + n_lights * o.vis_light,
            "bf16": n_surface * (o.vis_point + n_lights * o.vis_pair)}


def export_view(cfg: dict, n_pixels: int, n_surface: int, n_dirs: int,
                march_steps: int = 512, vis_steps: int = 128) -> dict:
    """{precision: operations} of one exported view: the march of every
    pixel and the visibility of every surface pixel toward every direction
    (occupancy logits at bf16), the normals in float32."""
    u = Unisurf(cfg["model"])
    k1 = (n_pixels * (march_steps + 8) + n_surface * n_dirs * vis_steps)
    return {"bf16": k1 * u.logit, "tf32": n_pixels * (u.logit + u.grad),
            "k1_points": k1}
