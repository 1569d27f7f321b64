"""Plain reference of PS-NeRF's stage 2 (the PSNet: albedo, SG-weight,
normal and visibility MLPs, spherical-Gaussian shading), its losses and
the gated Adam over the network and the light tables, in float32 with
TF32 off. `vis_bf16` is the visibility trunk at the configuration's bf16
evaluation form: the point embedding, each layer's input and the
trunk's weights rounded to bf16, products accumulated in float32; the
light halves of the first and the skip layer (light embedding times the
layer's light rows, plus the bias) stay float32; the output row is
rounded to bf16 and dotted in float32 with the unrounded activations.
Weights are a flat {leaf name: tensor} dict under the checkpoint's names
(albedo/<i>/w, ..., light_dirs, light_ints).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.common import (adam, adam_state, bf, embed,
                                        embed_dim, multistep, skip_mlp,
                                        skip_mlp_dims, uniform_init)

SG_LOBES = [math.exp(i) for i in range(2, 11)]


class Net:
    """Sizes of the PSNet from the configuration's blocks."""

    def __init__(self, cfg: dict):
        b, n, v = cfg["brdf"], cfg["normal"], cfg["visibility"]
        tr = cfg["train"]
        self.nbasis = tr["nbasis"]
        self.rgb_spec = tr["specular_rgb"]
        self.freqs = b["net"]["n_freqs_xyz"]
        self.freqs_n = n["net"]["n_freqs_xyz"]
        e, en = embed_dim(3, self.freqs), embed_dim(3, self.freqs_n)
        self.e = e
        self.jitter = b["net"]["xyz_jitter_std"]
        self.light_int = b["light_intensity"]
        sk = lambda s: (s,) if s >= 0 else ()
        self.skips = {"albedo": sk(b["net"]["mlp_skip_at"]),
                      "rough": sk(b["sgnet"]["mlp_skip_at"]),
                      "normal": sk(n["net"]["mlp_skip_at"]),
                      "visibility": sk(v["net"]["mlp_skip_at"])}
        nw = self.nbasis * (3 if self.rgb_spec else 1)
        self.dims = {
            "albedo": skip_mlp_dims(e, 3, b["net"]["mlp_width"],
                                    b["net"]["mlp_depth"],
                                    self.skips["albedo"]),
            "rough": skip_mlp_dims(e, nw, b["sgnet"]["mlp_width"],
                                   b["sgnet"]["mlp_depth"],
                                   self.skips["rough"]),
            "normal": skip_mlp_dims(en, 3, n["net"]["mlp_width"],
                                    n["net"]["mlp_depth"],
                                    self.skips["normal"]),
            "visibility": skip_mlp_dims(2 * e, 1, v["net"]["mlp_width"],
                                        v["net"]["mlp_depth"],
                                        self.skips["visibility"])}


HEADS = ("albedo", "rough", "normal", "visibility")


def init_weights(net: Net, seed: int, dev) -> dict:
    """torch.nn.Linear's default init of every head, from one draw."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = [d for h in HEADS for d in net.dims[h]]
    layers = iter(uniform_init(flat, gen, dev))
    out = {}
    for h in HEADS:
        for i in range(len(net.dims[h])):
            w, b = next(layers)
            out[f"{h}/{i}/w"], out[f"{h}/{i}/b"] = w, b
    return out


def layers(W, head):
    n = sum(1 for k in W if k.startswith(head + "/") and k.endswith("/w"))
    return [(W[f"{head}/{i}/w"], W[f"{head}/{i}/b"]) for i in range(n)]


def unit(v, eps=1e-12):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), eps)


def camera_rays(uv, pose, K):
    """Unit world rays of pixels uv [N, 2] through fx, fy, cx, cy."""
    x = (uv[:, 0] - K[0, 2]) / K[0, 0]
    y = (uv[:, 1] - K[1, 2]) / K[1, 1]
    d = torch.stack([x, y, torch.ones_like(x)], -1) @ pose[:3, :3].T
    return unit(d)


def vis_f32(W, net, point_emb, l):
    """Raw visibility [L, N, 1] of (point, light) rows, float32."""
    x = torch.cat([point_emb[None].expand(l.shape[0], -1, -1),
                   embed(l, net.freqs)], -1)
    return skip_mlp(layers(W, "visibility"), x, net.skips["visibility"])


def vis_bf16(W, net, point_emb, light_dirs, chunk=8):
    """Raw visibility [L, N] at the bf16 evaluation form."""
    e = net.e
    lay = layers(W, "visibility")
    skip = net.skips["visibility"][0] + 1
    width = lay[1][0].shape[0]
    em = bf(point_emb)
    le = embed(light_dirs, net.freqs)
    w0, b0 = lay[0]
    ws, bs = lay[skip]
    a0 = em @ bf(w0[:e])
    p5 = em @ bf(ws[width:width + e])
    r0 = le @ w0[e:] + b0
    r5 = le @ ws[width + e:] + bs
    w8, b8 = lay[-1]
    out = []
    for s in range(0, light_dirs.shape[0], chunk):
        y = torch.relu(a0[None] + r0[s:s + chunk, None])
        for i in range(1, len(lay) - 1):
            w, b = lay[i]
            if i == skip:
                z = (bf(y) @ bf(w[:width]) + p5[None]) + r5[s:s + chunk, None]
            else:
                z = bf(y) @ bf(w) + b
            y = torch.relu(z)
        out.append(torch.sum(y * bf(w8[:, 0]), -1) + b8[0])
    return torch.cat(out)


def point_heads(W, net, points):
    pe = embed(points, net.freqs)
    out = {"pe": pe,
           "albedo": skip_mlp(layers(W, "albedo"), pe, net.skips["albedo"],
                              "sigmoid"),
           "weights": torch.relu(skip_mlp(layers(W, "rough"), pe,
                                          net.skips["rough"]))}
    pn = embed(points, net.freqs_n)
    out["normal"] = unit(skip_mlp(layers(W, "normal"), pn,
                                  net.skips["normal"]))
    return out


def shade(net, heads, view, light_dirs, light_ints, vis):
    """SG shading of L lights over N points: rgb [L, N, 3] and the
    specular term [L, N, 3]; vis [L, N, 1] raw."""
    n_l, n = light_dirs.shape[0], view.shape[0]
    l = light_dirs[:, None, :].expand(n_l, n, 3)
    nrm = heads["normal"][None]
    h = unit(l + view[None])
    hn = torch.sum(h * nrm, -1, keepdim=True)
    lobes = torch.tensor(SG_LOBES[:net.nbasis], device=view.device)
    d = torch.exp(lobes * (hn - 1.0))
    w = heads["weights"][None]
    if net.rgb_spec:
        w = w.reshape(*w.shape[:-1], 3, net.nbasis)
        spec = torch.clamp_min(torch.sum(w * d[..., None, :], -1), 0.0)
    else:
        spec = torch.clamp_min(torch.sum(w * d, -1, keepdim=True), 0.0)
    brdf = heads["albedo"][None] + spec
    cos = torch.sum(l * nrm, -1, keepdim=True)
    li = light_ints[:, None, None] if light_ints.ndim == 1 \
        else light_ints[:, None, :]
    rgb = torch.clamp(brdf * li * cos * torch.clamp(vis, 0, 1).detach(), 0, 1)
    return rgb, spec.expand(*spec.shape[:-1], 3)


def masked_mean(x, m):
    m = m.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    den = torch.sum(m.expand(x.shape))
    return torch.where(den > 0, torch.sum(x * m) / torch.clamp_min(den, 1.0),
                       0.0)


def step_loss(W, net, cfg, b, noise):
    """The training loss of one batch (warm-up over): rgb L1, albedo and
    SG-weight smoothness, the vis_plus visibility term and the normal
    term."""
    ls = cfg["loss"]
    ldirs = unit(W["light_dirs"][b["l_slt"]])
    lints = W["light_ints"][b["l_slt"]][:, 0]
    view = -camera_rays(b["uv"], b["pose"], b["K"])
    heads = point_heads(W, net, b["points"])
    vis = vis_f32(W, net, heads["pe"], ldirs[:, None, :].expand(
        -1, b["points"].shape[0], 3).detach())
    rgb, _ = shade(net, heads, view, ldirs, lints, vis)
    m1 = b["surface_mask"][:, None]
    rgb = torch.where(m1[None], rgb, 1.0)
    mask = b["surface_mask"] & b["object_mask"]
    total = ls["sg_rgb_weight"] * masked_mean(torch.abs(rgb - b["rgb_gt"]),
                                              mask[None, :])
    pej = embed(b["points"] + net.jitter * noise["xyz"], net.freqs)
    alb_j = skip_mlp(layers(W, "albedo"), pej, net.skips["albedo"], "sigmoid")
    rgh_j = torch.relu(skip_mlp(layers(W, "rough"), pej, net.skips["rough"]))
    alb = torch.where(m1, heads["albedo"], 1.0)
    total = total + ls["albedo_smooth_weight"] * masked_mean(
        torch.abs(alb - torch.where(m1, alb_j, 1.0)), mask)
    sgw = torch.where(m1, heads["weights"], 0.0)
    total = total + ls["rough_smooth_weight"] * masked_mean(
        torch.abs(sgw - torch.where(m1, rgh_j, 1.0)), mask)
    lv = b["light_vis_train"][:, None, :].expand(-1, b["points"].shape[0], 3)
    vt = torch.where(b["surface_mask"][None],
                     vis_f32(W, net, heads["pe"], lv)[..., 0], 1.0)
    total = total + ls["vis_weight"] * masked_mean(
        torch.abs(vt - b["vis_train_gt"]), mask[None, :])
    ngt = unit(b["normal"])
    npred = torch.where(m1, heads["normal"], 1.0)
    total = total + cfg["normal"]["loss"]["normal_weight"] * masked_mean(
        (npred - ngt) ** 2, mask)
    return total


def train_steps(W0, net, cfg, batches, noises, it0, n_views, light_bs):
    """Follow the program's first steps from W0 with Adam from zero: each
    step's loss, the first step's gradients, the weights after."""
    tr = cfg["train"]
    W = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    st = adam_state(W)
    miles = [m * n_views * light_bs for m in tr["sg_sched_milestones"]]
    gamma = tr["sg_sched_factor"]
    losses, g1 = [], None
    for i, (b, nz) in enumerate(zip(batches, noises)):
        it = it0 + i
        total = step_loss(W, net, cfg, b, nz)
        grads = dict(zip(W, torch.autograd.grad(total, list(W.values()))))
        if g1 is None:
            g1 = {k: g.detach().clone() for k, g in grads.items()}
        row = torch.zeros((W["light_dirs"].shape[0], 1), device=total.device)
        row[b["l_slt"]] = 1.0
        model = {k: v for k, v in W.items() if not k.startswith("light_")}
        adam(model, grads, st, multistep(tr["sg_learning_rate"], miles,
                                         gamma, it))
        for name, base in (("light_dirs", tr["light_learning_rate"]),
                           ("light_ints", tr["light_inten_lr"])):
            adam({name: W[name]}, grads, st,
                 multistep(base, miles, gamma, it), gate={name: row})
        losses.append(float(total.detach()))
    return losses, g1, {k: v.detach() for k, v in W.items()}


@torch.no_grad()
def render_eval(W, net, points, normals_pregen, uv, pose, K, light_dirs,
                light_ints):
    """Every output render_view returns, at sampled surface pixels, under
    every light: rgb [L, N, 3], albedo [N, 3], rough [L, N, 3],
    visibility [L, N, 1] (raw), normal_pred [N, 3]."""
    heads = point_heads(W, net, points)
    vis = vis_bf16(W, net, heads["pe"], light_dirs)[..., None]
    view = -camera_rays(uv, pose, K)
    rgb, spec = shade(net, heads, view, light_dirs, light_ints, vis)
    return {"rgb": rgb, "albedo": heads["albedo"], "rough": spec,
            "visibility": vis, "normal_pred": heads["normal"]}


def lift_visibility(W, net, points, light_dirs, n_pix=4096) -> float:
    """Shift the visibility output bias in W so that its raw output over
    `points` [N, 3] and `light_dirs` [L, 3] has median 0.5: at this init
    it clips to about 0, and a comparison of zeros proves nothing."""
    sel = points[::max(1, points.shape[0] // n_pix)]
    pe = embed(sel, net.freqs)
    l = light_dirs[:, None, :].expand(-1, sel.shape[0], 3)
    raw = vis_f32(W, net, pe, l)
    shift = 0.5 - raw.median().item()
    last = len(net.dims["visibility"]) - 1
    W[f"visibility/{last}/b"] = W[f"visibility/{last}/b"] + shift
    return shift


def load_views(scene_dir, export_dir, views, dev, images=True):
    """Stage-2 arrays of a generated scene's views, from its own files:
    masks, the shape export (points, normals, mask), the images, poses."""
    import json
    import os

    from PIL import Image

    with open(os.path.join(scene_dir, "params.json")) as f:
        p = json.load(f)
    n_l = len(p["light_direction"])
    out = {k: [] for k in ("object_mask", "points", "normals",
                           "surface_mask", "imgs")}
    for v in views:
        name = f"view_{v + 1:02d}"
        m = np.asarray(Image.open(os.path.join(scene_dir, "mask",
                                               name + ".png")))
        out["object_mask"].append((m[..., 0] if m.ndim == 3 else m)
                                  .reshape(-1) > 0)
        for k, sub in (("points", "points"), ("normals", "normal"),
                       ("surface_mask", "mask")):
            out[k].append(np.load(os.path.join(export_dir, sub,
                                               name + ".npy")))
        if images:
            d = os.path.join(scene_dir, f"img_intnorm_sdps_l{n_l}", name)
            out["imgs"].append(np.stack([
                np.asarray(Image.open(os.path.join(d, f"{i + 1:03d}.png")),
                           np.uint8)[..., :3].reshape(-1, 3)
                for i in range(n_l)]))
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    res = {k: t(v) for k, v in out.items() if v}
    res["surface_mask"] = res["surface_mask"].bool()
    poses = np.asarray(p["pose_c2w"], np.float32)
    cv = poses.copy()
    cv[:, :3, 1:3] *= -1.0
    res.update(poses_cv=t(cv[views]), poses_gl=poses[views], params=p,
               K=t(np.asarray(p["K"], np.float32)))
    return res
