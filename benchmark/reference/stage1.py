"""Plain reference of PS-NeRF's stage 1 (the UNISURF occupancy field, its
surface-guided renderer, the root-finding march, the light-visibility
march of the shape export), the stage-1 loss and Adam, in float32 with
TF32 off. The march's occupancy queries run at the configuration's bf16
trunk: the weight-normed dense weights, the point embedding and each
layer's input rounded to bf16, products accumulated in float32, the skip
layer's 1/sqrt(2) folded into its weights, the logit row rounded to bf16
and dotted in float32. Weights are a flat {leaf name: tensor} dict under
the checkpoint's names (geo/<i>/v, .../g, .../b; app/<i>/...).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import (adam, adam_state, bf, composite,
                                        embed, embed_dim, linspace_between,
                                        multistep, sphere_far, stratified,
                                        uniform_init, wn_dense)

TAU = 0.5
SQRT2 = math.sqrt(2.0)


class Field:
    """Sizes of the occupancy field from the configuration's model block."""

    def __init__(self, model: dict):
        self.n_layers = model["num_layers"]
        self.width = model["hidden_dim"]
        self.oct = model["octaves_pe"]
        self.oct_view = model["octaves_pe_views"]
        self.skips = tuple(model["skips"])
        self.feat = model["feat_size"]
        self.e = embed_dim(3, self.oct)
        dims = [self.e] + [self.width] * self.n_layers + [self.feat + 1]
        self.geo = [(dims[l], dims[l + 1] - dims[0] if l + 1 in self.skips
                     else dims[l + 1]) for l in range(len(dims) - 1)]
        d_app = 3 + embed_dim(3, self.oct_view) + 3 + self.feat
        app = [d_app] + [self.width] * 4 + [3]
        self.app = list(zip(app[:-1], app[1:]))


def silhouette(view, n: int, dev) -> torch.Tensor:
    """n unit vectors on the great circle perpendicular to `view` [3]."""
    v = torch.as_tensor(view, dtype=torch.float32, device=dev)
    v = v / torch.linalg.norm(v)
    a = torch.tensor([0.0, 0.0, 1.0], device=dev)
    if abs(float(v @ a)) > 0.9:
        a = torch.tensor([1.0, 0.0, 0.0], device=dev)
    u = torch.linalg.cross(v, a)
    u = u / torch.linalg.norm(u)
    w = torch.linalg.cross(v, u)
    t = torch.arange(n, device=dev, dtype=torch.float32) * (2 * math.pi / n)
    return torch.cos(t)[:, None] * u + torch.sin(t)[:, None] * w


def init_weights(fld: Field, seed: int, dev, view, sphere: float = 0.6
                 ) -> dict:
    """The geometric (sphere) init of the geometry MLP and torch's default
    init of the appearance MLP, each from one draw on the device, as
    weight-normed leaves (v = w, g = ||w|| per column). The logit's bias
    is then shifted so that the logit's median is 0 on the circle of
    radius `sphere` that faces `view` (the first camera's direction from
    the origin), the silhouette that camera sees: the random hidden layers
    move the surface by about a tenth of its radius from seed to seed, and
    with it the surface pixels that the export marches toward every
    light."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((sum(i * o for i, o in fld.geo),), generator=gen,
                    device=dev)
    out, s, n = {}, 0, len(fld.geo)
    for l, (din, dout) in enumerate(fld.geo):
        r = z[s:s + din * dout].reshape(din, dout)
        s += din * dout
        b = torch.zeros((dout,), device=dev)
        if l == n - 1:
            w = math.sqrt(math.pi) / math.sqrt(din) + 1e-4 * r
            b = torch.full((dout,), -sphere, device=dev)
        elif l == 0:
            w = torch.zeros_like(r)
            w[:3] = math.sqrt(2) / math.sqrt(dout) * r[:3]
        else:
            w = math.sqrt(2) / math.sqrt(dout) * r
            if l in fld.skips:
                w[-(fld.e - 3):] = 0.0
        out.update({f"geo/{l}/v": w.contiguous(),
                    f"geo/{l}/g": torch.linalg.norm(w, dim=0),
                    f"geo/{l}/b": b})
    for l, (w, b) in enumerate(uniform_init(fld.app, gen, dev)):
        out.update({f"app/{l}/v": w, f"app/{l}/g": torch.linalg.norm(w, dim=0),
                    f"app/{l}/b": b})
    with torch.no_grad():
        f = geometry(out, fld, sphere * silhouette(view, 4096, dev))[..., 0]
        out[f"geo/{n - 1}/b"][0] -= f.median()
    return out


def _dense(W, kind, l):
    return wn_dense(W[f"{kind}/{l}/v"], W[f"{kind}/{l}/g"]), W[f"{kind}/{l}/b"]


def geometry(W, fld: Field, p):
    """Geometry MLP: [..., 3] -> [..., 1 + feat] (logit first)."""
    pe = embed(p, fld.oct)
    x = pe
    for l in range(len(fld.geo)):
        if l in fld.skips:
            x = torch.cat([x, pe], dim=-1) / SQRT2
        w, b = _dense(W, "geo", l)
        x = x @ w + b
        if l < len(fld.geo) - 1:
            x = F.softplus(x, beta=100.0, threshold=20.0)
    return x


def logit_bf16(W, fld: Field, p):
    """The occupancy logit at the march's bf16 trunk."""
    em = bf(embed(p, fld.oct))
    n = len(fld.geo)
    y = None
    for l in range(n - 1):
        w, b = _dense(W, "geo", l)
        if l == 0:
            h = em @ bf(w) + b
        elif l in fld.skips:
            w = w / SQRT2
            k = w.shape[0] - fld.e
            h = (bf(y) @ bf(w[:k]) + b) + em @ bf(w[k:])
        else:
            h = bf(y) @ bf(w) + b
        y = F.softplus(h, beta=100.0, threshold=20.0)
    w, b = _dense(W, "geo", n - 1)
    return torch.sum(y * bf(w[:, 0]), dim=-1) + b[0]


def alpha_bf16(W, fld, p, block: int = 1 << 21):
    out = [torch.sigmoid(-10.0 * logit_bf16(W, fld, p[s:s + block]))
           for s in range(0, p.shape[0], block)]
    return torch.cat(out) if out else p.new_zeros((0,))


def logit_and_grad(W, fld, p, create_graph):
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        out = geometry(W, fld, q)
        g, = torch.autograd.grad(out[..., 0].sum(), q,
                                 create_graph=create_graph)
    return out, g


def appearance(W, fld, p, view_pe, normals, feat):
    x = torch.cat([p, view_pe, normals, feat], dim=-1)
    for l in range(len(fld.app)):
        w, b = _dense(W, "app", l)
        x = x @ w + b
        if l < len(fld.app) - 1:
            x = torch.relu(x)
    return torch.tanh(x) * 0.5 + 0.5


def _safe_div(a, b, eps=1e-12):
    small = torch.where(b < 0, -eps, eps)
    return a / torch.where(torch.abs(b) < eps, small, b)


@torch.no_grad()
def march(occ, cam, ray, n_steps, near, rad, phase=None, n_secant=8):
    """First inside crossing along unit rays from cam [N, 3]: the depth,
    +inf where none, 0 where the first sample is occupied. occ: points
    [M, 3] -> occupancy probability [M]."""
    n = cam.shape[0]
    _, d_far = sphere_far(cam[0], ray, rad)
    d = linspace_between(torch.full((n,), float(near), device=cam.device),
                         d_far,
                         n_steps)
    if phase is not None:
        shift = phase * ((d_far - near) / (n_steps - 1))[..., None]
        d = torch.cat([d[..., :1], d[..., 1:-1] + shift, d[..., -1:]], -1)
    p = cam[:, None, :] + ray[:, None, :] * d[..., None]
    val = occ(p.reshape(-1, 3)).reshape(n, n_steps) - TAU
    free0 = val[:, 0] < 0
    sign = torch.sign(val[:, :-1] * val[:, 1:])
    sign = torch.cat([sign, torch.ones_like(sign[:, :1])], dim=-1)
    cost = sign * torch.arange(n_steps, 0, -1, dtype=val.dtype,
                               device=val.device)
    idx = torch.argmin(cost, dim=-1)
    take = lambda a, i: torch.gather(a, 1, i[:, None])[:, 0]
    ok = (torch.amin(cost, dim=-1) < 0) & (take(val, idx) < 0) & free0
    d_lo, f_lo = take(d, idx), take(val, idx)
    hi = torch.clamp_max(idx + 1, n_steps - 1)
    d_hi, f_hi = take(d, hi), take(val, hi)
    d_pred = -f_lo * _safe_div(d_hi - d_lo, f_hi - f_lo) + d_lo
    for _ in range(n_secant):
        f_mid = occ(cam + d_pred[..., None] * ray) - TAU
        low = f_mid < 0
        d_lo = torch.where(low, d_pred, d_lo)
        f_lo = torch.where(low, f_mid, f_lo)
        d_hi = torch.where(low, d_hi, d_pred)
        f_hi = torch.where(low, f_hi, f_mid)
        d_pred = -f_lo * _safe_div(d_hi - d_lo, f_hi - f_lo) + d_lo
    return torch.where(free0, torch.where(ok, d_pred, torch.inf), 0.0)


def rays(pixels, K, pose):
    """Camera origins and unit world rays of pixels [N, 2] (x, y)."""
    p = (pixels - K[:2, 2]) / K[0, 0]
    p = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    ray = p @ pose[:3, :3].T
    ray = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    return pose[:3, 3].expand(pixels.shape[0], 3), ray


def surface(W, fld, rcfg, pixels, K, pose, n_steps, phase=None):
    cam, ray = rays(pixels, K, pose)
    d = march(lambda q: alpha_bf16(W, fld, q), cam, ray, n_steps,
              rcfg["near"], rcfg["radius"], phase)
    zero, hit = d == 0, torch.isfinite(d)
    smask = hit & ~zero
    dist = torch.where(zero, 0.0, torch.where(hit, d, 1.0))
    return cam, ray, dist, cam + ray * dist[..., None], smask


def render_train(W, fld, rcfg, pixels, K, pose, it, noise, use_outside):
    """The training render of pixels [N, 2]: rgb, normals, the normal
    pair's difference, surface mask (render/unisurf.py semantics)."""
    steps, steps_out = rcfg["num_points_in"], rcfg["num_points_out"]
    cam, ray, dist, pts, smask = surface(
        W, fld, rcfg, pixels, K, pose, rcfg["ray_marching_steps"],
        noise["phase"])
    n = pixels.shape[0]
    _, d_far = sphere_far(cam[0], ray, rcfg["radius"])
    it_t = torch.tensor(float(it), device=pixels.device)
    delta = torch.clamp_min(rcfg["interval_start"] * torch.exp(
        -rcfg["interval_decay"] * it_t), rcfg["interval_end"])
    dnp = torch.clamp_min(dist - delta, rcfg["near"])
    dfp = torch.minimum(dist + delta, d_far)
    near = torch.full_like(dnp, rcfg["near"])
    d_hit = linspace_between(dnp, dfp, steps)
    if use_outside:
        d_hit = torch.cat([linspace_between(near, dnp, steps_out), d_hit], -1)
    d_miss = linspace_between(near, d_far, steps + (steps_out if use_outside
                                                    else 0))
    d_all = torch.where(smask[:, None], stratified(d_hit, noise["hit"]),
                        stratified(d_miss, noise["miss"]))
    p = cam[:, None, :] + ray[:, None, :] * d_all[..., None]
    out, g = logit_and_grad(W, fld, p, True)
    nrm = g
    view = -ray[:, None, :].expand(p.shape)
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True)
    rgb = appearance(W, fld, p, embed(view, fld.oct_view), nrm, out[..., 1:])
    alpha = torch.sigmoid(-10.0 * out[..., 0])
    w = composite(alpha)
    acc = w.sum(-1)
    rgb = torch.sum(w[..., None] * rgb, dim=-2) + (1.0 - acc[..., None])
    pp = torch.cat([pts, pts + (noise["jitter"] - 0.5) * 0.01])
    _, g2 = logit_and_grad(W, fld, pp, True)
    nn_ = g2 / (torch.linalg.norm(g2, dim=-1, keepdim=True) + 1e-5)
    normal = torch.where(smask[:, None], nn_[:n], 0.0)
    diff = torch.sqrt(torch.sum((nn_[:n] - nn_[n:]) ** 2, -1) + 1e-12)
    return {"rgb": rgb, "normal": normal, "diff": diff, "mask": smask}


def loss(out, batch, lam):
    n = batch["rgb_gt"].shape[0]
    rgb = torch.sum(torch.abs(out["rgb"] - batch["rgb_gt"])) / n
    smooth = torch.sum(out["diff"]) / n
    total = lam["rgb"] * rgb + lam["smooth"] * smooth
    m = batch["norm_mask"].float()
    cnt = m.sum()
    diff = torch.sum(torch.abs(out["normal"] - batch["normal_gt"]), -1)
    nl = torch.where(cnt > 0, torch.sum(diff * m) / torch.clamp_min(cnt, 1.0),
                     0.0)
    return total + lam["normal"] * nl


def gather_batch(data, view, pixels, it, tcfg):
    """A training batch of `view` at pixels [N, 2] (x, y) from the scene's
    own arrays: rgb, the SDPS normal in the world frame and its gate."""
    px, py = pixels[:, 0].long(), pixels[:, 1].long()
    pose = data["poses"][view]
    n_cam = data["normals"][view][py, px]
    nm = (data["norm_mask"][view][py, px]
          & (n_cam[:, 2] >= math.cos(math.radians(tcfg["normal_angle"])))
          & (it >= tcfg["normal_after"]))
    flip = torch.tensor([1.0, -1.0, -1.0], device=pixels.device)
    return {"rgb_gt": data["imgs"][view][py, px],
            "normal_gt": n_cam @ (pose[:3, :3] * flip).T,
            "norm_mask": nm, "pose": pose}


def lambdas(training: dict) -> dict:
    return {"rgb": training["lambda_l1_rgb"],
            "smooth": training["lambda_normals"],
            "normal": training["lambda_normloss"]}


def train_steps(W0: dict, fld, cfg, data, draws, it0, n_views):
    """Follow the program's first len(draws) steps from weights W0 with
    Adam from zero: each step's loss, the first step's gradients and the
    weights after the last step."""
    rcfg, tcfg = cfg["rendering"], cfg["training"]
    W = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    st = adam_state(W)
    miles = [m * n_views for m in tcfg["scheduler_milestones"]]
    losses, g1 = [], None
    for i, d in enumerate(draws):
        it = it0 + i
        batch = gather_batch(data, d["view"], d["pixels"], it,
                             {"normal_angle": tcfg["normal_angle"],
                              "normal_after": tcfg["normal_after"]})
        out = render_train(W, fld, rcfg, d["pixels"], data["K"],
                           batch["pose"], it, d["noise"], d["use_outside"])
        total = loss(out, batch, lambdas(tcfg))
        grads = dict(zip(W, torch.autograd.grad(total, list(W.values()))))
        if g1 is None:
            g1 = {k: g.detach().clone() for k, g in grads.items()}
        adam(W, grads, st, multistep(tcfg["learning_rate"], miles,
                                     tcfg["scheduler_gamma"], it))
        losses.append(float(total.detach()))
    return losses, g1, {k: v.detach() for k, v in W.items()}


# ------------------------------------------------------------ shape export

@torch.no_grad()
def light_visibility(W, fld, surf, dirs, n_steps=128, lnear=0.1, lfar=3.5,
                     box=1.1):
    """Faithful transmittance [L, N] of points surf [N, 3] toward unit
    dirs [L, 3]: n_steps samples on [lnear, lfar], occupancy zero outside
    the +-box clip, 1 - the composited occupancy."""
    t = torch.linspace(lnear, lfar, n_steps, device=surf.device)
    out = []
    for l in range(dirs.shape[0]):
        p = torch.addcmul(surf[:, None, :], dirs[l][None, None, :],
                          t[None, :, None])
        a = alpha_bf16(W, fld, p.reshape(-1, 3)).reshape(p.shape[:2])
        a = torch.where(torch.all((p <= box) & (p >= -box), -1), a, 0.0)
        out.append(1.0 - composite(a).sum(-1))
    return torch.stack(out)


def shape_extract(W, fld, rcfg, pixels, K, pose, n_steps, block=8192):
    """Surface points, unit normals (0 off the surface) and mask of pixels
    [N, 2] by the export's march (no phase)."""
    pts, nrm, msk = [], [], []
    for s in range(0, pixels.shape[0], block):
        _, _, _, p, m = surface(W, fld, rcfg, pixels[s:s + block], K, pose,
                                n_steps)
        _, g = logit_and_grad(W, fld, p, False)
        g = g / torch.clamp_min(torch.linalg.norm(g, dim=-1, keepdim=True),
                                1e-12)
        pts.append(p)
        nrm.append(torch.where(m[:, None], g, 0.0))
        msk.append(m)
    return torch.cat(pts), torch.cat(nrm), torch.cat(msk)


def load_scene(scene_dir: str, dev, views=None) -> dict:
    """The stage-1 arrays of a generated scene: images (SDPS-normalised
    averages on white), masks, norm masks, SDPS normals, OpenCV poses, K."""
    import json
    import os

    from PIL import Image

    with open(os.path.join(scene_dir, "params.json")) as f:
        p = json.load(f)
    views = p["view_train"] if views is None else views
    n_l = len(p["light_direction"])
    rd = lambda path: np.asarray(Image.open(path), np.float32) / 255.0
    imgs, masks, nms, nrms = [], [], [], []
    for v in views:
        name = f"view_{v + 1:02d}"
        m = rd(os.path.join(scene_dir, "mask", name + ".png"))
        m = m[..., 0] if m.ndim == 3 else m
        img = rd(os.path.join(scene_dir, f"img_intnorm_sdps_l{n_l}", "avg",
                              name + ".png"))[..., :3]
        imgs.append(img * m[..., None] + (1.0 - m[..., None]))
        masks.append(m)
        nm = rd(os.path.join(scene_dir, "norm_mask", name + ".png"))
        nms.append((nm[..., 0] if nm.ndim == 3 else nm) > 0)
        nrms.append(np.load(os.path.join(scene_dir, f"sdps_out_l{n_l}",
                                         "outnpy", name + ".npy")))
    poses = np.asarray(p["pose_c2w"], np.float32)[views]
    poses[:, :3, 1:3] *= -1.0
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    return {"imgs": t(np.asarray(imgs, np.float32)), "masks": t(masks),
            "norm_mask": t(nms), "normals": t(np.asarray(nrms, np.float32)),
            "poses": t(poses), "K": t(np.asarray(p["K"], np.float32)),
            "params": p, "views": list(views)}
