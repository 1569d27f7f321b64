"""Plain reference of SDPS-Net (Chen et al., "Self-calibrating Deep
Photometric Stereo Networks", CVPR 2019: models/LCNet.py and
models/NENet.py of https://github.com/guanyingc/SDPS-Net) as PS-NeRF's
preprocessing runs it on one view (preprocessing/test.py, test_utils.py,
datasets/UPS_Custom_Dataset.py), in float32 with TF32 off.

LCNet: a 7-conv extractor on each light's image and the mask (4 channels)
at 128x128, the features max-fused over the lights and concatenated back to
each light's (512 channels), a 4-conv classifier, three 1x1-conv heads
(azimuth, elevation, intensity classes). NENet: each image divided by its
light's intensity with the direction concatenated (6 channels), a 5-conv
extractor, a k4 s2 transposed conv and a 3x3 conv, the max over the lights,
then the regressor (two 3x3 convs, a transposed conv, a 3x3 conv to 3
channels without a bias), normalised. Leaky ReLU 0.1 after every layer but
the heads' last and the normal's. Widths, strides and classes come from
the configuration (benchmark/configs/sdps_bear.json).

Every convolution is an explicit im2col, F.unfold and a matmul, and every
transposed convolution a matmul and F.fold (col2im), so nothing here
shares cuDNN's choice of algorithm with the program. The lights are the
batch axis and run in blocks, so that a view at its full crop fits; the
max over the lights is taken block by block.

Weights are flat {leaf: tensor} dicts at the program's leaf paths
(LCNet: feat/<i>/{w,b}, cls/<i>/{w,b}, heads/<dir_x|dir_y|ints>/<0|1>/
{w,b}; NENet: feat/<i>/{w,b}, feat_deconv/w, feat_out/{w,b}, reg/<i>/{w,b},
reg_deconv/w, est_normal/w) in the layouts of torch's Conv2d (OIHW) and
ConvTranspose2d (IOHW).

Departures from the published code, each within float32's rounding:
- the crop (UPS_Custom_Dataset.py) is taken from the mask's bounding box
  in torch, 15 px around it, and padded with pms_transforms.
  imgSizeToFactorOfK's quirk: when either side is not a multiple of 4,
  both are padded by 4 - side % 4 (an aligned side gains 4);
- LCNet's rescale to 128x128 is F.interpolate(bilinear, align_corners=
  True), the semantics of the published F.upsample at the time;
- NENet's intensity division is a multiply by 1 / (intensity + 1e-8), as
  the published diagonal matmul computes it;
- NENet is fed the light directions and intensities it is given (the
  program's, decoded from its own classes), so that one near-tie of the
  classes cannot move every normal; `lights` decodes the reference's own
  classes with the published codec, in float64, for the comparison of
  the lights themselves.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LIGHT_BLOCK = {"lcnet": 32, "nenet": 8}


def _pairs(spec):
    return [(int(c), int(s)) for c, s in spec]


def shapes(cfg: dict) -> dict:
    """{"lcnet": {leaf: shape}, "nenet": {leaf: shape}} of the published
    widths."""
    lc, ne = cfg["lcnet"], cfg["nenet"]
    out = {"lcnet": {}, "nenet": {}}

    def conv(net, name, cin, cout, k, bias=True):
        out[net][name + "/w"] = (cout, cin, k, k)
        if bias:
            out[net][name + "/b"] = (cout,)

    cin = lc["c_in"]
    for i, (cout, _) in enumerate(_pairs(lc["feat"])):
        conv("lcnet", f"feat/{i}", cin, cout, 3)
        cin = cout
    cin *= 2                                   # feat_i ++ fused
    for i, (cout, _) in enumerate(_pairs(lc["cls"])):
        conv("lcnet", f"cls/{i}", cin, cout, 3)
        cin = cout
    for head, n in (("dir_x", lc["dirs_cls"]), ("dir_y", lc["dirs_cls"]),
                    ("ints", lc["ints_cls"])):
        conv("lcnet", f"heads/{head}/0", cin, lc["head_width"], 1)
        conv("lcnet", f"heads/{head}/1", lc["head_width"], n, 1)
    cin = ne["c_in"]
    for i, (cout, _) in enumerate(_pairs(ne["feat"])):
        conv("nenet", f"feat/{i}", cin, cout, 3)
        cin = cout
    out["nenet"]["feat_deconv/w"] = (cin, ne["feat_deconv"], 4, 4)
    cin = ne["feat_deconv"]
    conv("nenet", "feat_out", cin, ne["feat_out"], 3)
    cin = ne["feat_out"]
    for i, cout in enumerate(ne["reg"]):
        conv("nenet", f"reg/{i}", cin, cout, 3)
        cin = cout
    out["nenet"]["reg_deconv/w"] = (cin, ne["reg_deconv"], 4, 4)
    conv("nenet", "est_normal", ne["reg_deconv"], ne["out"], 3, bias=False)
    return out


def init_weights(cfg: dict, seed: int) -> dict:
    """Seeded Kaiming-normal weights (std sqrt(2 / fan_in), fan_in = cin k
    k for convolutions and transposed ones alike), zero biases, float32 on
    the CPU: {"lcnet": {...}, "nenet": {...}}."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for net, leaves in shapes(cfg).items():
        out[net] = {}
        for name, shape in leaves.items():
            if name.endswith("/b"):
                out[net][name] = torch.zeros(shape)
            else:
                transposed = "deconv" in name
                fan_in = (shape[0] if transposed else shape[1]) * \
                    shape[2] * shape[3]
                out[net][name] = torch.randn(shape, generator=g) * \
                    math.sqrt(2.0 / fan_in)
    return out


# ------------------------------------------------------------------ layers

def conv(x, w, b=None, stride=1, pad=1):
    """Conv2d as im2col: x [N, C, H, W], w [cout, cin, k, k]."""
    n, _, h, wd = x.shape
    cout, _, k, _ = w.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    cols = F.unfold(x, k, padding=pad, stride=stride)   # [N, C k k, P]
    y = torch.matmul(w.reshape(cout, -1), cols)
    if b is not None:
        y = y + b[:, None]
    return y.reshape(n, cout, ho, wo)


def deconv(x, w):
    """ConvTranspose2d(k=4, s=2, p=1) without a bias as col2im: x [N, cin,
    H, W], w [cin, cout, 4, 4] -> [N, cout, 2H, 2W]."""
    n, cin, h, wd = x.shape
    cout, k = w.shape[1], w.shape[2]
    cols = torch.matmul(w.reshape(cin, cout * k * k).T, x.reshape(n, cin, -1))
    return F.fold(cols, (2 * h, 2 * wd), k, padding=1, stride=2)


def lrelu(x, leak):
    return F.leaky_relu(x, leak)


# -------------------------------------------------------------- the inputs

def crop_and_pad(imgs: torch.Tensor, mask: torch.Tensor, pad: int = 15,
                 k: int = 4):
    """imgs [L, H, W, 3], mask [H, W] -> the crop [L, h, w, 3], its mask
    [h, w] and the box (top, left, bottom, right)."""
    h, w = mask.shape
    ii, jj = torch.nonzero(mask > 0.5, as_tuple=True)
    box = (max(0, int(ii.min()) - pad), max(0, int(jj.min()) - pad),
           min(h, int(ii.max()) + pad), min(w, int(jj.max()) + pad))
    imgs = imgs[:, box[0]:box[2], box[1]:box[3]]
    mask = mask[box[0]:box[2], box[1]:box[3]]
    if imgs.shape[1] % k or imgs.shape[2] % k:
        ph, pw = k - imgs.shape[1] % k, k - imgs.shape[2] % k
        imgs = F.pad(imgs, (0, 0, 0, pw, 0, ph))
        mask = F.pad(mask, (0, pw, 0, ph))
    return imgs, mask, box


def rescale(x: torch.Tensor, hw) -> torch.Tensor:
    """[N, C, h, w] to hw, bilinear with align_corners=True."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=True)


# ------------------------------------------------------------------ LCNet

def lcnet_logits(W: dict, cfg: dict, imgs: torch.Tensor,
                 mask: torch.Tensor) -> dict:
    """imgs [L, 3, th, tw], mask [1, th, tw] at the canonical size ->
    {dir_x, dir_y, ints}: logits [L, classes]."""
    lc, leak = cfg["lcnet"], cfg["leak"]
    feat, cls = _pairs(lc["feat"]), _pairs(lc["cls"])
    n_l = imgs.shape[0]
    blk = LIGHT_BLOCK["lcnet"]
    feats = []
    for s in range(0, n_l, blk):
        x = imgs[s:s + blk]
        x = torch.cat([x, mask[None].expand(x.shape[0], -1, -1, -1)], 1)
        for i, (_, stride) in enumerate(feat):
            x = lrelu(conv(x, W[f"feat/{i}/w"], W[f"feat/{i}/b"], stride),
                      leak)
        feats.append(x)
    feats = torch.cat(feats)
    fused = feats.amax(0, keepdim=True)
    out = {h: [] for h in ("dir_x", "dir_y", "ints")}
    for s in range(0, n_l, blk):
        x = feats[s:s + blk]
        x = torch.cat([x, fused.expand_as(x)], 1)
        for i, (_, stride) in enumerate(cls):
            x = lrelu(conv(x, W[f"cls/{i}/w"], W[f"cls/{i}/b"], stride), leak)
        for h in out:
            y = lrelu(conv(x, W[f"heads/{h}/0/w"], W[f"heads/{h}/0/b"],
                           pad=0), leak)
            y = conv(y, W[f"heads/{h}/1/w"], W[f"heads/{h}/1/b"], pad=0)
            out[h].append(y.reshape(y.shape[0], -1))
    return {h: torch.cat(v) for h, v in out.items()}


def lights(logits: dict, cfg: dict):
    """The published codec (eval_utils.py SphericalClassToDirs, test_utils.py
    the intensity) on the classes of logits {dir_x, dir_y, ints} [L,
    classes], in float64: the azimuth and elevation bins' centres, theta =
    (x + 0.5) / n 180 - 90 and phi likewise in degrees, to the unit vector
    (cos phi sin theta, sin phi, cos phi cos theta); the intensity bin's
    centre (c + 0.5) / n 1.8 + 0.2. Returns dirs [L, 3], intens [L]."""
    lc = cfg["lcnet"]
    n, n_i = lc["dirs_cls"], lc["ints_cls"]
    theta, phi = (torch.deg2rad((logits[h].argmax(1).double() + 0.5) / n
                                * 180 - 90) for h in ("dir_x", "dir_y"))
    dirs = torch.stack([phi.cos() * theta.sin(), phi.sin(),
                        phi.cos() * theta.cos()], 1)
    intens = (logits["ints"].argmax(1).double() + 0.5) / n_i * 1.8 + 0.2
    return dirs, intens


# ------------------------------------------------------------------ NENet

def nenet_normals(W: dict, cfg: dict, imgs: torch.Tensor, dirs: torch.Tensor,
                  intens: torch.Tensor) -> torch.Tensor:
    """imgs [L, 3, h, w] (h, w multiples of 4), dirs [L, 3], intens [L] ->
    unit normals [3, h, w] and the raw normals' lengths [h, w]."""
    ne, leak = cfg["nenet"], cfg["leak"]
    n_l, _, h, w = imgs.shape
    blk = LIGHT_BLOCK["nenet"]
    fused = None
    for s in range(0, n_l, blk):
        im = imgs[s:s + blk]
        b = im.shape[0]
        inv = 1.0 / (intens[s:s + blk] + 1e-8)
        x = torch.cat([im * inv[:, None, None, None],
                       dirs[s:s + blk, :, None, None].expand(b, 3, h, w)], 1)
        for i, (_, stride) in enumerate(_pairs(ne["feat"])):
            x = lrelu(conv(x, W[f"feat/{i}/w"], W[f"feat/{i}/b"], stride),
                      leak)
        x = lrelu(deconv(x, W["feat_deconv/w"]), leak)
        x = lrelu(conv(x, W["feat_out/w"], W["feat_out/b"]), leak)
        m = x.amax(0, keepdim=True)
        fused = m if fused is None else torch.maximum(fused, m)
        del x
    y = fused
    for i in range(len(ne["reg"])):
        y = lrelu(conv(y, W[f"reg/{i}/w"], W[f"reg/{i}/b"]), leak)
    y = lrelu(deconv(y, W["reg_deconv/w"]), leak)
    n = conv(y, W["est_normal/w"])[0]
    length = torch.linalg.norm(n, dim=0)
    return n / torch.clamp_min(length, 1e-12), length


# ------------------------------------------------------------------ a view

def view(weights: dict, cfg: dict, imgs: np.ndarray, mask: np.ndarray,
         dirs, intens, dev) -> dict:
    """One view's light images [L, H, W, 3] and mask [H, W] (as the
    program's read_view gives them): LCNet's logits, and NENet's normals
    [h, w, 3] on the crop, masked, from the lights given (dirs [L, 3],
    intens [L]); with the raw normals' lengths [h, w], the crop's mask
    [h, w] and box."""
    c = cfg["crop"]
    x, cmask, box = crop_and_pad(torch.as_tensor(imgs, device=dev),
                                 torch.as_tensor(mask, device=dev),
                                 c["pad"], c["factor"])
    x = x.permute(0, 3, 1, 2)
    hw = cfg["lcnet"]["test_hw"]
    logits = lcnet_logits(weights["lcnet"], cfg, rescale(x, hw),
                          rescale(cmask[None, None], hw)[0])
    n, length = nenet_normals(weights["nenet"], cfg, x,
                              torch.as_tensor(dirs, device=dev),
                              torch.as_tensor(intens, device=dev))
    return {"logits": logits, "normal": n.permute(1, 2, 0) * cmask[..., None],
            "length": length, "mask": cmask, "box": box}
