"""SDPS-Net (uncalibrated photometric stereo preprocessing) in PyTorch
(counterpart of psnerf_tpu/preprocess/sdps.py).

Two stages (reference preprocessing/models/):
  * LCNet (LCNet.py:63-159): a conv feature extractor shared across the L
    light images, max-fusion over the light axis, a 4-conv classifier and
    three 1x1-conv heads -> light direction as two 36-way (azimuth,
    elevation) classifications and intensity as a 20-way classification.
  * NENet (NENet.py:53-108): images divided by the predicted intensity,
    the predicted direction concatenated as 3 channels, a conv-deconv
    extractor, max-fusion, a regressor -> unit per-pixel normals.

The light axis is the batch axis (the JAX package vmaps over it); fusion
is a max over dim 0. Parameters sit at the JAX package's leaf paths
(`feat/<i>/{w,b}`, `cls/<i>/{w,b}`, `heads/<name>/<j>/{w,b}`; NENet's
`feat_deconv/w`, `reg/<i>/{w,b}`, ...) in torch's layouts (OIHW convs,
IOHW transposed convs), so the npz that either package's convert-ckpt
writes loads into these modules. Every convolution runs in f32 (TF32 off,
`device.f32_convolutions`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from psnerf_torch.device import f32_convolutions, resolve_device

LEAK = 0.1


# ------------------------------------------------------------ layer helpers

def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, pad: int = 1) -> torch.Tensor:
    """x [N, C, H, W], w [cout, cin, k, k] (OIHW)."""
    return F.conv2d(x, w, b, stride, pad)


def deconv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 2,
             pad: int = 1) -> torch.Tensor:
    """ConvTranspose2d(k=4, s=2, p=1) without bias: output = input * 2.
    w keeps torch's [cin, cout, kh, kw] layout; the JAX package computes
    the same function as a fractionally-strided conv with the flipped
    kernel."""
    return F.conv_transpose2d(x, w, stride=stride, padding=pad)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAK)


def _kaiming(shape, fan_in, generator):
    # torch kaiming_normal_: std = sqrt(2 / fan_in)
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


class Conv(nn.Module):
    """A k x k convolution: `w` [cout, cin, k, k], `b` [cout] unless
    bias=False. Kaiming-normal weights drawn on the CPU from `generator`
    (fan_in = cin k k), zero bias."""

    def __init__(self, cin, cout, k, stride=1, pad=1, bias=True,
                 generator=None, device="cpu"):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.w = nn.Parameter(
            _kaiming((cout, cin, k, k), cin * k * k, generator).to(device))
        self.b = (nn.Parameter(torch.zeros(cout, device=device)) if bias
                  else None)

    def forward(self, x):
        return conv2d(x, self.w, self.b, self.stride, self.pad)


class Deconv(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1) without bias: `w` [cin, cout, 4, 4],
    Kaiming-normal with fan_in = cin k k (the JAX package's deconv_init)."""

    def __init__(self, cin, cout, k=4, generator=None, device="cpu"):
        super().__init__()
        self.w = nn.Parameter(
            _kaiming((cin, cout, k, k), cin * k * k, generator).to(device))

    def forward(self, x):
        return deconv2d(x, self.w)


# ------------------------------------------------------------------- codecs
# class <-> direction / intensity (preprocessing/utils/eval_utils.py:54-91)

def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (through f64): torch's
    vectorized CPU sqrt misses it by an ulp on ~0.7% of inputs, which moves
    a light direction off the JAX package's (and the card's) bits."""
    return torch.sqrt(x.double()).float()


def spherical_dirs_to_class(dirs: torch.Tensor, cls_num: int = 36):
    theta = torch.atan(dirs[:, 0] / (dirs[:, 2] + 1e-8)) / math.pi * 180
    denom = _sqrt(dirs[:, 0] ** 2 + dirs[:, 2] ** 2)
    phi = torch.atan(dirs[:, 1] / (denom + 1e-8)) / math.pi * 180
    # .long() truncates toward zero, as numpy's astype(int)
    az = torch.clip((theta + 90.0) / 180 * cls_num, 0, cls_num - 1).long()
    el = torch.clip((phi + 90.0) / 180 * cls_num, 0, cls_num - 1).long()
    return az, el


def spherical_class_to_dirs(x_cls: torch.Tensor, y_cls: torch.Tensor,
                            cls_num: int = 36) -> torch.Tensor:
    theta = (x_cls.float() + 0.5) / cls_num * 180 - 90
    phi = (y_cls.float() + 0.5) / cls_num * 180 - 90
    neg_y = phi < 0
    theta = torch.clip(theta, -90, 90) / 180.0 * math.pi
    phi = torch.clip(phi, -90, 90) / 180.0 * math.pi
    tan2_phi = torch.tan(phi) ** 2
    tan2_theta = torch.tan(theta) ** 2
    y = _sqrt(tan2_phi / (1 + tan2_phi))
    y = torch.where(neg_y, -y, y)
    z = _sqrt((1 - y * y) / (1 + tan2_theta))
    x = z * torch.tan(theta)
    dirs = torch.stack([x, y, z], 1)
    return dirs / torch.linalg.norm(dirs, dim=1, keepdim=True)


def light_ints_to_class(ints: torch.Tensor, cls_num: int = 20):
    return torch.clip((ints - 0.2) / 1.8 * cls_num, 0, cls_num - 1).long()


def class_to_light_ints(cls: torch.Tensor, cls_num: int = 20):
    return torch.clip((cls.float() + 0.5) / cls_num * 1.8 + 0.2, 0.2, 2.0)


# -------------------------------------------------------------------- LCNet

LCNET_FEAT = [  # (cout, stride); cin of conv1 set by c_in
    (64, 2), (128, 2), (128, 1), (128, 2), (128, 1), (256, 2), (256, 1)
]
LCNET_CLS = [(256, 1), (256, 2), (256, 2), (256, 2)]
HEADS = ("dir_x", "dir_y", "ints")


class LCNet(nn.Module):
    """Light calibration: forward(imgs [L, 3, H, W] (H = W = 128
    canonical), mask [1, H, W]) -> {dirs [L, 3] (camera frame), intens
    [L], logits dirs_x / dirs_y [L, dirs_cls], ints [L, ints_cls]}.
    Reference: LCNet.py:126-159 (in_mask=True, in_light=False)."""

    def __init__(self, c_in=4, dirs_cls=36, ints_cls=20,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dirs_cls, self.ints_cls = dirs_cls, ints_cls
        conv = lambda cin, cout, k, stride=1, pad=1: Conv(
            cin, cout, k, stride, pad, generator=generator, device=dev)
        feat, cin = [], c_in
        for cout, stride in LCNET_FEAT:
            feat.append(conv(cin, cout, 3, stride))
            cin = cout
        self.feat = nn.ModuleList(feat)
        cls, cin = [], 512            # feats[i] ++ fused
        for cout, stride in LCNET_CLS:
            cls.append(conv(cin, cout, 3, stride))
            cin = cout
        self.cls = nn.ModuleList(cls)
        self.heads = nn.ModuleDict({
            name: nn.ModuleList([conv(256, 64, 1, pad=0),
                                 conv(64, ncls, 1, pad=0)])
            for name, ncls in zip(HEADS, (dirs_cls, dirs_cls, ints_cls))})

    def logits(self, imgs: torch.Tensor, mask: torch.Tensor) -> dict:
        """{dir_x, dir_y, ints}: the heads' logits, [L, classes] each."""
        n_l = imgs.shape[0]
        with f32_convolutions():
            x = torch.cat([imgs, mask[None].expand(n_l, 1, *mask.shape[1:])],
                          1)
            for c in self.feat:
                x = lrelu(c(x))
            # max-fusion over lights (LCNet.py:106-111); each light's
            # classifier sees [feat_i ++ fused], 512 channels
            x = torch.cat([x, x.amax(0, keepdim=True).expand_as(x)], 1)
            for c in self.cls:
                x = lrelu(c(x))
            return {name: head[1](lrelu(head[0](x))).reshape(n_l, -1)
                    for name, head in self.heads.items()}

    def forward(self, imgs: torch.Tensor, mask: torch.Tensor) -> dict:
        out = self.logits(imgs, mask)
        dirs = spherical_class_to_dirs(out["dir_x"].argmax(1),
                                       out["dir_y"].argmax(1), self.dirs_cls)
        intens = class_to_light_ints(out["ints"].argmax(1), self.ints_cls)
        return {"dirs": dirs, "intens": intens, "dirs_x": out["dir_x"],
                "dirs_y": out["dir_y"], "ints": out["ints"]}


# -------------------------------------------------------------------- NENet

NENET_FEAT = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1)]


class NENet(nn.Module):
    """Normal estimation: forward(imgs [L, 3, H, W] (H, W % 4 == 0), dirs
    [L, 3], intens [L] or [L, 3]) -> unit per-pixel normals [3, H, W].
    Reference: NENet.py:71-108 (intensity division :83-85, direction
    concatenation :86)."""

    def __init__(self, c_in=6, generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(generator=generator, device=dev)
        feat, cin = [], c_in
        for cout, stride in NENET_FEAT:
            feat.append(Conv(cin, cout, 3, stride, **kw))
            cin = cout
        self.feat = nn.ModuleList(feat)
        self.feat_deconv = Deconv(256, 128, **kw)
        self.feat_out = Conv(128, 128, 3, **kw)
        self.reg = nn.ModuleList([Conv(128, 128, 3, **kw),
                                  Conv(128, 128, 3, **kw)])
        self.reg_deconv = Deconv(128, 64, **kw)
        self.est_normal = Conv(64, 3, 3, bias=False, **kw)

    def forward(self, imgs: torch.Tensor, dirs: torch.Tensor,
                intens: torch.Tensor) -> torch.Tensor:
        if intens.ndim == 1:
            intens = intens[:, None].expand(-1, 3)          # [L, 3]
        n_l, _, h, w = imgs.shape
        with f32_convolutions():
            x = torch.cat([imgs / (intens[:, :, None, None] + 1e-8),
                           dirs[:, :, None, None].expand(n_l, 3, h, w)], 1)
            for c in self.feat:
                x = lrelu(c(x))
            x = lrelu(self.feat_deconv(x))
            x = lrelu(self.feat_out(x))
            y = x.amax(0, keepdim=True)              # [1, 128, h/2, w/2]
            for c in self.reg:
                y = lrelu(c(y))
            y = lrelu(self.reg_deconv(y))
            n = self.est_normal(y)[0]                # [3, H, W]
        return n / torch.linalg.norm(n, dim=0, keepdim=True).clamp_min(1e-12)


# ---------------------------------------------- reference checkpoint layout

def _t(a) -> torch.Tensor:
    return torch.as_tensor(a).detach().cpu()


def load_lcnet_torch(state_dict: dict) -> dict:
    """The released LCNet state_dict (featExtractor.convN.0.*,
    classifier.convN.0.*, classifier.<head>.N.0.*) as a tree of CPU
    tensors at the JAX package's leaf paths."""
    g = lambda k: _t(state_dict[k])
    conv = lambda p: {"w": g(f"{p}.weight"), "b": g(f"{p}.bias")}
    return {
        "feat": [conv(f"featExtractor.conv{i + 1}.0") for i in range(7)],
        "cls": [conv(f"classifier.conv{i + 1}.0") for i in range(4)],
        "heads": {name: [conv(f"classifier.{key}.0.0"),
                         conv(f"classifier.{key}.1.0")]
                  for name, key in zip(HEADS, ("dir_x_est", "dir_y_est",
                                               "int_est"))}}


def load_nenet_torch(state_dict: dict) -> dict:
    """The released NENet state_dict as a tree of CPU tensors at the JAX
    package's leaf paths. regressor.deconv1 and deconv2 are 3x3
    convolutions with a bias; only extractor.conv6 and regressor.deconv3
    are transposed convolutions (without a bias)."""
    g = lambda k: _t(state_dict[k])
    conv = lambda p: {"w": g(f"{p}.weight"), "b": g(f"{p}.bias")}
    return {
        "feat": [conv(f"extractor.conv{i + 1}.0") for i in range(5)],
        "feat_deconv": {"w": g("extractor.conv6.0.weight")},
        "feat_out": conv("extractor.conv7.0"),
        "reg": [conv("regressor.deconv1.0"), conv("regressor.deconv2.0")],
        "reg_deconv": {"w": g("regressor.deconv3.0.weight")},
        "est_normal": {"w": g("regressor.est_normal.0.weight")},
    }


def load_sdps_net(path: str, kind: str,
                  device: str | torch.device = "cuda") -> nn.Module:
    """LCNet (kind "lcnet") or NENet ("nenet") on `device` from a
    converted .npz (convert-ckpt's output) or a reference torch checkpoint
    (.pth.tar, its weights under "state_dict" or at the top level)."""
    from psnerf_torch.convert import load_torch_file
    from psnerf_torch.train.checkpoints import (flatten_tree, load_checkpoint,
                                                load_module)

    if kind not in ("lcnet", "nenet"):
        raise ValueError(f"unknown SDPS net {kind!r}")
    if path.endswith(".npz"):
        flat = load_checkpoint(path)[0]
    else:
        blob = load_torch_file(path)
        sd = blob.get("state_dict", blob)
        flat = flatten_tree(load_lcnet_torch(sd) if kind == "lcnet"
                            else load_nenet_torch(sd))
    net = LCNet(device=device) if kind == "lcnet" else NENet(device=device)
    return load_module(net, flat)
