"""Fused per-(light, pixel) visibility MLP (counterpart of
psnerf_tpu/ops/fused_vis.py), as a hand-written CUDA kernel for Hopper.

The stage-2 eval bottleneck is the 8x256 visibility MLP evaluated for every
(light, pixel) pair. Both wrappers here run one kernel of
csrc/fused_vis.cu over operands packed as the TPU kernel packs them:

  * the skip concat [PE(x), PE(l)] is folded into row splits of layer 0 and
    of the skip layer: the point halves (em @ W0x, em @ W5x) are computed
    once per pixel inside the kernel, the light halves r0/r5 [L, W] (bias
    included) once per light here;
  * trunk weights and the point embedding are bf16, products accumulate in
    f32; the output row w8 is bf16-rounded and dotted in f32 with the
    unrounded relu output.

fused_visibility returns the raw (pre-clip) visibility [L, N];
fused_vis_shade adds the SG shading epilogue (clip, 9 lobes with rgb or
scalar weights, n.l, intensity, mask fill of 1.0 on real lights).

On a CPU tensor each wrapper runs its plain PyTorch version
(`*_plain`), which repeats the kernel's packing and rounding points in f32
arithmetic on bf16-rounded values. On a CUDA tensor it launches the kernel
or raises; it never falls back. Each wrapper counts its launches in
`.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from psnerf_torch.fields.brdf import SG_LOBES

KERNEL_WIDTHS = (64, 128, 256)
MAX_BASIS = 9
PIXW = 40                      # floats per pixel of shading inputs
_MODES = {"raw": 0, "lnc": 1, "cnl": 2, "sum": 3}
_lib_handle = []


# ------------------------------------------------------------------ packing

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _skip_index(layers, width: int) -> int:
    skip = None
    for i, lyr in enumerate(layers):
        if i > 0 and lyr.w.shape[0] > width:
            skip = i
    if len(layers) < 4 or skip is None:
        raise ValueError("fused visibility needs >= 4 linears with one skip "
                         "layer (the reference vis-net topology)")
    return skip


def pack_vis_operands(layers, point_emb: torch.Tensor,
                      light_emb: torch.Tensor) -> dict:
    """Operand packing shared by both kernels and their plain versions.
    layers: the visibility SkipMLP (Linear layers with w [din, dout])."""
    if point_emb.ndim != 2 or light_emb.ndim != 2:
        raise ValueError("point_emb must be [N, E] and light_emb [L, E]")
    if point_emb.dtype != torch.float32 or light_emb.dtype != torch.float32:
        raise ValueError("embeddings must be float32")
    if point_emb.device != light_emb.device:
        raise ValueError("point_emb and light_emb lie on different devices")
    n, e = point_emb.shape
    if light_emb.shape[1] != e:
        raise ValueError(f"light_emb width {light_emb.shape[1]} != {e}")
    width = layers[1].w.shape[0]
    skip = _skip_index(layers, width)
    if layers[0].w.shape[0] != 2 * e or layers[skip].w.shape[0] != width + 2 * e:
        raise ValueError("layer shapes do not match the embedding width")
    bf = torch.bfloat16
    ke = _round_up(e, 16)

    def point_rows_t(w):                    # [e, W] -> [W, ke] bf16
        return torch.nn.functional.pad(w.T, (0, ke - e)).to(bf).contiguous()

    w0, wskip = layers[0].w, layers[skip].w
    trunk = ([layers[i].w for i in range(1, skip)] + [wskip[:width]]
             + [layers[i].w for i in range(skip + 1, len(layers) - 1)])
    trunk_b = ([layers[i].b for i in range(1, skip)]
               + [torch.zeros_like(layers[skip].b)]   # skip bias lives in r5
               + [layers[i].b for i in range(skip + 1, len(layers) - 1)])
    return dict(
        n=n, e=e, ke=ke, width=width, n_lights=light_emb.shape[0],
        n_pre=skip - 1,
        em=torch.nn.functional.pad(point_emb, (0, ke - e)).to(bf).contiguous(),
        w0xT=point_rows_t(w0[:e]),
        w5xT=point_rows_t(wskip[width:width + e]),
        r0=(light_emb @ w0[e:] + layers[0].b).contiguous(),
        r5=(light_emb @ wskip[width + e:] + layers[skip].b).contiguous(),
        trunk_wT=torch.stack([w.T for w in trunk]).to(bf).contiguous(),
        trunk_b=torch.stack(trunk_b).float().contiguous(),
        w8=layers[-1].w[:, 0].to(bf).float().contiguous(),
        b8=layers[-1].b.reshape(1).float().contiguous(),
    )


def pack_shade_operands(normal, view, albedo, weights, mask, light_dirs,
                        light_ints, nbasis: int, specular_rgb: bool) -> dict:
    """Per-pixel shading inputs [N, PIXW] (normal, view, v.n, mask, albedo,
    SG weights) and per-light dirs / per-channel intensities [L, 3]."""
    n = normal.shape[0]
    n_l = light_dirs.shape[0]
    nw = nbasis * 3 if specular_rgb else nbasis
    if not 0 < nbasis <= MAX_BASIS or weights.shape != (n, nw):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"nbasis={nbasis}, specular_rgb={specular_rgb}")
    f32 = torch.float32
    vn = torch.sum(normal * view, dim=-1, keepdim=True)
    pix = torch.cat([normal, view, vn, mask.to(f32)[:, None], albedo,
                     weights], dim=-1).to(f32)
    pix = torch.nn.functional.pad(pix, (0, PIXW - pix.shape[1])).contiguous()
    li = torch.as_tensor(light_ints, dtype=f32, device=normal.device)
    if li.ndim == 0:
        li = li.expand(n_l)
    lint = (li[:, None] if li.ndim == 1 else li).expand(n_l, 3)
    return dict(pix=pix, ld=light_dirs.to(f32).contiguous(),
                lint=lint.contiguous(), nbasis=nbasis,
                specular_rgb=specular_rgb)


# ---------------------------------------------------------- plain versions

def _trunk_plain(ops: dict) -> torch.Tensor:
    """Raw visibility [L, N] from packed operands, in f32 arithmetic on
    bf16-rounded values (the kernel's rounding points), lights in chunks."""
    em = ops["em"].float()
    a0 = em @ ops["w0xT"].float().T                        # [N, W]
    b5 = em @ ops["w5xT"].float().T
    trunk_w = [w.float().T for w in ops["trunk_wT"]]       # [W_in, W_out]
    n, width, n_l = ops["n"], ops["width"], ops["n_lights"]
    chunk = max(1, (1 << 26) // max(1, n * width))
    out = []
    for s in range(0, n_l, chunk):
        r0 = ops["r0"][s:s + chunk, None, :]
        r5 = ops["r5"][s:s + chunk, None, :]
        y = torch.relu(a0[None] + r0)                      # [Lc, N, W]
        for i, w in enumerate(trunk_w):
            z = y.to(torch.bfloat16).float() @ w
            z = (z + b5[None]) + r5 if i == ops["n_pre"] \
                else z + ops["trunk_b"][i]
            y = torch.relu(z)
        out.append(torch.sum(y * ops["w8"], dim=-1) + ops["b8"])
    return torch.cat(out, dim=0)


def _shade_plain(raw: torch.Tensor, sh: dict, mode: str) -> torch.Tensor:
    """SG shading epilogue on raw visibility [L, N]."""
    pix, ld, lint = sh["pix"], sh["ld"], sh["lint"]
    nbasis, rgb_w = sh["nbasis"], sh["specular_rgb"]
    vis = torch.clamp(raw, 0.0, 1.0)
    cos = ld @ pix[:, 0:3].T                               # n.l [L, N]
    lv = ld @ pix[:, 3:6].T                                # v.l
    hn = (cos + pix[:, 6][None]) / torch.clamp_min(
        torch.sqrt(torch.clamp_min(2.0 + 2.0 * lv, 0.0)), 1e-12)
    em1 = torch.clamp_max(hn - 1.0, 0.0)
    ds = [torch.exp(float(SG_LOBES[i]) * em1) for i in range(nbasis)]
    inside = (pix[:, 7] > 0.5)[None]
    cv = cos * vis
    chans = []
    for c in range(3):
        s = torch.zeros_like(hn)
        for i in range(nbasis):
            col = 11 + (c * nbasis + i if rgb_w else i)
            s = s + pix[:, col][None] * ds[i]
        s = torch.clamp_min(s, 0.0)
        rgb = torch.clamp((pix[:, 8 + c][None] + s) * lint[:, c][:, None] * cv,
                          0.0, 1.0)
        chans.append(torch.where(inside, rgb, torch.ones_like(rgb)))
    if mode == "sum":
        return torch.stack(chans, dim=-1).sum(dim=0)       # [N, 3]
    if mode == "cnl":
        return torch.stack(chans, dim=0).permute(0, 2, 1).contiguous()
    return torch.stack(chans, dim=-1)                      # [L, N, 3]


@torch.no_grad()
def fused_visibility_plain(layers, point_emb, light_emb) -> torch.Tensor:
    return _trunk_plain(pack_vis_operands(layers, point_emb, light_emb))


@torch.no_grad()
def fused_vis_shade_plain(layers, point_emb, light_emb, normal, view, albedo,
                          weights, mask, light_dirs, light_ints,
                          nbasis: int = 9, specular_rgb: bool = True,
                          sum_lights: bool = False,
                          layout: str = "lnc") -> torch.Tensor:
    ops = pack_vis_operands(layers, point_emb, light_emb)
    sh = pack_shade_operands(normal, view, albedo, weights, mask, light_dirs,
                             light_ints, nbasis, specular_rgb)
    return _shade_plain(_trunk_plain(ops), sh, _mode(sum_lights, layout))


# ----------------------------------------------------------------- kernels

def _mode(sum_lights: bool, layout: str) -> str:
    if layout not in ("lnc", "cnl"):
        raise ValueError(f"layout must be 'lnc' or 'cnl', got {layout!r}")
    return "sum" if sum_lights else layout


def _lib():
    if not _lib_handle:
        from psnerf_torch.ops.build import load_library

        lib = load_library("fused_vis")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.psnerf_fused_vis.argtypes = [
            i, i, p, i, i, p, p, p, p, i, p, p, i, i, p, p, p, p, p,
            ctypes.POINTER(ctypes.c_float), i, i, p, p]
        lib.psnerf_fused_vis.restype = ctypes.c_int
        lib.psnerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.psnerf_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle.append(lib)
    return _lib_handle[0]


def _check_operand(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(mode: str, ops: dict, sh: dict | None, out: torch.Tensor) -> None:
    dev = ops["em"].device
    if dev.type != "cuda":
        raise ValueError(f"the fused_vis kernel needs CUDA tensors, got {dev}")
    n, w, ke, n_l = ops["n"], ops["width"], ops["ke"], ops["n_lights"]
    if w not in KERNEL_WIDTHS:
        raise ValueError(f"the fused_vis kernel takes widths {KERNEL_WIDTHS}, "
                         f"got {w}")
    if ke > w:
        raise ValueError(f"embedding width {ops['e']} exceeds the trunk "
                         f"width {w}")
    nt = ops["trunk_wT"].shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    for name, dtype, shape in (
            ("em", bf, (n, ke)), ("w0xT", bf, (w, ke)), ("w5xT", bf, (w, ke)),
            ("r0", f32, (n_l, w)), ("r5", f32, (n_l, w)),
            ("trunk_wT", bf, (nt, w, w)), ("trunk_b", f32, (nt, w)),
            ("w8", f32, (w,)), ("b8", f32, (1,))):
        _check_operand(name, ops[name], dtype, shape, dev)
    if sh is not None:
        _check_operand("pix", sh["pix"], f32, (n, PIXW), dev)
        _check_operand("ld", sh["ld"], f32, (n_l, 3), dev)
        _check_operand("lint", sh["lint"], f32, (n_l, 3), dev)
    _check_operand("out", out, f32, out.shape, dev)
    lobes = (ctypes.c_float * MAX_BASIS)(*[float(x) for x in SG_LOBES])
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _lib()
        rc = lib.psnerf_fused_vis(
            _MODES[mode], w, ptr(ops["em"]), n, ke, ptr(ops["w0xT"]),
            ptr(ops["w5xT"]), ptr(ops["r0"]), ptr(ops["r5"]), n_l,
            ptr(ops["trunk_wT"]), ptr(ops["trunk_b"]), nt, ops["n_pre"],
            ptr(ops["w8"]), ptr(ops["b8"]),
            ptr(sh and sh["pix"]), ptr(sh and sh["ld"]),
            ptr(sh and sh["lint"]), lobes, sh["nbasis"] if sh else 0,
            int(sh["specular_rgb"]) if sh else 0, ptr(out), stream)
    if rc != 0:
        raise RuntimeError("fused_vis kernel launch failed: "
                           + lib.psnerf_cuda_error_string(rc).decode())


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


@torch.no_grad()
def fused_visibility(layers, point_emb: torch.Tensor,
                     light_emb: torch.Tensor) -> torch.Tensor:
    """Raw visibility MLP output [L, N] (pre-clip) for every (light, pixel)
    of point_emb [N, E] and light_emb [L, E]."""
    if _route(point_emb) == "cpu":
        return fused_visibility_plain(layers, point_emb, light_emb)
    ops = pack_vis_operands(layers, point_emb, light_emb)
    out = torch.empty((ops["n_lights"], ops["n"]), dtype=torch.float32,
                      device=point_emb.device)
    _launch("raw", ops, None, out)
    fused_visibility.launches += 1
    return out


fused_visibility.launches = 0


@torch.no_grad()
def fused_vis_shade(layers, point_emb, light_emb, normal, view, albedo,
                    weights, mask, light_dirs, light_ints, nbasis: int = 9,
                    specular_rgb: bool = True, sum_lights: bool = False,
                    layout: str = "lnc") -> torch.Tensor:
    """SG-shaded multi-light rgb in one kernel: [L, N, 3] (layout "lnc"),
    channel-major [3, N, L] ("cnl"), or the light sum [N, 3] (sum_lights).
    normal/view [N, 3] unit (view = -ray dir), albedo [N, 3], weights
    [N, nbasis or 3*nbasis], mask [N] bool, light_dirs [L, 3],
    light_ints [], [L] or [L, 3]."""
    mode = _mode(sum_lights, layout)
    if _route(point_emb) == "cpu":
        return fused_vis_shade_plain(
            layers, point_emb, light_emb, normal, view, albedo, weights,
            mask, light_dirs, light_ints, nbasis, specular_rgb, sum_lights,
            layout)
    ops = pack_vis_operands(layers, point_emb, light_emb)
    sh = pack_shade_operands(normal, view, albedo, weights, mask, light_dirs,
                             light_ints, nbasis, specular_rgb)
    n, n_l = ops["n"], ops["n_lights"]
    shape = {"lnc": (n_l, n, 3), "cnl": (3, n, n_l), "sum": (n, 3)}[mode]
    out = torch.empty(shape, dtype=torch.float32, device=point_emb.device)
    _launch(mode, ops, sh, out)
    fused_vis_shade.launches += 1
    return out


fused_vis_shade.launches = 0
