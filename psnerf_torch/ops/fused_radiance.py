"""Fused radiance+alpha with its second-order backward (counterpart of
psnerf_tpu/ops/fused_radiance.py), as hand-written CUDA kernels for Hopper
(csrc/fused_radiance.cu).

The grad-tracked integration batch of a stage-1 train step (2048 rays x 64
or 96 samples) runs the geometry trunk, per-point analytic normals (a
reverse sweep of the logit wrt the embedding), and the appearance MLP that
consumes those normals. Its backward carries the Hessian-vector terms the
normal path injects. Two kernels compute it:

  * forward: trunk -> feat and logit (split head), reverse sweep -> g_e =
    d logit / d emb, normals n = (d emb / d x)^T g_e, appearance ->
    pre-tanh rgb. Output [N, 4] (rgb_lin, logit) and the residual g_e.
  * backward: recomputes the forward with the saved g_e, runs the
    appearance backward, the tangent forward of the normal path, and one
    doubled reverse sweep carrying (h_bar, t_bar) through softplus'' =
    100 s (1 - s). It returns weight gradients only.

Both come in the two operand forms of the TPU kernels: bf16 operands
(`compute="bfloat16"`, bf16 mma.sync) and f32 operands (`compute="float32"`,
the default field's form: 3xTF32 mma.sync, close to f32 products).

Weight norm and the layout (skip row split, split geometry head,
appearance input split into [p, view PE, normal, feat] rows) are folded
outside the kernels by differentiable packing (`pack_radiance`), so
autograd chains the packed gradients into each WNLinear's v, g and b.
Points and directions get no gradient (the call sites' samples come from
the no-grad march).

`fused_radiance_and_alpha` runs a torch.autograd.Function. On CPU tensors
its forward and backward run the plain versions (`radiance_forward_plain`,
`radiance_backward_plain`: the kernels' arithmetic, and the backward's
explicit sweep, in PyTorch). On CUDA tensors they launch the kernels or
raise. Launches are counted per form in `radiance_forward.launches` and
`radiance_backward.launches` ({"bfloat16": n, "float32": n}).
"""

from __future__ import annotations

import ctypes

import torch

from psnerf_torch.core.encoding import nerf_embed, nerf_embed_dim
from psnerf_torch.fields.mlp import wn_weight
from psnerf_torch.ops.build import (check_operand, load_library, round_up,
                                    route)
from psnerf_torch.ops.fused_occ import fold_geometry

KERNEL_WIDTHS = (128, 256)
_OP_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FORMS = tuple(_OP_DTYPE)        # the operand forms, by `compute` name
PACK_ORDER = ["w0", "b0", "wskip", "trunk_w", "trunk_b", "w8f", "b8f", "w8l",
              "b8l", "wp", "wv", "wn", "wf", "ba0", "wa", "bab", "wa4", "ba4"]
_lib_handle = []


def supports(cfg) -> bool:
    """True iff the kernels take this architecture (either operand form):
    the split geometry head needs feat_size == hidden_dim, one skip inside
    the trunk, a width the kernels are built for and embeddings up to 64
    wide."""
    ev = nerf_embed_dim(3, cfg.octaves_pe_views)
    return (cfg.hidden_dim in KERNEL_WIDTHS
            and cfg.feat_size == cfg.hidden_dim
            and len(cfg.skips) == 1
            and 1 <= cfg.skips[0] <= cfg.num_layers - 1
            and cfg.num_layers <= 8
            and round_up(cfg.dim_embed, 16) <= 64
            and round_up(ev, 16) <= 64)


# ------------------------------------------------------------------ packing

def pack_radiance(field, cfg, wdt) -> dict:
    """Differentiable fold of the weight-normed field into dense operands
    (products' operands in `wdt`, everything else f32), JAX's weight layout
    [din, dout]; the geometry by `fold_geometry`, as the occupancy kernel's:
      w0 [ke, W], b0 [W], wskip [ke, W] (skip PE rows / sqrt 2),
      trunk_w [n_trunk, W, W] (the skip layer's x rows / sqrt 2), trunk_b,
      w8f [W, W], b8f [W] (feature head), w8l [W], b8l [1] (logit head),
      wp [3, W], wv [kv, W], wn [3, W], wf [W, W], ba0 [W] (appearance
      layer 0 split by input rows), wa [3, W, W], bab [3, W], wa4 [W, 3],
      ba4 [3]."""
    g = fold_geometry(field, cfg, wdt)
    w_last, b_last = g["w_out"], g["b_out"]
    adense = [(wn_weight(l), l.b) for l in field.app]
    ev = nerf_embed_dim(3, cfg.octaves_pe_views)
    kv = round_up(ev, 16)
    wa0 = adense[0][0]
    pad = torch.nn.functional.pad
    return {
        "w0": g["w0"], "b0": g["b0"], "wskip": g["wskip"],
        "trunk_w": g["trunk_w"], "trunk_b": g["trunk_b"],
        "w8f": w_last[:, 1:].to(wdt), "b8f": b_last[1:],
        "w8l": w_last[:, 0], "b8l": b_last[0:1],
        "wp": wa0[0:3], "wv": pad(wa0[3:3 + ev], (0, 0, 0, kv - ev)).to(wdt),
        "wn": wa0[3 + ev:6 + ev], "wf": wa0[6 + ev:].to(wdt),
        "ba0": adense[0][1],
        "wa": torch.stack([w for w, _ in adense[1:-1]]).to(wdt),
        "bab": torch.stack([b for _, b in adense[1:-1]]),
        "wa4": adense[-1][0].to(wdt), "ba4": adense[-1][1],
    }


@torch.no_grad()
def radiance_inputs(p: torch.Tensor, ray_d: torch.Tensor, cfg) -> tuple:
    """Per-point inputs, f32: em [N, ke] (the position PE, zero-padded),
    de [N, ke] (d em[c] / d x[c % 3], the PE's diagonal Jacobian, chained
    through p / rescale), vpe [N, kv] (the view PE, zero-padded), p [N, 3]."""
    e = cfg.dim_embed
    ke = round_up(e, 16)
    x = p / cfg.rescale
    em = nerf_embed(x, cfg.octaves_pe)
    freqs = 2.0 ** torch.arange(cfg.octaves_pe, dtype=p.dtype, device=p.device)
    scaled = x[..., None, :] * freqs[:, None]                    # [N, L, 3]
    dsin = freqs[:, None] * torch.cos(scaled)
    dcos = -freqs[:, None] * torch.sin(scaled)
    de = torch.cat([torch.ones_like(x),
                    torch.stack([dsin, dcos], dim=-2).reshape(x.shape[0], -1)],
                   dim=-1) / cfg.rescale
    view = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    vpe = nerf_embed(view, cfg.octaves_pe_views)
    kv = round_up(vpe.shape[1], 16)
    pad = torch.nn.functional.pad
    return (pad(em, (0, ke - e)).contiguous(), pad(de, (0, ke - e)).contiguous(),
            pad(vpe, (0, kv - vpe.shape[1])).contiguous(), p.contiguous())


# ---------------------------------------------------------- plain versions

def _sp_sig(x):
    """softplus(100 x) / 100 and its derivative sigmoid(100 x) from one exp
    (no linear cutover: sigmoid(20) ~ 1 - 2e-9)."""
    bx = 100.0 * x
    e = torch.exp(-torch.abs(bx))
    sp = (torch.clamp_min(bx, 0.0) + torch.log1p(e)) / 100.0
    inv = 1.0 / (1.0 + e)
    return sp, torch.where(bx >= 0, inv, e * inv)


def _normals(g_e, de):
    """n[:, j] = sum over embedding columns c with c % 3 == j of
    g_e[:, c] * de[:, c]."""
    prod = g_e * de
    return torch.stack([prod[:, j::3].sum(dim=1) for j in range(3)], dim=1)


def _ops(packed: dict, compute: str):
    """Views of the packed operands at least f32 wide (f64 operands stay
    f64: a reference of the f32 form's own rounding) and the operand
    rounding of the form."""
    r = {k: v.to(torch.promote_types(v.dtype, torch.float32))
         for k, v in packed.items()}
    if compute == "bfloat16":
        return r, (lambda x: x.to(torch.bfloat16).to(x.dtype))
    return r, (lambda x: x)


def _forward_core(r, cast, em, de, vpe, p3, skip_pos, g_e=None):
    """The forward of one batch; with g_e given (the backward's recompute)
    the reverse sweep is skipped."""
    z, a, sprime = [], [], []
    zi = cast(em) @ r["w0"] + r["b0"]
    b_pe = cast(em) @ r["wskip"]
    for i in range(r["trunk_w"].shape[0] + 1):
        if i > 0:
            zi = cast(a[-1]) @ r["trunk_w"][i - 1] + r["trunk_b"][i - 1]
            if i - 1 == skip_pos:
                zi = zi + b_pe
        sp, sg = _sp_sig(zi)
        z.append(zi)
        a.append(sp)
        sprime.append(sg)
    feat = cast(a[-1]) @ r["w8f"] + r["b8f"]
    logit = torch.sum(a[-1] * r["w8l"], dim=1) + r["b8l"]
    if g_e is None:
        n_trunk = r["trunk_w"].shape[0]
        g = r["w8l"].expand_as(a[-1])
        for i in range(n_trunk, 0, -1):
            gz = g * sprime[i]
            if i == skip_pos + 1:
                gz_skip = gz
            g = cast(gz) @ r["trunk_w"][i - 1].T
        g_e = (cast(g * sprime[0]) @ r["w0"].T
               + cast(gz_skip) @ r["wskip"].T)
    n3 = _normals(g_e, de)
    za0 = cast(vpe) @ r["wv"] + cast(feat) @ r["wf"] + r["ba0"]
    for j in range(3):
        za0 = za0 + p3[:, j:j + 1] * r["wp"][j]
        za0 = za0 + n3[:, j:j + 1] * r["wn"][j]
    za, aa = [za0], [torch.relu(za0)]
    for j in range(r["wa"].shape[0]):
        za.append(cast(aa[-1]) @ r["wa"][j] + r["bab"][j])
        aa.append(torch.relu(za[-1]))
    rgb = cast(aa[-1]) @ r["wa4"] + r["ba4"]
    return dict(z=z, a=a, sprime=sprime, feat=feat, logit=logit, g_e=g_e,
                n3=n3, za=za, aa=aa, rgb=rgb)


@torch.no_grad()
def radiance_forward_plain(packed: dict, em, de, vpe, p3, skip_pos: int,
                           compute: str = "bfloat16"):
    """(out [N, 4] = pre-tanh rgb and logit, g_e [N, ke])."""
    r, cast = _ops(packed, compute)
    c = _forward_core(r, cast, em, de, vpe, p3, skip_pos)
    return torch.cat([c["rgb"], c["logit"][:, None]], dim=1), c["g_e"]


@torch.no_grad()
def radiance_backward_plain(packed: dict, em, de, vpe, p3, g_e, g_out,
                            skip_pos: int, compute: str = "bfloat16") -> dict:
    """Gradients of sum(out * g_out) wrt every packed operand (f32, the
    packed shapes), by the backward kernel's explicit sweep."""
    r, cast = _ops(packed, compute)
    dTn = lambda x, y: cast(x).T @ cast(y)
    c = _forward_core(r, cast, em, de, vpe, p3, skip_pos, g_e=g_e)
    z, a, sprime = c["z"], c["a"], c["sprime"]
    n_trunk = r["trunk_w"].shape[0]
    d = {}

    # appearance backward
    g_rgb, g_logit = g_out[:, :3], g_out[:, 3]
    d["wa4"] = dTn(c["aa"][-1], g_rgb)
    d["ba4"] = g_rgb.sum(0)
    gz = cast(g_rgb) @ r["wa4"].T
    d_wa, d_bab = [None] * 3, [None] * 3
    for j in range(r["wa"].shape[0] - 1, -1, -1):
        gz = gz * (c["za"][j + 1] > 0)
        d_wa[j] = dTn(c["aa"][j], gz)
        d_bab[j] = gz.sum(0)
        gz = cast(gz) @ r["wa"][j].T
    d["wa"], d["bab"] = torch.stack(d_wa), torch.stack(d_bab)
    gz = gz * (c["za"][0] > 0)
    d["wv"] = dTn(vpe, gz)
    d["wf"] = dTn(c["feat"], gz)
    d["ba0"] = gz.sum(0)
    d["wp"] = torch.stack([(p3[:, j:j + 1] * gz).sum(0) for j in range(3)])
    d["wn"] = torch.stack([(c["n3"][:, j:j + 1] * gz).sum(0)
                           for j in range(3)])
    g_n = torch.stack([(gz * r["wn"][j]).sum(1) for j in range(3)], dim=1)
    g_feat = cast(gz) @ r["wf"].T

    # first-order seeds through the split geometry head
    d["w8f"] = dTn(a[-1], g_feat)
    d["b8f"] = g_feat.sum(0)
    d_w8l = (g_logit[:, None] * a[-1]).sum(0)
    d["b8l"] = g_logit.sum().reshape(1)
    h_bar = cast(g_feat) @ r["w8f"].T + g_logit[:, None] * r["w8l"]

    # tangent forward of the normal path
    c_e = de * g_n.repeat(1, de.shape[1] // 3 + 1)[:, :de.shape[1]]
    tz = [cast(c_e) @ r["w0"]]
    t_list = [sprime[0] * tz[0]]
    tc_pe = cast(c_e) @ r["wskip"]
    for i in range(n_trunk):
        tzi = cast(t_list[-1]) @ r["trunk_w"][i]
        if i == skip_pos:
            tzi = tzi + tc_pe
        tz.append(tzi)
        t_list.append(sprime[i + 1] * tzi)
    d["w8l"] = d_w8l + t_list[-1].sum(0)
    t_bar = r["w8l"].expand_as(a[-1])

    # doubled reverse sweep through the trunk
    spp = lambda i: 100.0 * sprime[i] * (1.0 - sprime[i])
    d_tw, d_tb = [None] * n_trunk, [None] * n_trunk
    for i in range(n_trunk, 0, -1):
        z_bar = h_bar * sprime[i] + t_bar * spp(i) * tz[i]
        tz_bar = t_bar * sprime[i]
        d_tw[i - 1] = dTn(a[i - 1], z_bar) + dTn(t_list[i - 1], tz_bar)
        d_tb[i - 1] = z_bar.sum(0)
        if i - 1 == skip_pos:
            d["wskip"] = dTn(em, z_bar) + dTn(c_e, tz_bar)
        h_bar = cast(z_bar) @ r["trunk_w"][i - 1].T
        t_bar = cast(tz_bar) @ r["trunk_w"][i - 1].T
    z_bar = h_bar * sprime[0] + t_bar * spp(0) * tz[0]
    tz_bar = t_bar * sprime[0]
    d["w0"] = dTn(em, z_bar) + dTn(c_e, tz_bar)
    d["b0"] = z_bar.sum(0)
    d["trunk_w"], d["trunk_b"] = torch.stack(d_tw), torch.stack(d_tb)
    return d


# ----------------------------------------------------------------- kernels

def _lib():
    if not _lib_handle:
        lib = load_library("fused_radiance")
        for fn in (lib.psnerf_radiance_fwd, lib.psnerf_radiance_bwd,
                   lib.psnerf_radiance_fwd_f32, lib.psnerf_radiance_bwd_f32):
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.psnerf_radiance_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.psnerf_radiance_scratch_bytes.restype = ctypes.c_longlong
        lib.psnerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.psnerf_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle.append(lib)
    return _lib_handle[0]


@torch.no_grad()
def _kernel_weights(packed: dict) -> dict:
    """The kernels' weight layouts: each product's operand as [out, in]
    (the forward's) and [in, out] (the backward sweeps'), in the packed
    operand type; the rgb head padded to the MMA's 8 columns."""
    c = lambda t: t.contiguous()
    wa4 = packed["wa4"]
    return dict(
        w0T=c(packed["w0"].T), w0=c(packed["w0"]),
        wskipT=c(packed["wskip"].T), wskip=c(packed["wskip"]),
        trunkT=c(packed["trunk_w"].transpose(1, 2)),
        trunk=c(packed["trunk_w"]), trunk_b=c(packed["trunk_b"].float()),
        w8fT=c(packed["w8f"].T), w8f=c(packed["w8f"]),
        b8f=c(packed["b8f"].float()), w8l=c(packed["w8l"].float()),
        b8l=c(packed["b8l"].float()), wp=c(packed["wp"].float()),
        wn=c(packed["wn"].float()), wvT=c(packed["wv"].T),
        wfT=c(packed["wf"].T), wf=c(packed["wf"]),
        ba0=c(packed["ba0"].float()),
        waT=c(packed["wa"].transpose(1, 2)), wa=c(packed["wa"]),
        bab=c(packed["bab"].float()),
        wa4T=c(torch.nn.functional.pad(wa4.T, (0, 0, 0, 8 - wa4.shape[1]))),
        wa4=c(wa4), ba4=c(packed["ba4"].float()),
        b0=c(packed["b0"].float()))


_W_NAMES = ["w0T", "w0", "b0", "wskipT", "wskip", "trunkT", "trunk",
            "trunk_b", "w8fT", "w8f", "b8f", "w8l", "b8l", "wp", "wn", "wvT",
            "wfT", "wf", "ba0", "waT", "wa", "bab", "wa4T", "wa4", "ba4"]


def _weight_shapes(w, ke, kv, nt, op):
    """(dtype, shape) of each kernel weight; op: the operand type."""
    f32 = torch.float32
    return {
        "w0T": (op, (w, ke)), "w0": (op, (ke, w)), "b0": (f32, (w,)),
        "wskipT": (op, (w, ke)), "wskip": (op, (ke, w)),
        "trunkT": (op, (nt, w, w)), "trunk": (op, (nt, w, w)),
        "trunk_b": (f32, (nt, w)), "w8fT": (op, (w, w)), "w8f": (op, (w, w)),
        "b8f": (f32, (w,)), "w8l": (f32, (w,)), "b8l": (f32, (1,)),
        "wp": (f32, (3, w)), "wn": (f32, (3, w)), "wvT": (op, (w, kv)),
        "wfT": (op, (w, w)), "wf": (op, (w, w)), "ba0": (f32, (w,)),
        "waT": (op, (3, w, w)), "wa": (op, (3, w, w)), "bab": (f32, (3, w)),
        "wa4T": (op, (8, w)), "wa4": (op, (w, 3)), "ba4": (f32, (3,))}


_GRAD_SHAPES = lambda w, ke, kv, nt: {
    "w0": (ke, w), "b0": (w,), "wskip": (ke, w), "trunk_w": (nt, w, w),
    "trunk_b": (nt, w), "w8f": (w, w), "b8f": (w,), "w8l": (w,), "b8l": (1,),
    "wp": (3, w), "wv": (kv, w), "wn": (3, w), "wf": (w, w), "ba0": (w,),
    "wa": (3, w, w), "bab": (3, w), "wa4": (w, 3), "ba4": (3,)}


def _launch(which: str, compute: str, kw: dict, tensors: dict,
            names: list, n: int, skip_pos: int) -> None:
    """Check every operand and launch the forward or backward kernel of
    the operand form `compute`."""
    dev = tensors["em"].device
    if dev.type != "cuda":
        raise ValueError(f"the fused_radiance kernels need CUDA tensors, got "
                         f"{dev}")
    w = kw["w8l"].shape[0]
    ke, kv = kw["w0"].shape[0], kw["wvT"].shape[1]
    nt = kw["trunk"].shape[0]
    if w not in KERNEL_WIDTHS or ke > 64 or kv > 64 or nt > 7 or \
            kw["wa"].shape[0] != 3 or not 0 <= skip_pos < nt:
        raise ValueError(f"the fused_radiance kernels do not take width {w}, "
                         f"embedding widths {ke}/{kv}, {nt} trunk layers, "
                         f"skip {skip_pos}")
    op, f32 = _OP_DTYPE[compute], torch.float32
    shapes = dict(_weight_shapes(w, ke, kv, nt, op),
                  em=(op, (n, ke)), de=(f32, (n, ke)), vpe=(op, (n, kv)),
                  p3=(f32, (n, 3)), g_e=(f32, (n, ke)), out=(f32, (n, 4)),
                  g_out=(f32, (n, 4)))
    for k, shape in _GRAD_SHAPES(w, ke, kv, nt).items():
        shapes["d_" + k] = (f32, shape)
    for name in names:
        dt, shape = shapes[name]
        check_operand(name, tensors[name], dt, shape, dev)
    scratch = _scratch(which, compute, w, dev)
    slots = torch.cuda.get_device_properties(dev).multi_processor_count
    ptrs = (ctypes.c_void_p * (len(names) + 1))(
        *[tensors[k].data_ptr() for k in names], scratch.data_ptr())
    ints = (ctypes.c_int * 7)(n, w, ke, kv, nt, skip_pos, slots)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _lib()
        fn = getattr(lib, f"psnerf_radiance_{which}"
                     + ("_f32" if compute == "float32" else ""))
        rc = fn(ptrs, ints, stream)
    if rc != 0:
        raise RuntimeError(f"fused_radiance {which} ({compute}) kernel "
                           "launch failed: "
                           + lib.psnerf_cuda_error_string(rc).decode())


def _scratch(which: str, compute: str, w: int, dev) -> torch.Tensor:
    """Device scratch of the persistent grid: one slot per SM, each holding
    a CTA's per-layer values of one tile (sizes from the library)."""
    slots = torch.cuda.get_device_properties(dev).multi_processor_count
    per_slot = _lib().psnerf_radiance_scratch_bytes(
        int(which == "bwd"), w, int(compute == "float32"))
    return torch.empty((slots * per_slot,), dtype=torch.uint8, device=dev)


_FWD_NAMES = ["em", "de", "vpe", "p3"] + _W_NAMES + ["out", "g_e"]
_BWD_NAMES = (["em", "de", "vpe", "p3", "g_e", "g_out"] + _W_NAMES
              + ["d_" + k for k in PACK_ORDER])


def _check_form(compute: str) -> None:
    if compute not in FORMS:
        raise ValueError(f"compute must be one of {FORMS}, got {compute!r}")


def radiance_forward(packed: dict, em, de, vpe, p3, skip_pos: int,
                     compute: str = "bfloat16"):
    """Kernel forward on CUDA tensors, operand form `compute`:
    (out [N, 4], g_e [N, ke])."""
    _check_form(compute)
    n = em.shape[0]
    dev = em.device
    op = _OP_DTYPE[compute]
    kw = _kernel_weights(packed)
    t = dict(kw, em=em.to(op).contiguous(), de=de.contiguous(),
             vpe=vpe.to(op).contiguous(), p3=p3.contiguous(),
             out=torch.empty((n, 4), dtype=torch.float32, device=dev),
             g_e=torch.empty((n, em.shape[1]), dtype=torch.float32,
                             device=dev))
    _launch("fwd", compute, kw, t, _FWD_NAMES, n, skip_pos)
    radiance_forward.launches[compute] += 1
    return t["out"], t["g_e"]


radiance_forward.launches = dict.fromkeys(FORMS, 0)


def radiance_backward(packed: dict, em, de, vpe, p3, g_e, g_out,
                      skip_pos: int, compute: str = "bfloat16") -> dict:
    """Kernel backward on CUDA tensors, operand form `compute`: f32
    gradients of sum(out * g_out) in the packed shapes. The CTAs add their
    tiles' sums into the zeroed gradients with f32 atomics, so the
    summation order varies from run to run."""
    _check_form(compute)
    n = em.shape[0]
    dev = em.device
    op = _OP_DTYPE[compute]
    kw = _kernel_weights(packed)
    w, ke = kw["w8l"].shape[0], em.shape[1]
    kv, nt = kw["wvT"].shape[1], kw["trunk"].shape[0]
    grads = {k: torch.zeros(s, dtype=torch.float32, device=dev)
             for k, s in _GRAD_SHAPES(w, ke, kv, nt).items()}
    t = dict(kw, em=em.to(op).contiguous(), de=de.contiguous(),
             vpe=vpe.to(op).contiguous(), p3=p3.contiguous(),
             g_e=g_e.contiguous(), g_out=g_out.float().contiguous(),
             **{"d_" + k: v for k, v in grads.items()})
    _launch("bwd", compute, kw, t, _BWD_NAMES, n, skip_pos)
    radiance_backward.launches[compute] += 1
    return grads


radiance_backward.launches = dict.fromkeys(FORMS, 0)


def reset_launches() -> None:
    """Set both kernels' counts of both forms to 0."""
    for fn in (radiance_forward, radiance_backward):
        fn.launches = dict.fromkeys(FORMS, 0)


class _RadianceOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, skip_pos, compute, em, de, vpe, p3, *weights):
        packed = dict(zip(PACK_ORDER, weights))
        if route(em) == "cpu":
            out, g_e = radiance_forward_plain(packed, em, de, vpe, p3,
                                              skip_pos, compute)
        else:
            out, g_e = radiance_forward(packed, em, de, vpe, p3, skip_pos,
                                        compute)
        ctx.skip_pos, ctx.compute = skip_pos, compute
        ctx.save_for_backward(em, de, vpe, p3, g_e, *weights)
        return out

    @staticmethod
    def backward(ctx, g_out):
        em, de, vpe, p3, g_e, *weights = ctx.saved_tensors
        packed = dict(zip(PACK_ORDER, weights))
        if route(em) == "cpu":
            d = radiance_backward_plain(packed, em, de, vpe, p3, g_e, g_out,
                                        ctx.skip_pos, ctx.compute)
        else:
            d = radiance_backward(packed, em, de, vpe, p3, g_e, g_out,
                                  ctx.skip_pos, ctx.compute)
        grads = [d[k].to(packed[k].dtype) for k in PACK_ORDER]
        return (None, None, None, None, None, None, *grads)


def fused_radiance_and_alpha(field, p: torch.Tensor, ray_d: torch.Tensor,
                             cfg, compute: str = "bfloat16"):
    """Drop-in for fields.occupancy.radiance_and_alpha on the training
    batch: (rgb [..., 3] in [0, 1], alpha [...]). Differentiable wrt the
    field's weights only. Any N (the kernels mask the ragged edge); leading
    batch dims are flattened. compute: the operand form, "float32" for
    the default field (compute_dtype="float32"), "bfloat16" for a bf16
    field."""
    _check_form(compute)
    shape = p.shape[:-1]
    em, de, vpe, p3 = radiance_inputs(p.reshape(-1, 3), ray_d.reshape(-1, 3),
                                      cfg)
    packed = pack_radiance(field, cfg, _OP_DTYPE[compute])
    out = _RadianceOp.apply(cfg.skips[0] - 1, compute, em, de, vpe, p3,
                            *[packed[k] for k in PACK_ORDER])
    rgb = (torch.tanh(out[:, :3]) * 0.5 + 0.5).reshape(*shape, 3)
    alpha = torch.sigmoid(-10.0 * out[:, 3]).reshape(shape)
    return rgb, alpha
