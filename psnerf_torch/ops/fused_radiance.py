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

Both come in the two operand forms of the TPU kernels, and both backwards
are a sweep over chunks of at most CHUNK points that writes every weight-
gradient operand to a device workspace (`sweep`), a split-K product of
those operands per chunk (`wgrad`), and a fixed-order sum of the partial
products (the reduce): deterministic from run to run.
  * bf16 operands (`compute="bfloat16"`, csrc/fused_radiance.cu): the
    forward (`fwd`) and the sweep run on the bf16 trunk engine
    (csrc/trunk_wgmma.cuh, weights packed once per call into k-step slabs,
    `bf16_slabs`); the workspace is bf16 in core-matrix tiles
    (`ws_index`), and the sweep also adds each tile's f32 column sums
    (the bias-like gradients, wp, wn, w8l) onto its consumer's slot,
    which the last weight-gradient pass folds into its split-K slots; the
    reduce is `slot_sum`. `bf16_launches` counts the fwd, sweep and wgrad
    launches, `slot_sum.launches` the reduces;
  * f32 operands (`compute="float32"`, the default field's form,
    csrc/fused_radiance_f32.cu; 3xTF32 wgmma, close to f32 products):
    a prologue splits the weights into tf32 hi/lo fragments (`split`),
    then the forward (`fwd`), `sweep`, `wgrad` and `reduce`; each of the
    five counts its launches in `f32_launches`.

Both fixed-order sums run on one engine, csrc/slot_reduce.cuh: out[i] =
((0 + s_0[i]) + s_1[i]) + ... over the slots in order, one float4 column a
thread. Each slot is laid out leaf after leaf (`f32_slot_layout`,
`bf16_slot_layout`), so the sum holds every gradient as a view.

Weight norm and the layout (skip row split, split geometry head,
appearance input split into [p, view PE, normal, feat] rows) are folded
outside the kernels by differentiable packing (`pack_radiance`), so
autograd chains the packed gradients into each WNLinear's v, g and b.
Points and directions get no gradient (the call sites' samples come from
the no-grad march).

`fused_radiance_and_alpha` runs a torch.autograd.Function. On CPU tensors
its forward and backward run the plain versions (`radiance_forward_plain`,
`radiance_backward_plain`: the kernels' arithmetic, and the backward's
explicit sweep, in PyTorch; the backward is the composition of
`radiance_sweep_plain` and `weight_grads_plain`, chunked as the kernels
chunk; `split_weights_plain` is the f32 prologue's). On CUDA tensors they
launch the kernels or raise. Launches are counted per form in
`radiance_forward.launches` and `radiance_backward.launches`
({"bfloat16": n, "float32": n}), per kernel in `f32_launches` and
`bf16_launches`, and the bf16 form's fixed-order sum in
`slot_sum.launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from psnerf_torch.core.encoding import nerf_embed, nerf_embed_dim
from psnerf_torch.fields.mlp import wn_weight
from psnerf_torch.ops.build import (check_operand, launch, load_library,
                                    pack_slabs, round_up, route)
from psnerf_torch.ops.fused_occ import fold_geometry

KERNEL_WIDTHS = (128, 256)
_OP_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FORMS = tuple(_OP_DTYPE)        # the operand forms, by `compute` name
PACK_ORDER = ["w0", "b0", "wskip", "trunk_w", "trunk_b", "w8f", "b8f", "w8l",
              "b8l", "wp", "wv", "wn", "wf", "ba0", "wa", "bab", "wa4", "ba4"]
F32_KERNELS = ("split", "fwd", "sweep", "wgrad", "reduce")
BF16_KERNELS = ("fwd", "sweep", "wgrad")   # the reduce is slot_sum
CHUNK = 65536        # points per backward sweep (both forms)
BF16_TILE = 128      # points per CTA tile of the bf16 kernels
_lib_handle = []
_lib_f32_handle = []


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


_WS_F32_ONLY = ("p3", "n3", "w8lt")


def ws_layout(w: int, ke: int, kv: int, nt: int,
              form: str = "float32") -> tuple[dict, int]:
    """The backward's workspace rows (one row = one feature over the
    points; csrc/fused_radiance_f32.cu:ws_layout, csrc/fused_radiance.cu:
    ws_rows): {name: (first row, rows)} and the rows per point. [feat; vpe;
    p3; n3] is one product's x block in the f32 form; the bf16 form takes
    p3, n3 and w8lt by f32 column sums in the sweep and has no rows for
    them. a, t, aa, gz, zb and tzb stack their layers."""
    rows = [("feat", w), ("vpe", kv), ("p3", 3), ("n3", 3), ("em", ke),
            ("ce", ke), ("a", (nt + 1) * w), ("t", nt * w), ("aa", 4 * w),
            ("gz", 4 * w), ("gfeat", w), ("w8lt", w), ("g8", 8),
            ("zb", (nt + 1) * w), ("tzb", (nt + 1) * w)]
    if form == "bfloat16":
        rows = [(k, n) for k, n in rows if k not in _WS_F32_ONLY]
    out, r = {}, 0
    for name, n in rows:
        out[name] = (r, n)
        r += n
    return out, r


@torch.no_grad()
def radiance_sweep_plain(packed: dict, em, de, vpe, p3, g_e, g_out,
                         skip_pos: int, compute: str = "bfloat16") -> dict:
    """The backward's sweep: recompute with the saved g_e, appearance
    backward, tangent forward of the normal path and the doubled reverse
    sweep. Returns the operands of every weight-gradient product, point-
    major ([N, rows] each, the workspace's rows by `ws_layout`): the x
    operands em, ce (the tangent c_e), vpe, p3, n3, feat, a (trunk
    activations, layer by layer), t (tangent activations), aa (appearance
    activations); the y operands gz (appearance z_bars, layer 0 first),
    gfeat, zb and tzb (the trunk's z_bar and tz_bar per layer), w8lt
    (g_logit a_last + t_last) and g8 ([g_rgb, g_logit, 0 x 4])."""
    r, cast = _ops(packed, compute)
    c = _forward_core(r, cast, em, de, vpe, p3, skip_pos, g_e=g_e)
    a, sprime = c["a"], c["sprime"]
    n_trunk = r["trunk_w"].shape[0]
    cat = lambda xs: torch.cat(xs, dim=1)

    # appearance backward
    g_rgb, g_logit = g_out[:, :3], g_out[:, 3]
    gz = cast(g_rgb) @ r["wa4"].T
    gzs = [None] * 4
    for j in range(r["wa"].shape[0] - 1, -1, -1):
        gz = gz * (c["za"][j + 1] > 0)
        gzs[j + 1] = gz
        gz = cast(gz) @ r["wa"][j].T
    gz = gz * (c["za"][0] > 0)
    gzs[0] = gz
    g_n = torch.stack([(gz * r["wn"][j]).sum(1) for j in range(3)], dim=1)
    g_feat = cast(gz) @ r["wf"].T

    # first-order seeds through the split geometry head
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
    t_bar = r["w8l"].expand_as(a[-1])

    # doubled reverse sweep through the trunk
    spp = lambda i: 100.0 * sprime[i] * (1.0 - sprime[i])
    zb, tzb = [None] * (n_trunk + 1), [None] * (n_trunk + 1)
    for i in range(n_trunk, -1, -1):
        zb[i] = h_bar * sprime[i] + t_bar * spp(i) * tz[i]
        tzb[i] = t_bar * sprime[i]
        if i > 0:
            h_bar = cast(zb[i]) @ r["trunk_w"][i - 1].T
            t_bar = cast(tzb[i]) @ r["trunk_w"][i - 1].T
    return dict(
        feat=c["feat"], vpe=vpe, p3=p3, n3=c["n3"], em=em, ce=c_e,
        a=cat(a), t=cat(t_list[:-1]), aa=cat(c["aa"]), gz=cat(gzs),
        gfeat=g_feat, w8lt=g_logit[:, None] * a[-1] + t_list[-1],
        g8=cat([g_rgb, g_logit[:, None], g_rgb.new_zeros((g_rgb.shape[0], 4))]),
        zb=cat(zb), tzb=cat(tzb))


@torch.no_grad()
def weight_grads_plain(ws: dict, skip_pos: int,
                       compute: str = "bfloat16") -> dict:
    """Every weight gradient from the sweep's operands (`radiance_sweep_
    plain`): products x^T y over the points and the bias-like column sums
    of y, in the packed shapes."""
    cast = _ops({}, compute)[1]
    dTn = lambda x, y: cast(x).T @ cast(y)
    w = ws["feat"].shape[1]
    nt = ws["t"].shape[1] // w
    lay = lambda k, i: ws[k][:, i * w:(i + 1) * w]
    g_rgb, g_logit = ws["g8"][:, :3], ws["g8"][:, 3]
    gz0 = lay("gz", 0)
    s1 = skip_pos + 1
    return {
        "w0": dTn(ws["em"], lay("zb", 0)) + dTn(ws["ce"], lay("tzb", 0)),
        "b0": lay("zb", 0).sum(0),
        "wskip": dTn(ws["em"], lay("zb", s1)) + dTn(ws["ce"], lay("tzb", s1)),
        "trunk_w": torch.stack([dTn(lay("a", i - 1), lay("zb", i))
                                + dTn(lay("t", i - 1), lay("tzb", i))
                                for i in range(1, nt + 1)]),
        "trunk_b": torch.stack([lay("zb", i).sum(0)
                                for i in range(1, nt + 1)]),
        "w8f": dTn(lay("a", nt), ws["gfeat"]), "b8f": ws["gfeat"].sum(0),
        "w8l": ws["w8lt"].sum(0), "b8l": g_logit.sum().reshape(1),
        "wp": torch.stack([(ws["p3"][:, j:j + 1] * gz0).sum(0)
                           for j in range(3)]),
        "wv": dTn(ws["vpe"], gz0),
        "wn": torch.stack([(ws["n3"][:, j:j + 1] * gz0).sum(0)
                           for j in range(3)]),
        "wf": dTn(ws["feat"], gz0), "ba0": gz0.sum(0),
        "wa": torch.stack([dTn(lay("aa", j), lay("gz", j + 1))
                           for j in range(3)]),
        "bab": torch.stack([lay("gz", j + 1).sum(0) for j in range(3)]),
        "wa4": dTn(lay("aa", 3), g_rgb), "ba4": g_rgb.sum(0)}


@torch.no_grad()
def radiance_backward_plain(packed: dict, em, de, vpe, p3, g_e, g_out,
                            skip_pos: int, compute: str = "bfloat16") -> dict:
    """Gradients of sum(out * g_out) wrt every packed operand (f32, the
    packed shapes), by the backward kernels' explicit sweep: the sweep's
    operands, then the weight gradients, over chunks of CHUNK points (as
    the kernels chunk) summed in order."""
    n = em.shape[0]
    d = None
    for b in range(0, max(n, 1), CHUNK):
        s = slice(b, b + CHUNK)
        ws = radiance_sweep_plain(packed, em[s], de[s], vpe[s], p3[s],
                                  g_e[s], g_out[s], skip_pos, compute)
        dc = weight_grads_plain(ws, skip_pos, compute)
        d = dc if d is None else {k: d[k] + dc[k] for k in d}
    return d


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from 0
    (f32 values, finite)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def _split_mats(packed: dict) -> list:
    """Each product weight as the B [K, N] its products read, in the order
    of the kernels' split weights (csrc/fused_radiance_f32.cu:frag_list):
    w0, wskip, trunk_w[i], w8f, wv, wf, wa[j], wa4 (3 columns padded to
    8), then the transposes w0^T and wskip^T (ke columns padded to 64),
    trunk_w[i]^T, w8f^T, wf^T, wa[j]^T."""
    p = {k: v.float() for k, v in packed.items()}
    pad = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[1]))
    return [p["w0"], p["wskip"], *p["trunk_w"], p["w8f"], p["wv"], p["wf"],
            *p["wa"], pad(p["wa4"], 8), pad(p["w0"].T, 64),
            pad(p["wskip"].T, 64), *[t.T for t in p["trunk_w"]], p["w8f"].T,
            p["wf"].T, *[t.T for t in p["wa"]]]


@torch.no_grad()
def split_weights_plain(packed: dict) -> torch.Tensor:
    """The prologue's output: every product weight split into tf32 hi and
    lo = tf32(x - hi), as k-step slabs for wgmma. Slab ks of B [K, N] is
    a hi part then a lo part, each K-major in core matrices of 8 columns x
    4 k: float (n // 8) * 64 + c * 32 + (n % 8) * 4 + kk of a part holds
    B[8 ks + 4 c + kk, n]. Returns [words, 4] int32 (the bit patterns)."""
    out = []
    for b in _split_mats(packed):
        k, n = b.shape
        hi = _tf32_rna(b)
        lo = _tf32_rna(b - hi)
        # [ks, c, kk, n // 8, n % 8] -> [ks, n // 8, c, n % 8, kk]
        part = lambda x: x.reshape(k // 8, 2, 4, n // 8, 8).permute(
            0, 3, 1, 4, 2).reshape(k // 8, -1)
        slabs = torch.cat([part(hi), part(lo)], dim=1)
        out.append(slabs.reshape(-1, 4).contiguous().view(torch.int32))
    return torch.cat(out)


# ----------------------------------------------------------------- kernels

_LAUNCH_ARGS = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.c_void_p]


def _lib():
    """The bf16 form's library (csrc/fused_radiance.cu)."""
    if not _lib_handle:
        lib = load_library("fused_radiance")
        for k in (*BF16_KERNELS, "slot_sum"):
            fn = getattr(lib, f"psnerf_radiance_{k}")
            fn.argtypes = _LAUNCH_ARGS
            fn.restype = ctypes.c_int
        lib.psnerf_radiance_sizes.argtypes = [ctypes.POINTER(ctypes.c_int),
                                              ctypes.POINTER(ctypes.c_longlong)]
        lib.psnerf_radiance_sizes.restype = ctypes.c_int
        lib.psnerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.psnerf_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle.append(lib)
    return _lib_handle[0]


def _lib_f32():
    """The f32 form's library (csrc/fused_radiance_f32.cu)."""
    if not _lib_f32_handle:
        lib = load_library("fused_radiance_f32")
        for k in F32_KERNELS:
            fn = getattr(lib, f"psnerf_rf32_{k}")
            fn.argtypes = _LAUNCH_ARGS
            fn.restype = ctypes.c_int
        lib.psnerf_rf32_sizes.argtypes = [ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_longlong)]
        lib.psnerf_rf32_sizes.restype = ctypes.c_int
        lib.psnerf_rf32_error_string.argtypes = [ctypes.c_int]
        lib.psnerf_rf32_error_string.restype = ctypes.c_char_p
        _lib_f32_handle.append(lib)
    return _lib_f32_handle[0]


_GRAD_SHAPES = lambda w, ke, kv, nt: {
    "w0": (ke, w), "b0": (w,), "wskip": (ke, w), "trunk_w": (nt, w, w),
    "trunk_b": (nt, w), "w8f": (w, w), "b8f": (w,), "w8l": (w,), "b8l": (1,),
    "wp": (3, w), "wv": (kv, w), "wn": (3, w), "wf": (w, w), "ba0": (w,),
    "wa": (3, w, w), "bab": (3, w), "wa4": (w, 3), "ba4": (3,)}


def bf16_slot_layout(w: int, ke: int, kv: int, nt: int) -> tuple:
    """The bf16 backward's split-K slot, and its gradients as one flat
    buffer (csrc/fused_radiance.cu `wplan` and `cs_layout`, which the
    library's sizes are checked against): ({leaf: its offset}, in the
    packed order, the floats of the products' region, the floats of the
    column sums' region, which is also one column-sum slot). Leaf after
    leaf, every one contiguous: the products' region (trunk_w, w0, wskip,
    w8f, wa, then one product's rows wf, wv, then wa4), padded to a
    multiple of 4 floats, then the column sums' region (trunk_b, b0, b8f,
    bab, ba0, wp, wn, w8l, ba4, b8l and 4 zeros). The reduce sums the
    split-K slots, so every gradient is a view."""
    ww = w * w
    prods = [("trunk_w", nt * ww), ("w0", ke * w), ("wskip", ke * w),
             ("w8f", ww), ("wa", 3 * ww), ("wf", ww), ("wv", kv * w),
             ("wa4", 3 * w)]
    sums = [("trunk_b", nt * w), ("b0", w), ("b8f", w), ("bab", 3 * w),
            ("ba0", w), ("wp", 3 * w), ("wn", 3 * w), ("w8l", w),
            ("ba4", 3), ("b8l", 1), (None, 4)]
    out, at = {}, 0
    for k, n in prods:
        out[k] = at
        at += n
    p_floats = round_up(at, 4)
    at = p_floats
    for k, n in sums:
        if k is not None:
            out[k] = at
        at += n
    return {k: out[k] for k in PACK_ORDER}, p_floats, at - p_floats


def f32_slot_layout(w: int, ke: int, kv: int, nt: int) -> tuple:
    """The f32 backward's weight-gradient slot (csrc/fused_radiance_f32.cu
    `wplan`, which the library's sizes are checked against): ({leaf: its
    offset}, in the packed order, and the floats of one slot). Leaf after
    leaf, every one contiguous, in the order the weight-gradient products
    write them: trunk_w, trunk_b, w0, b0, wskip, w8f, b8f, wa, bab, then
    one product's rows wf, wv, wp, wn, then ba0, w8l, wa4 (3 of the rgb
    head's 8 columns), and that head's column sums ba4, b8l and 4 zeros.
    So the reduce's sum of the slots holds each gradient as a view."""
    ww = w * w
    runs = [("trunk_w", nt * ww), ("trunk_b", nt * w), ("w0", ke * w),
            ("b0", w), ("wskip", ke * w), ("w8f", ww), ("b8f", w),
            ("wa", 3 * ww), ("bab", 3 * w), ("wf", ww), ("wv", kv * w),
            ("wp", 3 * w), ("wn", 3 * w), ("ba0", w), ("w8l", w),
            ("wa4", 3 * w), ("ba4", 3), ("b8l", 1), (None, 4)]
    at, out = 0, {}
    for k, n in runs:
        if k is not None:
            out[k] = at
        at += n
    return {k: out[k] for k in PACK_ORDER}, at


def bf16_slab_mats(packed: dict) -> list:
    """Every product weight of the bf16 kernels as the [N, K] (outputs,
    inputs) its products read, in the order the slabs are packed (csrc/
    fused_radiance.cu `mats`), in three runs: the narrow-K products' w0,
    wskip, wv (transposed); the forward products' trunk_w[i], w8f, wf,
    wa[j] (transposed); the reverse products' trunk_w[i], wskip and w0
    (their ke rows padded to W), wa[j], wf, w8f (as packed). Each run of
    W x W matrices is one stacked [m, W, W] tensor."""
    bf = torch.bfloat16
    p = {k: v.detach().to(bf) for k, v in packed.items()}
    w = p["w8f"].shape[0]
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, w - x.shape[0]))
    fwd = torch.cat([p["trunk_w"], p["w8f"][None], p["wf"][None], p["wa"]]
                    ).transpose(1, 2)
    rev = torch.cat([p["trunk_w"], pad(p["wskip"])[None],
                     pad(p["w0"])[None], p["wa"], p["wf"][None],
                     p["w8f"][None]])
    return [p["w0"].T, p["wskip"].T, p["wv"].T, fwd, rev]


@torch.no_grad()
def bf16_slabs(packed: dict) -> torch.Tensor:
    """The bf16 kernels' weights packed once per call: `bf16_slab_mats` as
    one run of k-step slabs (build.pack_slabs, each stacked run at once),
    in the order the forward and the sweep stream them."""
    runs = []
    for m in bf16_slab_mats(packed):
        if m.dim() == 2:
            runs.append(pack_slabs([m]))
        else:
            c, n, k = m.shape
            runs.append(m.reshape(c, n // 8, 8, k // 16, 2, 8)
                        .permute(0, 3, 1, 4, 2, 5).reshape(-1))
    return torch.cat(runs).contiguous()


def ws_index(f: torch.Tensor, p: torch.Tensor, ld: int) -> torch.Tensor:
    """The bf16 workspace's element of feature row f and point p (ld
    points a row, a multiple of BF16_TILE): core matrices of 8 features x 8
    points, so an 8-feature group's points are contiguous (csrc/
    fused_radiance.cu ws_idx)."""
    return ((f >> 3) * (ld >> 3) + (p >> 3)) * 64 + (f & 7) * 8 + (p & 7)


def pack_workspace(ws: dict, dims: tuple, ld: int) -> torch.Tensor:
    """A point-major sweep result (radiance_sweep_plain's rows) as the bf16
    workspace the sweep kernel writes: the rows of ws_layout(...,
    "bfloat16"), zero past the points given."""
    lay, rows = ws_layout(*dims, "bfloat16")
    n = next(iter(ws.values())).shape[0]
    mat = torch.zeros((rows, ld), dtype=torch.float32)
    for k, (o, r) in lay.items():
        mat[o:o + r, :n] = ws[k].T.float()
    return (mat.reshape(rows // 8, 8, ld // 8, 8).permute(0, 2, 1, 3)
            .reshape(-1).to(torch.bfloat16))


def unpack_workspace(flat: torch.Tensor, dims: tuple, ld: int,
                     n: int) -> dict:
    """The bf16 workspace's rows, point-major ([n, rows] f32 each) as
    radiance_sweep_plain returns them."""
    lay, rows = ws_layout(*dims, "bfloat16")
    mat = (flat.reshape(rows // 8, ld // 8, 8, 8).permute(0, 2, 1, 3)
           .reshape(rows, ld))
    return {k: mat[o:o + r, :n].T.float() for k, (o, r) in lay.items()}


def _dims(packed: dict, skip_pos: int) -> tuple:
    """(width, ke, kv, n_trunk) of the packed operands; raises for what the
    kernels do not take."""
    w = packed["w8l"].shape[0]
    ke, kv = packed["w0"].shape[0], packed["wv"].shape[0]
    nt = packed["trunk_w"].shape[0]
    if w not in KERNEL_WIDTHS or ke > 64 or kv > 64 or nt > 7 or \
            packed["wa"].shape[0] != 3 or not 0 <= skip_pos < nt:
        raise ValueError(f"the fused_radiance kernels do not take width {w}, "
                         f"embedding widths {ke}/{kv}, {nt} trunk layers, "
                         f"skip {skip_pos}")
    return w, ke, kv, nt


def _need_cuda(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the fused_radiance kernels need CUDA tensors, got "
                         f"{dev}")


def slot_sum_plain(slots: torch.Tensor) -> torch.Tensor:
    """slot_sum's arithmetic: the rows of slots [S, total] added in order,
    from zero."""
    out = torch.zeros(slots.shape[1:], dtype=slots.dtype,
                      device=slots.device)
    for row in slots:
        out += row
    return out


def slot_sum(slots: torch.Tensor, out: torch.Tensor | None = None
             ) -> torch.Tensor:
    """out[i] = sum over s = 0, 1, ... of slots[s, i] for slots [S, total]
    f32, added in that order, the same bits on every run (the bf16
    backward's reduce). CPU tensors take slot_sum_plain; CUDA tensors
    launch the slot reduction engine (counted in slot_sum.launches), which
    loads 16 bytes at a time: total must be a multiple of 4, the rows and
    `out` (a new [total] tensor if None) 16-byte aligned and S at least
    1."""
    if route(slots) == "cpu":
        got = slot_sum_plain(slots)
        if out is None:
            return got
        out.copy_(got)
        return out
    dev = slots.device
    check_operand("slots", slots, torch.float32, slots.shape, dev)
    n_slots, total = slots.shape
    if out is None:
        out = torch.empty((total,), dtype=torch.float32, device=dev)
    check_operand("out", out, torch.float32, (total,), dev)
    if total % 4 or slots.data_ptr() % 16 or out.data_ptr() % 16 or \
            n_slots < 1:
        raise ValueError("slot_sum needs a multiple of 4 floats per slot, "
                         f"16-byte aligned slots and output and one slot or "
                         f"more; got {n_slots} x {total} floats at address "
                         f"{slots.data_ptr():#x}")
    lib = _lib()
    launch(lib.psnerf_radiance_slot_sum, lib.psnerf_cuda_error_string, dev,
           [slots, out], [total, n_slots], "fused_radiance slot sum")
    slot_sum.launches += 1
    return out


slot_sum.launches = 0


# ----------------------------------------------- the bf16 form's kernels

bf16_launches = dict.fromkeys(BF16_KERNELS, 0)
_BF16_VECTORS = ["b0", "trunk_b", "b8f", "w8l", "b8l", "wp", "wn", "ba0",
                 "bab"]


def _launch_bf16(kernel: str, dev, tensors: list, ints: list) -> None:
    """Launch psnerf_radiance_<kernel> on the current stream of `dev` with
    the tensors' device pointers, and count it; raises if the launch
    fails."""
    lib = _lib()
    launch(getattr(lib, f"psnerf_radiance_{kernel}"),
           lib.psnerf_cuda_error_string, dev, tensors, ints,
           f"fused_radiance bf16 {kernel}")
    bf16_launches[kernel] += 1


def bf16_sizes(w: int, ke: int, kv: int, nt: int) -> dict:
    """The bf16 kernels' buffer sizes at one shape (from the library,
    checked against the wrapper's slab, workspace and slot layouts)."""
    out = (ctypes.c_longlong * 25)()
    rc = _lib().psnerf_radiance_sizes((ctypes.c_int * 4)(w, ke, kv, nt), out)
    if rc != 0:
        raise ValueError(f"the bf16 fused_radiance kernels do not take width "
                         f"{w}, embedding widths {ke}/{kv}, {nt} layers")
    sizes = dict(zip(["slab_bytes", "ws_rows", "fwd_scratch",
                      "sweep_scratch", "p_floats", "c_floats",
                      "wgrad_tiles"], out))
    mats = (2 * ke + kv) * w + (2 * nt + 12) * w * w
    if sizes["slab_bytes"] != 2 * mats:
        raise RuntimeError("slab layouts of the library and the wrapper "
                           "differ")
    if sizes["ws_rows"] != ws_layout(w, ke, kv, nt, "bfloat16")[1]:
        raise RuntimeError("workspace layouts of the library and the "
                           "wrapper differ")
    leaves, p_floats, c_floats = bf16_slot_layout(w, ke, kv, nt)
    if (sizes["p_floats"], sizes["c_floats"]) != (p_floats, c_floats) or \
            list(out[7:]) != list(leaves.values()):
        raise RuntimeError("weight-gradient slot layouts of the library and "
                           "the wrapper differ")
    return sizes


def _bf16_operands(packed: dict, dims: tuple, dev, slabs, sizes) -> list:
    """The packed slabs (checked against the library's `sizes`) and the f32
    vectors the bf16 kernels read: b0, trunk_b, b8f, w8l, b8l, wp, wn, ba0,
    bab, wa4t ([3, W], the rgb head's bf16 values), ba4."""
    check_operand("slabs", slabs, torch.bfloat16,
                  (sizes["slab_bytes"] // 2,), dev)
    w = dims[0]
    shapes = dict(_GRAD_SHAPES(*dims), wa4t=(3, w))
    t = {k: packed[k].detach().float() for k in _BF16_VECTORS + ["ba4"]}
    t["wa4t"] = packed["wa4"].detach().to(torch.bfloat16).float().T
    out = []
    for k in _BF16_VECTORS + ["wa4t", "ba4"]:
        x = t[k].contiguous()
        if x.data_ptr() % 16:        # a view (b8f = b_last[1:]): 8-byte loads
            x = x.clone()
        check_operand(k, x, torch.float32, shapes[k], dev)
        out.append(x)
    return [slabs] + out


def _bf16_points(dims, n, dev, **t) -> list:
    """em and vpe in bf16 (the products' operands), the rest f32."""
    w, ke, kv, nt = dims
    shapes = dict(em=(n, ke), vpe=(n, kv), de=(n, ke), p3=(n, 3),
                  g_e=(n, ke), g_out=(n, 4))
    out = []
    for k, x in t.items():
        dt = torch.bfloat16 if k in ("em", "vpe") else torch.float32
        x = x.to(dt).contiguous()
        check_operand(k, x, dt, shapes[k], dev)
        out.append(x)
    return out


def radiance_forward_bf16(packed: dict, em, de, vpe, p3, skip_pos: int,
                          slabs=None):
    """The bf16 form's forward kernel: (out [N, 4], g_e [N, ke]). slabs:
    bf16_slabs(packed), packed here if None."""
    dims = _dims(packed, skip_pos)
    w, ke, kv, nt = dims
    n, dev = em.shape[0], em.device
    _need_cuda(dev)
    sz = bf16_sizes(*dims)
    if slabs is None:
        slabs = bf16_slabs(packed)
    slots = _slots(dev)
    ins = _bf16_points(dims, n, dev, em=em, vpe=vpe, de=de, p3=p3)
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    g_e = torch.empty((n, ke), dtype=torch.float32, device=dev)
    scratch = torch.empty((slots * sz["fwd_scratch"],), dtype=torch.float32,
                          device=dev)
    _launch_bf16("fwd", dev,
                 [*ins, *_bf16_operands(packed, dims, dev, slabs, sz), out,
                  g_e, scratch], [n, w, ke, kv, nt, skip_pos, slots])
    return out, g_e


def _slots(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def wgrad_splits(tiles: int, slots: int, most: int = 16) -> int:
    """Split-K factor of a weight-gradient kernel (one CTA per SM): the
    number of splits, at least enough to fill every SM once, whose CTAs
    fill their last wave best (the smaller on a tie)."""
    def fill(s):
        waves = tiles * s / slots
        return waves / -(-tiles * s // slots)
    cands = [s for s in range(1, most + 1) if tiles * s >= slots] or [most]
    return max(cands, key=lambda s: (fill(s), -s))


class Bf16Backward:
    """The bf16 form's backward, kernel by kernel, on one batch: for each
    chunk c `sweep(c)` (the workspace, and its column sums: each consumer
    warpgroup of the grid adds its tiles' onto its own column-sum slot,
    the chunks in order onto the same slots, zeroed by `sweep(0)`) and
    `wgrad(c)` (its split-K slots; the last chunk's splits also add the
    column-sum slots, a share each in order, into their slots' column-sum
    region), then `reduce()` sums the split-K slots by one `slot_sum` into
    `sum` and returns `grads`, its views (`bf16_slot_layout`). Allocates
    the workspace (ws_rows x round_up(min(N, CHUNK), 128) bf16), the
    slots, the scratch and the sum once; `run()` is all of it in
    order."""

    def __init__(self, packed, em, de, vpe, p3, g_e, g_out, skip_pos,
                 slabs=None):
        self.dims = _dims(packed, skip_pos)
        self.n, dev = em.shape[0], em.device
        _need_cuda(dev)
        self.dev, self.skip_pos = dev, skip_pos
        sz = bf16_sizes(*self.dims)
        if slabs is None:
            slabs = bf16_slabs(packed)
        self.ins = _bf16_points(self.dims, self.n, dev, em=em, vpe=vpe,
                                de=de, p3=p3)
        self.weights = _bf16_operands(packed, self.dims, dev, slabs, sz)
        self.grad_ins = _bf16_points(self.dims, self.n, dev, g_e=g_e,
                                     g_out=g_out)
        leaves, self.p_floats, self.c_floats = bf16_slot_layout(*self.dims)
        self.slots = _slots(dev)
        self.n_chunks = max(1, -(-self.n // CHUNK))
        self.ld = round_up(max(1, min(self.n, CHUNK)), BF16_TILE)
        self.splits = wgrad_splits(sz["wgrad_tiles"], self.slots)
        # the first (largest) chunk's grid: two column-sum slots a CTA
        self.grid = min(-(-self._chunk(0)[1] // BF16_TILE), self.slots)
        f32 = torch.float32
        self.ws = torch.empty((sz["ws_rows"] * self.ld,),
                              dtype=torch.bfloat16, device=dev)
        self.partial = torch.empty((self.n_chunks * self.splits,
                                    self.p_floats + self.c_floats),
                                   dtype=f32, device=dev)
        self.colsums = torch.empty((2 * max(1, self.grid), self.c_floats),
                                   dtype=f32, device=dev)
        self.scratch = torch.empty((self.slots * sz["sweep_scratch"],),
                                   dtype=f32, device=dev)
        self.sum = torch.empty((self.p_floats + self.c_floats,), dtype=f32,
                               device=dev)
        shapes = _GRAD_SHAPES(*self.dims)
        self.grads = {k: self.sum[o:o + math.prod(shapes[k])].view(shapes[k])
                      for k, o in leaves.items()}

    def workspace_bytes(self) -> int:
        return (self.ws.numel() * 2 + self.partial.numel() * 4
                + self.colsums.numel() * 4)

    def _chunk(self, c):
        b = c * CHUNK
        return b, min(CHUNK, self.n - b)

    def sweep(self, c):
        w, ke, kv, nt = self.dims
        b, nc = self._chunk(c)
        if c == 0:
            self.colsums.zero_()
        _launch_bf16("sweep", self.dev,
                     [*self.ins, *self.weights, *self.grad_ins, self.ws,
                      self.colsums, self.scratch],
                     [nc, b, self.ld, w, ke, kv, nt, self.skip_pos,
                      self.slots])

    def wgrad(self, c):
        w, ke, kv, nt = self.dims
        _, nc = self._chunk(c)
        _launch_bf16("wgrad", self.dev, [self.ws, self.partial, self.colsums],
                     [round_up(nc, BF16_TILE), self.ld, w, ke, kv, nt,
                      self.skip_pos, self.splits, c * self.splits,
                      self.colsums.shape[0], int(c == self.n_chunks - 1)])

    def reduce(self) -> dict:
        slot_sum(self.partial, out=self.sum)
        return self.grads

    def workspace(self, c: int = 0) -> dict:
        """Chunk c's workspace after its sweep, point-major as
        radiance_sweep_plain returns it (a check; copies)."""
        return unpack_workspace(self.ws, self.dims, self.ld,
                                self._chunk(c)[1])

    def run(self) -> dict:
        for c in range(self.n_chunks):
            self.sweep(c)
            self.wgrad(c)
        return self.reduce()


# ------------------------------------------------ the f32 form's kernels

f32_launches = dict.fromkeys(F32_KERNELS, 0)
_F32_WEIGHTS = ["w0", "wskip", "trunk_w", "w8f", "wv", "wf", "wa", "wa4"]
_F32_VECTORS = ["b0", "trunk_b", "b8f", "w8l", "b8l", "wp", "wn", "ba0",
                "bab", "ba4", "wa4"]


def _launch_f32(kernel: str, dev, tensors: list, ints: list) -> None:
    """Launch psnerf_rf32_<kernel> on the current stream of `dev` with the
    tensors' device pointers, and count it; raises if the launch fails."""
    lib = _lib_f32()
    launch(getattr(lib, f"psnerf_rf32_{kernel}"), lib.psnerf_rf32_error_string,
           dev, tensors, ints, f"fused_radiance f32 {kernel}")
    f32_launches[kernel] += 1


def f32_sizes(w: int, ke: int, kv: int, nt: int) -> dict:
    """The f32 kernels' buffer sizes at one shape (from the library,
    checked against the wrapper's workspace and slot layouts)."""
    out = (ctypes.c_longlong * 24)()
    rc = _lib_f32().psnerf_rf32_sizes((ctypes.c_int * 4)(w, ke, kv, nt), out)
    if rc != 0:
        raise ValueError(f"the f32 fused_radiance kernels do not take width "
                         f"{w}, embedding widths {ke}/{kv}, {nt} layers")
    sizes = dict(zip(["split_words", "ws_rows", "fwd_scratch",
                      "sweep_scratch", "slot_floats", "wgrad_tiles"], out))
    if sizes["ws_rows"] != ws_layout(w, ke, kv, nt)[1]:
        raise RuntimeError("workspace layouts of the library and the "
                           "wrapper differ")
    leaves, total = f32_slot_layout(w, ke, kv, nt)
    if sizes["slot_floats"] != total or list(out[6:]) != list(leaves.values()):
        raise RuntimeError("weight-gradient slot layouts of the library and "
                           "the wrapper differ")
    return sizes


def _f32_operands(packed: dict, names: list, dims: tuple, dev) -> list:
    shapes = _GRAD_SHAPES(*dims)
    out = []
    for k in names:
        x = packed[k].contiguous()
        check_operand(k, x, torch.float32, shapes[k], dev)
        out.append(x)
    return out


def split_weights(packed: dict, skip_pos: int) -> torch.Tensor:
    """The prologue kernel: `split_weights_plain`'s [words, 4] int32 on
    the card."""
    dims = _dims(packed, skip_pos)
    dev = packed["w0"].device
    _need_cuda(dev)
    srcs = _f32_operands(packed, _F32_WEIGHTS, dims, dev)
    out = torch.empty((f32_sizes(*dims)["split_words"], 4), dtype=torch.int32,
                      device=dev)
    _launch_f32("split", dev, srcs + [out], list(dims))
    return out


def _point_operands(dims, n, dev, **t) -> list:
    w, ke, kv, nt = dims
    shapes = dict(em=(n, ke), de=(n, ke), vpe=(n, kv), p3=(n, 3),
                  g_e=(n, ke), g_out=(n, 4))
    out = []
    for k, x in t.items():
        x = x.contiguous()
        check_operand(k, x, torch.float32, shapes[k], dev)
        out.append(x)
    return out


def radiance_forward_f32(packed: dict, em, de, vpe, p3, skip_pos: int):
    """The f32 form's forward (prologue, then the forward kernel):
    (out [N, 4], g_e [N, ke])."""
    dims = _dims(packed, skip_pos)
    w, ke, kv, nt = dims
    n, dev = em.shape[0], em.device
    _need_cuda(dev)
    frags = split_weights(packed, skip_pos)
    slots = _slots(dev)
    ins = _point_operands(dims, n, dev, em=em, de=de, vpe=vpe, p3=p3)
    vec = _f32_operands(packed, _F32_VECTORS, dims, dev)
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    g_e = torch.empty((n, ke), dtype=torch.float32, device=dev)
    scratch = torch.empty((slots * f32_sizes(*dims)["fwd_scratch"],),
                          dtype=torch.float32, device=dev)
    _launch_f32("fwd", dev, [*ins, frags, *vec, out, g_e, scratch],
                [n, w, ke, kv, nt, skip_pos, slots])
    return out, g_e


class F32Backward:
    """The f32 form's backward, kernel by kernel, on one batch: `split()`
    (the prologue), then for each chunk c `sweep(c)` and `wgrad(c)`, then
    `reduce()` sums the split-K slots into `sum` and returns `grads`, its
    views (`f32_slot_layout`). Allocates the workspace (ws_rows x
    round_up(min(N, CHUNK), 64) f32), the split-K slots, the scratch and
    the sum once; `run()` is all of it in order."""

    def __init__(self, packed, em, de, vpe, p3, g_e, g_out, skip_pos):
        self.dims = _dims(packed, skip_pos)
        self.n, dev = em.shape[0], em.device
        _need_cuda(dev)
        self.dev, self.packed, self.skip_pos = dev, packed, skip_pos
        self.ins = _point_operands(self.dims, self.n, dev, em=em, de=de,
                                   vpe=vpe, p3=p3)
        self.grad_ins = _point_operands(self.dims, self.n, dev, g_e=g_e,
                                        g_out=g_out)
        self.vec = _f32_operands(packed, _F32_VECTORS, self.dims, dev)
        sz = f32_sizes(*self.dims)
        leaves, self.slot_floats = f32_slot_layout(*self.dims)
        self.slots = _slots(dev)
        self.n_chunks = max(1, -(-self.n // CHUNK))
        self.ld = round_up(max(1, min(self.n, CHUNK)), 64)
        self.splits = wgrad_splits(sz["wgrad_tiles"], self.slots)
        f32 = torch.float32
        self.ws = torch.empty((sz["ws_rows"] * self.ld,), dtype=f32,
                              device=dev)
        self.partial = torch.empty(
            (self.n_chunks * self.splits, self.slot_floats), dtype=f32,
            device=dev)
        self.scratch = torch.empty((self.slots * sz["sweep_scratch"],),
                                   dtype=f32, device=dev)
        self.sum = torch.empty((self.slot_floats,), dtype=f32, device=dev)
        shapes = _GRAD_SHAPES(*self.dims)
        self.grads = {k: self.sum[o:o + math.prod(shapes[k])].view(shapes[k])
                      for k, o in leaves.items()}
        self.frags = None

    def workspace_bytes(self) -> int:
        return self.ws.numel() * 4 + self.partial.numel() * 4

    def _chunk(self, c):
        b = c * CHUNK
        return b, min(CHUNK, self.n - b)

    def split(self):
        self.frags = split_weights(self.packed, self.skip_pos)

    def sweep(self, c):
        w, ke, kv, nt = self.dims
        b, nc = self._chunk(c)
        _launch_f32("sweep", self.dev,
                    [*self.ins, self.frags, *self.vec, *self.grad_ins,
                     self.ws, self.scratch],
                    [nc, b, self.ld, w, ke, kv, nt, self.skip_pos,
                     self.slots])

    def wgrad(self, c):
        w, ke, kv, nt = self.dims
        _, nc = self._chunk(c)
        _launch_f32("wgrad", self.dev, [self.ws, self.partial],
                    [round_up(nc, 64), self.ld, w, ke, kv, nt, self.skip_pos,
                     self.splits, c * self.splits])

    def reduce(self) -> dict:
        _launch_f32("reduce", self.dev, [self.partial, self.sum],
                    [self.slot_floats, self.partial.shape[0]])
        return self.grads

    def workspace(self, c: int = 0) -> dict:
        """Chunk c's workspace after its sweep, point-major as
        radiance_sweep_plain returns it (a check; copies)."""
        _, nc = self._chunk(c)
        rows = self.ws.reshape(-1, self.ld)
        lay, _ = ws_layout(*self.dims)
        return {k: rows[o:o + r, :nc].T.contiguous()
                for k, (o, r) in lay.items()}

    def run(self) -> dict:
        self.split()
        for c in range(self.n_chunks):
            self.sweep(c)
            self.wgrad(c)
        return self.reduce()


def _check_form(compute: str) -> None:
    if compute not in FORMS:
        raise ValueError(f"compute must be one of {FORMS}, got {compute!r}")


def radiance_forward(packed: dict, em, de, vpe, p3, skip_pos: int,
                     compute: str = "bfloat16", slabs=None):
    """Kernel forward on CUDA tensors, operand form `compute`:
    (out [N, 4], g_e [N, ke]). slabs: the bf16 form's packed weights
    (bf16_slabs), packed here if None."""
    _check_form(compute)
    if compute == "float32":
        out, g_e = radiance_forward_f32(packed, em, de, vpe, p3, skip_pos)
    else:
        out, g_e = radiance_forward_bf16(packed, em, de, vpe, p3, skip_pos,
                                         slabs)
    radiance_forward.launches[compute] += 1
    return out, g_e


radiance_forward.launches = dict.fromkeys(FORMS, 0)


def radiance_backward(packed: dict, em, de, vpe, p3, g_e, g_out,
                      skip_pos: int, compute: str = "bfloat16",
                      slabs=None) -> dict:
    """Kernel backward on CUDA tensors, operand form `compute`: f32
    gradients of sum(out * g_out) in the packed shapes, the same bits from
    run to run: the sweep, split-K weight-gradient and fixed-order reduce
    kernels (`Bf16Backward`, `F32Backward`; the gradients are views of the
    reduce's output)."""
    _check_form(compute)
    if compute == "float32":
        grads = F32Backward(packed, em, de, vpe, p3, g_e, g_out,
                            skip_pos).run()
    else:
        grads = Bf16Backward(packed, em, de, vpe, p3, g_e, g_out, skip_pos,
                             slabs).run()
    radiance_backward.launches[compute] += 1
    return grads


radiance_backward.launches = dict.fromkeys(FORMS, 0)


def reset_launches() -> None:
    """Set both kernels' counts of both forms, the per-kernel counts of
    both forms and the slot sum's count to 0."""
    for fn in (radiance_forward, radiance_backward):
        fn.launches = dict.fromkeys(FORMS, 0)
    f32_launches.update(dict.fromkeys(F32_KERNELS, 0))
    bf16_launches.update(dict.fromkeys(BF16_KERNELS, 0))
    slot_sum.launches = 0


class _RadianceOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, skip_pos, compute, em, de, vpe, p3, *weights):
        packed = dict(zip(PACK_ORDER, weights))
        ctx.slabs = None
        if route(em) == "cpu":
            out, g_e = radiance_forward_plain(packed, em, de, vpe, p3,
                                              skip_pos, compute)
        else:
            if compute == "bfloat16":
                ctx.slabs = bf16_slabs(packed)   # packed once for both
            out, g_e = radiance_forward(packed, em, de, vpe, p3, skip_pos,
                                        compute, ctx.slabs)
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
                                  ctx.skip_pos, ctx.compute, ctx.slabs)
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
