"""Fused occupancy-logit MLP (counterpart of psnerf_tpu/ops/fused_occ.py),
as a hand-written CUDA kernel for Hopper (csrc/fused_occ.cu).

Stage-1's no-grad occupancy queries (the root-finding march of every train
step: 2048 rays x 256 proposal points, then 8 secant passes) are forward
passes of the 8x256 weight-normed geometry MLP that need only the logit.
The operands are packed as the TPU kernel packs them:

  * weight norm folded into dense weights (under no_grad: the call sites
    are no-grad regions);
  * the skip concat `cat([x, pe]) / sqrt(2)` folded into a row split of
    the skip layer (x rows into the trunk, PE rows into `wskip`), with the
    1/sqrt(2) baked in;
  * bf16 weights and point embedding, f32 accumulation and biases;
    softplus(beta=100) with the linear cutover at 100 x > 20 in f32; the
    logit row w8 is bf16-rounded and dotted in f32 with the f32 activations.

On a CPU tensor `fused_occ_logit` runs its plain PyTorch version, which
repeats the packing and the rounding points in f32 arithmetic. On a CUDA
tensor it launches the kernel or raises; it never falls back. It counts its
launches in `fused_occ_logit.launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from psnerf_torch.core.encoding import nerf_embed
from psnerf_torch.fields.mlp import wn_weight
from psnerf_torch.ops.build import (check_operand, launch, load_library,
                                    pack_slabs, round_up, route)

KERNEL_WIDTHS = (128, 256)
_lib_handle = []


def fold_geometry(field, cfg, wdt) -> dict:
    """Differentiable fold of the weight-normed geometry MLP into dense
    operands in JAX's weight layout [din, dout], the products' operands in
    `wdt`, biases and the output layer f32:
      w0 [ke, W], b0 [W], wskip [ke, W] (the skip layer's PE rows / sqrt 2),
      trunk_w [n_trunk, W, W] (its x rows / sqrt 2), trunk_b [n_trunk, W],
      w_out [W, 1 + feat], b_out [1 + feat] (logit first).
    The embedding width E is zero-padded to ke, a multiple of 16."""
    width, e = cfg.hidden_dim, cfg.dim_embed
    if len(cfg.skips) != 1 or not 1 <= cfg.skips[0] <= cfg.num_layers - 1:
        raise ValueError("the fused kernels need exactly one skip layer "
                         "inside the trunk")
    ke, skip = round_up(e, 16), cfg.skips[0]
    pad = torch.nn.functional.pad
    dense = [(wn_weight(l), l.b) for l in field.geo]
    trunk, tb = [], []
    wskip = None
    for li in range(1, len(dense) - 1):
        w, b = dense[li]
        din = w.shape[0]
        if li == skip:
            w = w * (1.0 / math.sqrt(2.0))
            wskip = pad(w[din - e:], (0, 0, 0, ke - e)).to(wdt)
            w = w[: din - e]
        trunk.append(pad(w, (0, width - w.shape[1], 0, width - w.shape[0]))
                     .to(wdt))
        tb.append(pad(b, (0, width - b.shape[0])))
    return dict(w0=pad(dense[0][0], (0, 0, 0, ke - e)).to(wdt),
                b0=dense[0][1], wskip=wskip, trunk_w=torch.stack(trunk),
                trunk_b=torch.stack(tb), w_out=dense[-1][0],
                b_out=dense[-1][1])


@torch.no_grad()
def pack_occ_operands(field, cfg) -> dict:
    """Dense bf16/f32 operands of the geometry trunk (logit head only), each
    product's weight as [out, in]."""
    g = fold_geometry(field, cfg, torch.bfloat16)
    c = lambda t: t.contiguous()
    return dict(
        width=cfg.hidden_dim, e=cfg.dim_embed, ke=g["w0"].shape[0],
        n_pre=cfg.skips[0] - 1, octaves=cfg.octaves_pe, rescale=cfg.rescale,
        w0T=c(g["w0"].T), b0=c(g["b0"].float()), wskipT=c(g["wskip"].T),
        trunk_wT=c(g["trunk_w"].transpose(1, 2)),
        trunk_b=c(g["trunk_b"].float()),
        w8=c(g["w_out"][:, 0].to(torch.bfloat16).float()),
        b8=c(g["b_out"][0:1].float()))


def occ_slabs(ops: dict) -> torch.Tensor:
    """The kernel's packing of the products' weights: k-step slabs
    (build.pack_slabs) in the order the kernel reads them: w0, trunk 0 ..
    n_pre, wskip, the rest of the trunk."""
    trunk, k = list(ops["trunk_wT"]), ops["n_pre"] + 1
    return pack_slabs([ops["w0T"], *trunk[:k], ops["wskipT"], *trunk[k:]])


def occ_embed(p: torch.Tensor, ops: dict) -> torch.Tensor:
    """Point embedding [N, ke] in bf16, zero-padded past E."""
    emb = nerf_embed(p / ops["rescale"], ops["octaves"])
    return torch.nn.functional.pad(emb, (0, ops["ke"] - ops["e"])).to(
        torch.bfloat16).contiguous()


def _sp100(x: torch.Tensor) -> torch.Tensor:
    bx = 100.0 * x
    return torch.where(bx > 20.0, x, torch.nn.functional.softplus(bx) / 100.0)


def _logit_plain(ops: dict, em: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in f32 on bf16-rounded operands."""
    em = em.float()
    y = _sp100(em @ ops["w0T"].float().T + ops["b0"])
    b_pe = em @ ops["wskipT"].float().T
    for i, wT in enumerate(ops["trunk_wT"]):
        h = y.to(torch.bfloat16).float() @ wT.float().T + ops["trunk_b"][i]
        if i == ops["n_pre"]:
            h = h + b_pe
        y = _sp100(h)
    return torch.sum(y * ops["w8"], dim=-1) + ops["b8"]


@torch.no_grad()
def fused_occ_logit_plain(field, p: torch.Tensor, cfg) -> torch.Tensor:
    ops = pack_occ_operands(field, cfg)
    return _logit_plain(ops, occ_embed(p, ops))


# ----------------------------------------------------------------- kernel

def _lib():
    if not _lib_handle:
        lib = load_library("fused_occ")
        lib.psnerf_fused_occ.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        lib.psnerf_fused_occ.restype = ctypes.c_int
        lib.psnerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.psnerf_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle.append(lib)
    return _lib_handle[0]


def _launch(ops: dict, em: torch.Tensor, out: torch.Tensor) -> None:
    dev = em.device
    if dev.type != "cuda":
        raise ValueError(f"the fused_occ kernel needs CUDA tensors, got {dev}")
    w, ke, n = ops["width"], ops["ke"], em.shape[0]
    if w not in KERNEL_WIDTHS:
        raise ValueError(f"the fused_occ kernel takes widths {KERNEL_WIDTHS}, "
                         f"got {w}")
    if ke > 64:
        raise ValueError(f"the fused_occ kernel takes embeddings up to 64 "
                         f"wide, got {ops['e']}")
    nt = ops["trunk_wT"].shape[0]
    if "slabs" not in ops:                 # once per packing
        ops["slabs"] = occ_slabs(ops)
    bf, f32 = torch.bfloat16, torch.float32
    names = ("em", "slabs", "b0", "trunk_b", "w8", "b8", "out")
    tensors = dict(ops, em=em, out=out)
    for name, dtype, shape in (
            ("em", bf, (n, ke)), ("slabs", bf, (w * (2 * ke + nt * w),)),
            ("b0", f32, (w,)), ("trunk_b", f32, (nt, w)), ("w8", f32, (w,)),
            ("b8", f32, (1,)), ("out", f32, (n,))):
        check_operand(name, tensors[name], dtype, shape, dev)
    lib = _lib()
    launch(lib.psnerf_fused_occ, lib.psnerf_cuda_error_string, dev,
           [tensors[k] for k in names], [n, w, ke, nt, ops["n_pre"]],
           "fused_occ")


def _logit(ops: dict, p: torch.Tensor) -> torch.Tensor:
    if route(p) == "cpu":
        return _logit_plain(ops, occ_embed(p, ops))
    em = occ_embed(p.reshape(-1, 3).float(), ops)
    out = torch.empty((em.shape[0],), dtype=torch.float32, device=p.device)
    _launch(ops, em, out)
    fused_occ_logit.launches += 1
    return out


@torch.no_grad()
def fused_occ_logit(field, p: torch.Tensor, cfg) -> torch.Tensor:
    """Raw occupancy logits [N] (inside-negative, as occ_logit) of points
    [N, 3]; any N (the kernel masks the ragged edge)."""
    return _logit(pack_occ_operands(field, cfg), p)


fused_occ_logit.launches = 0


def make_fused_occ_fn(field, cfg, output: str = "alpha"):
    """Occupancy closure p [N, 3] -> [N] over one packing of the field's
    current weights, for the no-grad march. output="alpha" gives
    sigmoid(-10 * logit); output="inside_logit" gives -logit."""
    if output not in ("alpha", "inside_logit"):
        raise ValueError(f"output must be 'alpha' or 'inside_logit', got "
                         f"{output!r}")
    ops = pack_occ_operands(field, cfg)

    @torch.no_grad()
    def occ_fn(p):
        logit = _logit(ops, p)
        return -logit if output == "inside_logit" else torch.sigmoid(
            -10.0 * logit)

    return occ_fn
