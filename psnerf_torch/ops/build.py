"""Builds the CUDA sources under ops/csrc into shared libraries on first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc for
sm_90a into `ops/_build/lib<name>-<hash>.so`, where <hash> covers the
source and the shared headers (`csrc/*.cuh`), so an edited source never
loads a stale library. The first `load_library` call starts one nvcc per
source, all at once, and waits for them; the builds use no PyTorch headers
(seconds, not minutes), and a failed build raises with nvcc's output.

It also holds what every kernel wrapper shares at the ctypes boundary:
device routing, the operand checks made before each launch, the launch
of an entry that takes (pointers, ints, stream) (`launch`), and the k-step
slab layout in which the trunk kernels (csrc/trunk_wgmma.cuh) stream their
weights.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of psnerf_torch.ops "
                       "need the CUDA toolkit to build")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, one nvcc process per
    source, concurrently. Returns {name: seconds} of the builds it ran."""
    import time

    todo = [n for n in sources() if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    times, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            if tmp.exists():
                tmp.unlink()
            failed.append(f"nvcc failed to build {name}.cu:\n{out}")
            continue
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(out)
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load_library(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building every missing library
    first."""
    lib = _LOADED.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all()
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pack_slabs(mats) -> torch.Tensor:
    """Weights [W, K] (out, in) as one flat run of k-step slabs, in the
    given order: slab ks of a matrix holds w[n][16 ks + k] at element
    (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8, wgmma's K-major
    core-matrix layout without swizzle (8 rows x 16 bytes per core
    matrix). K is a multiple of 16, W of 8."""
    runs = []
    for w in mats:
        n, k = w.shape
        runs.append(w.reshape(n // 8, 8, k // 16, 2, 8)
                    .permute(2, 0, 3, 1, 4).reshape(-1))
    return torch.cat(runs).contiguous()


def unpack_slabs(slabs: torch.Tensor, width: int, depths) -> list:
    """The matrices [width, K] of a pack_slabs run, K from `depths`."""
    out, at = [], 0
    for k in depths:
        size = width * k
        out.append(slabs[at:at + size].reshape(k // 16, width // 8, 2, 8, 8)
                   .permute(1, 3, 0, 2, 4).reshape(width, k))
        at += size
    if at != slabs.numel():
        raise ValueError(f"{slabs.numel()} slab elements, {at} unpacked")
    return out


def launch(fn, error, dev, tensors, ints, what: str) -> None:
    """Launch a C entry `fn(ptrs, ints, stream)` with the tensors' device
    pointers and the ints on the current stream of `dev`, entering that
    device only when it is not the current one; raises with `error(rc)`'s
    text if the entry returns non-zero (a cudaError_t)."""
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    args = (ctypes.c_int * len(ints))(*ints)
    if torch.cuda.current_device() == dev.index:
        rc = fn(ptrs, args, torch.cuda.current_stream(dev.index).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(ptrs, args,
                    torch.cuda.current_stream(dev.index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + error(rc).decode())


def route(t: torch.Tensor) -> str:
    """"cpu" (the plain version runs) or "cuda" (the kernel launches)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def check_operand(name, t, dtype, shape, device):
    """Raise unless t is what a kernel takes: on `device`, of `dtype` and
    `shape`, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
