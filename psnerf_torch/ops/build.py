"""Builds the CUDA sources under ops/csrc into shared libraries on first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc for
sm_90a into `ops/_build/lib<name>-<hash>.so`, where <hash> is the source's
content hash, so an edited source never loads a stale library. The build
uses no PyTorch headers (seconds, not minutes), and a failed build raises
with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _build(name: str) -> None:
    """Compile csrc/<name>.cu unless its library is already built."""
    so = library_path(name)
    if so.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{proc.stdout}")
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(proc.stdout)
    os.replace(tmp, so)


def load_library(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        _build(name)
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
