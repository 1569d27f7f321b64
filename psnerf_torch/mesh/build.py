"""Builds the native mesh library (csrc/*.cpp, a plain C interface used
through ctypes) with g++ into `_build/libpsmesh.so` on first use, and again
whenever a source is newer than the library. A failed build raises with
g++'s output.

The library is written to a temporary name in `_build/` and moved into
place, so concurrent first uses never load a half-written file.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("mise.cpp", "isosurface.cpp", "proximity.cpp")
LIB = BUILD_DIR / "libpsmesh.so"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def build(force: bool = False) -> str:
    """Path of the built library, compiling it first if it is missing or
    older than a source."""
    srcs = [CSRC / s for s in SOURCES]
    if not force and LIB.exists():
        lib_mtime = LIB.stat().st_mtime
        if all(s.stat().st_mtime <= lib_mtime for s in srcs):
            return str(LIB)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, *map(str, srcs), "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {LIB.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(LIB)
