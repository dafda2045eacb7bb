"""Build a CUDA source in ``csrc/`` into a shared library and load it.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher and compiles on
its own with ``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` (the build
directory sits inside the package and is git-ignored), loaded with ctypes.
A library is rebuilt when its source is newer.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()   # threads of a sharded decode load at once


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of acvae_tpu_torch "
                       "are built from source and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing or stale;
    returns nvcc's output (with ptxas's register report), or "" when the
    library was current.  Raises with that output if the build fails."""
    so, src = _lib_path(name), CSRC / f"{name}.cu"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, so)
    return log


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if missing or stale."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
