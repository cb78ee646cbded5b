"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``.  Nothing is
compiled at import: the CPU tests import every module of the package.

The library lands in ``pertrenderer_tpu_torch/_build/`` under a name keyed
on the sources and flags, so an edited source is never served a stale
binary.  ``-fmad=false`` and the absence of fast math keep the kernels'
rounding in the order of the plain PyTorch versions (see
csrc/fused_forward.cu).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("prng_probe.cu", "fused_forward.cu")
HEADERS = ("hash_prng.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the kernels")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _compile(target: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr            # ptxas resource use (-v)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, target)     # atomic: a concurrent loader sees all or none


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    target = os.path.join(BUILD_DIR, f"libpertrenderer_kernels_{_digest()}.so")
    if not os.path.exists(target):
        _compile(target)
    lib = ctypes.CDLL(target)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pt_prng_probe.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
    lib.pt_prng_probe.restype = i32
    lib.pt_fused_forward.argtypes = ([ptr] * 8 + [i32] * 13
                                     + [ctypes.c_float] + [i32] * 4 + [ptr])
    lib.pt_fused_forward.restype = i32
    lib.pt_error_string.argtypes = [i32]
    lib.pt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = library().pt_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({msg})")
