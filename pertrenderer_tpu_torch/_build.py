"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per source, all started together, then one link.  Nothing is
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
SOURCES = ("prng_probe.cu", "fused_forward.cu", "fused_backward.cu",
           "fused_loss_grad.cu", "fused_binned.cu", "stream_forward.cu",
           "stream_backward.cu", "stream_loss_grad.cu", "gather.cu",
           "interp_gather.cu", "perturbed.cu", "sharded.cu")
HEADERS = ("hash_prng.cuh", "fused_common.cuh", "fused_grad.cuh", "warp.cuh",
           "binned_warp.cuh", "stream_grad.cuh", "stream_warp.cuh",
           "segment_sum.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v")

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
    tag = f"{target}.{os.getpid()}"
    objs = [f"{tag}.{i}.o" for i in range(len(SOURCES))]
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)]
            for src, obj in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [pr.communicate()[0] for pr in procs]
    link = [nvcc, *ARCH, "-shared", "-o", f"{tag}.tmp", *objs]
    failed = [c for c, pr in zip(cmds, procs) if pr.returncode != 0]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(link)
    build_seconds = time.perf_counter() - t0
    log = "\n".join(" ".join(c) + "\n" + out          # ptxas resource use
                    for c, out in zip(cmds + [link], logs))
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(log)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n{log}")
    os.replace(f"{tag}.tmp", target)   # atomic: a concurrent loader sees all


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
    # n and the static configuration (fused_render._cfg_args), then the
    # activity bits and the tiling (nt, p_tile, tile_w).
    config = [i32] * 16 + [ctypes.c_float] + [i32] * 4
    tiling = [ptr] + [i32] * 3
    # The binned route's K12 takes the flat kernels' arguments over
    # per-tile tables (its scalar rows in the partial buffer's place).
    for fn in (lib.pt_fused_forward, lib.pt_binned_forward):
        fn.argtypes = [ptr] * 8 + config + tiling + [ptr]
        fn.restype = i32
    # The sharded route (K3 with external coverage, K11a-c): their tensors,
    # then the flat kernels' configuration and tiling.
    lib.pt_fused_forward_ext.argtypes = [ptr] * 10 + config + tiling + [ptr]
    lib.pt_sharded_prob.argtypes = [ptr] * 5 + config + tiling + [ptr]
    lib.pt_sharded_agg_bwd.argtypes = ([ptr] * 11 + [i32, ptr] + config
                                       + tiling + [ptr])
    lib.pt_sharded_det_bwd.argtypes = ([ptr] * 12 + [i32] + [ptr] * 6
                                       + config + tiling + [ptr])
    for fn in (lib.pt_fused_forward_ext, lib.pt_sharded_prob,
               lib.pt_sharded_agg_bwd, lib.pt_sharded_det_bwd):
        fn.restype = i32
    grads = ([ptr] * 9 + [i32] + [ptr] * 6 + config
             + [i32, ctypes.c_float] + tiling + [ptr])
    for fn in (lib.pt_fused_backward, lib.pt_fused_loss_grad,
               lib.pt_binned_backward, lib.pt_binned_loss_grad):
        fn.argtypes = grads
        fn.restype = i32
    # The stream kernels: tables, n, the stream geometry (nt, nch, p_tile,
    # tile_w, rw, dt; fused_render._stream_args) and the configuration
    # (`config` counts n among its leading ints).
    geometry = [i32] * 6
    lib.pt_stream_forward.argtypes = [ptr] * 7 + geometry + config + [ptr]
    lib.pt_stream_forward.restype = i32
    for fn in (lib.pt_stream_backward, lib.pt_stream_loss_grad):
        fn.argtypes = ([ptr] * 17 + geometry + config
                       + [i32, ctypes.c_float, ptr])
        fn.restype = i32
    # The gradient kernels' shapes: dt, tex_d, agg_kind, s_agg, int[7] out.
    for fn in (lib.pt_stream_backward_occupancy,
               lib.pt_stream_loss_grad_occupancy):
        fn.argtypes = [i32] * 4 + [ptr]
        fn.restype = i32
    # The gathers (ops/gather.py, ops/interp_gather.py): pointers, then the
    # column count P (64-bit), the row count F and the width D.
    i64 = ctypes.c_longlong
    lib.pt_gather_rows.argtypes = [ptr] * 3 + [i64, i32, i32, ptr]
    # The segment sums (K9b, K10b's tables): the index preparation's
    # idx, P, F and workspace; the sums' tensors, P, F, D and the chunk
    # count.
    lib.pt_segment_prep.argtypes = [ptr, i64, i32] + [ptr] * 11
    lib.pt_scatter_rows.argtypes = [ptr] * 7 + [i64, i32, i32, i64, ptr]
    lib.pt_interp_rows.argtypes = [ptr] * 6 + [i64, i32, i32, ptr]
    lib.pt_interp_rows_bwd_tables.argtypes = [ptr] * 10 + [i64, i32, i32,
                                                           i64, ptr]
    lib.pt_interp_rows_bwd_weights.argtypes = [ptr] * 4 + [i64, i32, i32,
                                                           ptr]
    for fn in (lib.pt_gather_rows, lib.pt_segment_prep, lib.pt_scatter_rows,
               lib.pt_interp_rows, lib.pt_interp_rows_bwd_tables,
               lib.pt_interp_rows_bwd_weights):
        fn.restype = i32
    # The staged estimators (ops/perturbed_kernels.py): pointers, then the
    # shape (N or the element count, P, C) and the sampling configuration.
    lib.pt_heaviside.argtypes = [ptr] * 4 + [i32, i64, i64] + [i32] * 4 + [
        ptr]
    lib.pt_argmax_mean.argtypes = [ptr] * 4 + [i32, i64] + [i32] * 3 + [ptr]
    lib.pt_argmax_grads.argtypes = [ptr] * 6 + [i32, i64] + [i32] * 4 + [ptr]
    for fn in (lib.pt_heaviside, lib.pt_argmax_mean, lib.pt_argmax_grads):
        fn.restype = i32
    lib.pt_grad_partial_warps.argtypes = [i32] * 4
    lib.pt_grad_partial_warps.restype = i32
    lib.pt_grad_partial_width.argtypes = [i32] * 2
    lib.pt_grad_partial_width.restype = i32
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
