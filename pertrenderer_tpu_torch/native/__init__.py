"""ctypes binding of the native OBJ parser (``objparse.cpp``).

The shared library is built with ``g++ -O3 -shared -fPIC -std=c++17`` at
first use into ``pertrenderer_tpu_torch/_build/`` under a name keyed on
the source's hash (as ``_build.py`` keys the kernel library), never next
to the source.  A failed build or load raises: ``io.load_obj`` reaches the
pure-Python scanner only when the caller asks for it (``use_native=False``).
The C ABI is ``obj_parse(path) -> ObjData*`` and ``obj_free(ObjData*)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["COMPILER", "library", "parse_obj_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "objparse.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


class _ObjData(ctypes.Structure):
    _fields_ = [
        ("verts", ctypes.POINTER(ctypes.c_float)),
        ("n_verts", ctypes.c_long),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("n_uvs", ctypes.c_long),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("n_normals", ctypes.c_long),
        ("faces_v", ctypes.POINTER(ctypes.c_int)),
        ("faces_t", ctypes.POINTER(ctypes.c_int)),
        ("faces_n", ctypes.POINTER(ctypes.c_int)),
        ("n_faces", ctypes.c_long),
        ("mtl", ctypes.c_char * 1024),
    ]


def _target() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libobjparse_{h.hexdigest()[:16]}.so")


def _compile(target: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [COMPILER, *FLAGS, SOURCE, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot build the native OBJ parser: "
                           f"{' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"the native OBJ parser failed to build: "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)   # atomic: a concurrent loader sees all of it


def library() -> ctypes.CDLL:
    """The loaded parser library, building it first if needed; raises if
    the build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not os.path.exists(target):
                _compile(target)
            lib = ctypes.CDLL(target)
            lib.obj_parse.restype = ctypes.POINTER(_ObjData)
            lib.obj_parse.argtypes = [ctypes.c_char_p]
            lib.obj_free.argtypes = [ctypes.POINTER(_ObjData)]
            _lib = lib
        return _lib


def parse_obj_native(path: str) -> dict:
    """Parse an OBJ with the C++ parser: a dict of numpy arrays {verts
    (V, 3), uvs (Vt, 2) or None, normals (Vn, 3) or None, faces_v / faces_t
    / faces_n (F, 3) int32 (-1 where absent), mtl (name or None)}.  Raises
    FileNotFoundError if the file cannot be read."""
    lib = library()
    ptr = lib.obj_parse(os.fsencode(path))
    if not ptr:
        raise FileNotFoundError(path)
    d = ptr.contents
    try:
        def _np(p, n, w, dtype):
            if n == 0:
                return np.zeros((0, w), dtype)
            return np.ctypeslib.as_array(p, shape=(n, w)).astype(dtype,
                                                                 copy=True)

        return {
            "verts": _np(d.verts, d.n_verts, 3, np.float32),
            "uvs": _np(d.uvs, d.n_uvs, 2, np.float32) if d.n_uvs else None,
            "normals": (_np(d.normals, d.n_normals, 3, np.float32)
                        if d.n_normals else None),
            "faces_v": _np(d.faces_v, d.n_faces, 3, np.int32),
            "faces_t": _np(d.faces_t, d.n_faces, 3, np.int32),
            "faces_n": _np(d.faces_n, d.n_faces, 3, np.int32),
            "mtl": d.mtl.decode() or None,
        }
    finally:
        lib.obj_free(ptr)
