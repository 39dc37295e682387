"""ctypes bridge to the C++ BVH builder (native/bvh_builder.cpp).

The shared library is not committed: :func:`build_library` compiles it from
the committed source on first use, and again whenever the source is newer
than the library.  Callers (accel/bvh.py::build) fall back to the numpy
builder when no C++ compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SRC_PATH = os.path.join(_NATIVE_DIR, "bvh_builder.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liblt_native.so")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]

_lib = None
_lib_failed = False


def _stale(src: str, lib: str) -> bool:
    return (not os.path.exists(lib)
            or os.path.getmtime(src) > os.path.getmtime(lib))


def build_library(src: str = _SRC_PATH, lib: str = _LIB_PATH) -> str:
    """Compile ``src`` into ``lib`` unless ``lib`` is newer; returns ``lib``.

    The compiler writes a temporary file in the target directory that is
    then renamed over ``lib``, so concurrent builders (test workers) never
    load a half-written library."""
    if not _stale(src, lib):
        return lib
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found for the native BVH builder")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, src], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    try:
        build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.lt_build_bvh.restype = ctypes.c_int64
        lib.lt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # lo
            ctypes.POINTER(ctypes.c_double),  # hi
            ctypes.POINTER(ctypes.c_double),  # centroid
            ctypes.c_int64,  # t
            ctypes.c_int32,  # max_leaf
            ctypes.POINTER(ctypes.c_double),  # out_min
            ctypes.POINTER(ctypes.c_double),  # out_max
            ctypes.POINTER(ctypes.c_int32),  # out_right
            ctypes.POINTER(ctypes.c_int32),  # out_first
            ctypes.POINTER(ctypes.c_int32),  # out_count
            ctypes.POINTER(ctypes.c_int32),  # out_axis
            ctypes.POINTER(ctypes.c_int64),  # order
        ]
        _lib = lib
        return lib
    except Exception:
        _lib_failed = True
        return None


def available() -> bool:
    return _load() is not None


def build_native(verts: np.ndarray, centroid: np.ndarray, max_leaf: int):
    """Same contract as accel.bvh._build_host; returns None-equivalent by
    raising if the native library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native builder unavailable")
    t = verts.shape[0]
    lo = np.ascontiguousarray(verts.min(axis=1), np.float64)
    hi = np.ascontiguousarray(verts.max(axis=1), np.float64)
    centroid = np.ascontiguousarray(centroid, np.float64)
    cap = 2 * t
    out_min = np.empty((cap, 3), np.float64)
    out_max = np.empty((cap, 3), np.float64)
    out_right = np.empty((cap,), np.int32)
    out_first = np.empty((cap,), np.int32)
    out_count = np.empty((cap,), np.int32)
    out_axis = np.empty((cap,), np.int32)
    order = np.arange(t, dtype=np.int64)

    def p(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    m = lib.lt_build_bvh(
        p(lo, ctypes.c_double), p(hi, ctypes.c_double),
        p(centroid, ctypes.c_double), t, max_leaf,
        p(out_min, ctypes.c_double), p(out_max, ctypes.c_double),
        p(out_right, ctypes.c_int32), p(out_first, ctypes.c_int32),
        p(out_count, ctypes.c_int32), p(out_axis, ctypes.c_int32),
        p(order, ctypes.c_int64),
    )
    if m <= 0:
        raise RuntimeError(f"native builder failed: {m}")
    return (
        out_min[:m], out_max[:m], out_right[:m], out_first[:m],
        out_count[:m], out_axis[:m], order,
    )
