"""ctypes bindings to the optional native (C++) IO runtime.

The reference's only native component is the external Mitsuba renderer;
our native surface instead accelerates the host-side IO hot paths that
feed the device: binary-PLY parsing and PNG encoding (see native/pcr_native.cc).
Everything degrades gracefully to pure NumPy/Python when the shared
library has not been built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(root, "native", "libpcr_native.so"),
        os.path.join(os.path.dirname(__file__), "libpcr_native.so"),
    ):
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                lib.pcr_read_ply.restype = ctypes.c_longlong
                lib.pcr_read_ply.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.c_int,
                ]
                lib.pcr_ply_vertex_count.restype = ctypes.c_longlong
                lib.pcr_ply_vertex_count.argtypes = [ctypes.c_char_p]
                lib.pcr_write_png.restype = ctypes.c_int
                lib.pcr_write_png.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_int,
                    ctypes.c_int,
                ]
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    return _lib() is not None


def read_ply_array(path: str, positions_only: bool = False) -> np.ndarray:
    lib = _lib()
    n = lib.pcr_ply_vertex_count(path.encode())
    if n < 0:
        raise IOError(f"native PLY parse failed for {path}")
    out = np.empty((n, 6), np.float32)
    ncols = ctypes.c_int(0)
    rc = lib.pcr_read_ply(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        ctypes.byref(ncols),
        1 if positions_only else 0,
    )
    if rc < 0:
        raise IOError(f"native PLY parse failed for {path} (rc={rc})")
    # The C side packs rows contiguously at ncols stride; reinterpret the
    # flat prefix rather than slicing the (n, 6) allocation.  float32,
    # matching the pure-NumPy PLY path so downstream standardize math is
    # bit-identical either way.
    k = ncols.value
    return out.reshape(-1)[: n * k].reshape(n, k).copy()


def write_png(path: str, image_u8: np.ndarray) -> bool:
    lib = _lib()
    img = np.ascontiguousarray(image_u8, np.uint8)
    h, w = img.shape[:2]
    rc = lib.pcr_write_png(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h
    )
    return rc == 0
