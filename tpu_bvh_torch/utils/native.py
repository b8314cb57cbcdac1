"""ctypes bindings to the repo's native IO runtime
(`native/libtbvh_native.so`): the port of `tpu_bvh.utils.native`.

The reference's host runtime is C++ (tinyobjloader for meshes, stb for
PNG); so is the repo's, `tbvh_load_obj` / `tbvh_write_png`, with the
pure-Python codecs of `utils/obj.py` and `utils/image.py` used when the
library is not there (`make -C native` builds it from its source). The
library is found from the repo root (the parent of this package); one
that exists but does not load on this machine (another C runtime) counts
as missing. This is a host codec: no device work depends on it.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIB_PATH = os.path.join(_ROOT, "native", "libtbvh_native.so")

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.tbvh_load_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.tbvh_load_obj.restype = ctypes.c_int
    lib.tbvh_free.argtypes = [ctypes.c_void_p]
    lib.tbvh_free.restype = None
    lib.tbvh_write_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
    ]
    lib.tbvh_write_png.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _lib() is not None


def load_obj(path: str) -> np.ndarray | None:
    """Native OBJ load -> f32[N, 3, 3], or None if the library is missing."""
    lib = _lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.tbvh_load_obj(path.encode(), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"tbvh_load_obj({path!r}) failed: rc={rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value, 3, 3)).copy()
    finally:
        lib.tbvh_free(out)
    return arr


def write_png(path: str, rgba: np.ndarray) -> bool:
    """Native PNG write of u8[H, W, 4]; returns False if the library is
    missing."""
    lib = _lib()
    if lib is None:
        return False
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, c = rgba.shape
    if c != 4:
        raise ValueError("write_png expects u8[H, W, 4]")
    rc = lib.tbvh_write_png(path.encode(), rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            w, h)
    if rc != 0:
        raise IOError(f"tbvh_write_png({path!r}) failed: rc={rc}")
    return True
