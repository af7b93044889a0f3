"""ctypes bindings for the native image-decoding core (csrc/imageio.cpp).

Copy of implicit_depth_tpu/utils/native_io.py (the port imports nothing of
the JAX package). It builds the same repository-root csrc/imageio.cpp.

The C calls release the GIL, so BatchLoader's thread pool decodes in
parallel at native speed — the TPU-side equivalent of torch DataLoader's
worker processes. Falls back to PIL (utils.io) when the library can't be
built.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libimageio.so")
_lib = None
_UNAVAILABLE = object()


def _load():
    global _lib
    if _lib is not None:
        return None if _lib is _UNAVAILABLE else _lib
    src = os.path.join(_CSRC, "imageio.cpp")
    try:
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src):
            subprocess.check_call(
                ["g++", "-O3", "-shared", "-fPIC", src, "-o", _LIB_PATH,
                 "-lpng", "-ljpeg", "-lz"]
            )
        lib = ctypes.CDLL(_LIB_PATH)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.decode_depth_png.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, f32p,
        ]
        lib.decode_depth_png.restype = ctypes.c_int
        lib.decode_color_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, f32p,
        ]
        lib.decode_color_jpeg.restype = ctypes.c_int
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = _UNAVAILABLE
        return None
    return _lib


def available() -> bool:
    return _load() is not None


def decode_depth_png(path: str, out_h: int, out_w: int, scale: float = 1e-3,
                     min_valid: float = 1e-3, max_valid: float = 10.0) -> Optional[np.ndarray]:
    """16-bit depth PNG -> (h, w) float32 metres with NaN invalids;
    nearest resize. None on failure (caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w), np.float32)
    rc = lib.decode_depth_png(path.encode(), out_h, out_w, scale,
                              min_valid, max_valid, out)
    return out if rc == 0 else None


def decode_color_jpeg(path: str, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """JPEG -> (h, w, 3) float32 in [0,1], bilinear half-pixel resize.
    None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.decode_color_jpeg(path.encode(), out_h, out_w, out)
    return out if rc == 0 else None
