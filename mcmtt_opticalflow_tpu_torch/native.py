"""ctypes binding for the native host runtime's gray conversion.

Builds and loads the same library as the JAX package (native/
mcmtt_native.cpp with native/Makefile, at the repository root); no C++
is copied here.  The engine uses `rgb_to_gray_u8` and falls back to the
numpy formula, which gives the same bytes, when no toolchain is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmcmtt_native.so")


class _Lib:
    """The loaded library (one per process)."""
    handle: Optional[ctypes.CDLL] = None
    tried = False


def _load() -> Optional[ctypes.CDLL]:
    if _Lib.handle is not None or _Lib.tried:
        return _Lib.handle
    _Lib.tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.rgb_to_gray_u8.restype = None
    lib.rgb_to_gray_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8)]
    _Lib.handle = lib
    return lib


def available() -> bool:
    return _load() is not None


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB -> [...] uint8 gray, (r+g+b)//3."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.shape[-1] != 3:
        raise ValueError(f"expected [..., 3] RGB, got {rgb.shape}")
    gray = np.empty(rgb.shape[:-1], np.uint8)
    lib.rgb_to_gray_u8(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_longlong(gray.size),
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return gray
