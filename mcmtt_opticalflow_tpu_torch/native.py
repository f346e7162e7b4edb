"""ctypes bindings for the native host runtime.

Builds and loads its own copy of the JAX package's library: the same
source (native/mcmtt_native.cpp, at the repository root) by the same
native/Makefile, into ``_build/`` beside this package (named by the
source's hash; see .gitignore), under a file lock, and moved into place
only when whole.  So it never writes native/libmcmtt_native.so, and
processes that load it at once never see a half-written file; no C++ is
copied here.  Every binding has the JAX package's signature and
return types, and raises RuntimeError when the library is unavailable
(no toolchain): callers check `available()` first.  The engine uses
`rgb_to_gray_u8` and falls back to the numpy formula, which gives the
same bytes, when there is no library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "mcmtt_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build")

_F64 = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int)


class _Lib:
    """The loaded library (one per process)."""
    handle: Optional[ctypes.CDLL] = None
    tried = False


def _load() -> Optional[ctypes.CDLL]:
    if _Lib.handle is not None or _Lib.tried:
        return _Lib.handle
    _Lib.tried = True
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError):
        return None
    lib.lap_solve.restype = ctypes.c_double
    lib.lap_solve.argtypes = [_F64, ctypes.c_int, ctypes.c_int, _I32]
    lib.bls_mwcp_solve.restype = ctypes.c_double
    lib.bls_mwcp_solve.argtypes = [
        _F64, _U8, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, _U8,
        ctypes.c_int, _U8, _F64, _I32]
    lib.parse_detections.restype = ctypes.c_int
    lib.parse_detections.argtypes = [ctypes.c_char_p, _F64, ctypes.c_int]
    lib.rgb_to_gray_u8.restype = None
    lib.rgb_to_gray_u8.argtypes = [_U8, ctypes.c_longlong, _U8]
    _Lib.handle = lib
    return lib


def build() -> str:
    """Path of the built library, building it first when missing:
    `make -C native TARGET=<temporary file>` (the command line overrides
    the Makefile's TARGET), then an atomic rename, under an exclusive
    lock on ``_build/native.lock`` so that concurrent processes build
    once.  Raises OSError or SubprocessError without a toolchain."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libmcmtt_native_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                subprocess.run(["make", "-B", "-C", _NATIVE_DIR,
                                f"TARGET={tmp}"], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return path


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def lap_solve(cost: np.ndarray) -> Tuple[np.ndarray, float]:
    """Exact min-cost assignment of a [R, C] cost matrix (inf forbids a
    pair); returns (col_of_row [-1 = none], total)."""
    lib = _lib()
    cost = np.ascontiguousarray(cost, np.float64)
    if cost.ndim != 2:
        raise ValueError(f"expected a [R, C] cost matrix, got {cost.shape}")
    r, c = cost.shape
    out = np.full(r, -1, np.int32)
    total = lib.lap_solve(cost.ctypes.data_as(_F64), r, c,
                          out.ctypes.data_as(_I32))
    return out, float(total)


def bls_mwcp_solve(weights: np.ndarray, adj: np.ndarray,
                   max_iterations: int = 2000, seed: int = 0,
                   max_solutions: int = 32):
    """Serial BLS max-weight clique of a graph of len(weights) vertices
    with [V, V] adjacency `adj`; returns (best_mask, best_score,
    sol_masks, sol_scores)."""
    lib = _lib()
    weights = np.ascontiguousarray(weights, np.float64)
    n = len(weights)
    adj_u8 = np.ascontiguousarray(np.asarray(adj).astype(np.uint8))
    if adj_u8.shape != (n, n):
        raise ValueError(f"adjacency {adj_u8.shape} for {n} vertices")
    mask = np.zeros(n, np.uint8)
    sol_masks = np.zeros((max_solutions, n), np.uint8)
    sol_scores = np.zeros(max_solutions, np.float64)
    nsol = ctypes.c_int(0)
    best = lib.bls_mwcp_solve(
        weights.ctypes.data_as(_F64), adj_u8.ctypes.data_as(_U8), n,
        max_iterations, seed, mask.ctypes.data_as(_U8), max_solutions,
        sol_masks.ctypes.data_as(_U8), sol_scores.ctypes.data_as(_F64),
        ctypes.byref(nsol))
    m = nsol.value
    return (mask.astype(bool), float(best),
            sol_masks[:m].astype(bool), sol_scores[:m])


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB -> [...] uint8 gray, (r+g+b)//3."""
    lib = _lib()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.shape[-1] != 3:
        raise ValueError(f"expected [..., 3] RGB, got {rgb.shape}")
    gray = np.empty(rgb.shape[:-1], np.uint8)
    lib.rgb_to_gray_u8(rgb.ctypes.data_as(_U8), ctypes.c_longlong(gray.size),
                       gray.ctypes.data_as(_U8))
    return gray


def parse_detections(text: str, max_boxes: int = 256) -> np.ndarray:
    """Parse a PETS full-body detection file's text -> [K, 4] boxes."""
    lib = _lib()
    out = np.zeros((max_boxes, 4), np.float64)
    n = lib.parse_detections(text.encode(), out.ctypes.data_as(_F64),
                             max_boxes)
    return out[:max(n, 0)].astype(np.float32)
