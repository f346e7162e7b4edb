"""Build a CUDA source of ``csrc/`` with nvcc into a shared library with a
plain C interface, loaded with ctypes (the port's route for hand-written
kernels: a few seconds of nvcc, no PyTorch headers).

The library is named by the hash of the source and the flags, so an
edited source rebuilds, and lands in ``_build/`` beside the package (see
.gitignore) through a temporary file renamed into place whole.  Nothing
is built at import: the first call that needs a kernel builds it, and
each process loads a library once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# -fmad=false: no multiply-add contraction, so the kernels round as their
# plain versions do
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built")


@functools.lru_cache(maxsize=None)
def build_library(source: str, extra: Tuple[str, ...] = ()
                  ) -> Tuple[ctypes.CDLL, float, str]:
    """Compile ``csrc/<source>`` with NVCC_FLAGS and `extra` (once per
    hash of both) and load it, once per process.  Returns (library,
    seconds taken, nvcc's output; empty when the library was already
    built)."""
    src_path = os.path.join(CSRC, source)
    flags = [*NVCC_FLAGS, *extra]
    with open(src_path, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    so_path = os.path.join(BUILD_DIR, f"{stem}_{digest[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([nvcc(), *flags, "-o", tmp, src_path],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, so_path)
    return ctypes.CDLL(so_path), time.perf_counter() - t0, log
