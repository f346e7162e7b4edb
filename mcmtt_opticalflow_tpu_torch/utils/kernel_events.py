"""Count the kernels the card runs, by name, while a block runs.

    with KernelEvents() as ev:
        ...                          # work on the card
    ev.count("jv_assign_kernel")     # runs of the kernels whose name holds it

The counts come from CUPTI's activity records, the records a
torch.profiler trace of the card is made of: one per kernel that ran, a
CUDA graph replay's kernels one by one.  ops/csrc/kernel_events.cpp keeps
only a count per kernel name, so a run of millions of kernels can be
counted whole, which a trace cannot hold.  This is how the port counts
what its graphs launch: a replay runs no Python, so no kernel wrapper
sees it (utils/graphs.py).

Needs a card and CUPTI (the library this process has loaded, else the
CUDA toolkit's); the counter builds with nvcc at first use, like the
kernels (ops/nvcc_build.py).  One session at a time, and not inside a
torch.profiler session: both take CUPTI's activity buffers.
"""

from __future__ import annotations

import ctypes
import glob
import os
from typing import Dict, Tuple

import torch

from mcmtt_opticalflow_tpu_torch.ops.nvcc_build import build_library

FLUSH_PERIOD_MS = 50


def _cupti() -> Tuple[str, str]:
    """(include directory, library) of CUPTI: the library this process
    has loaded (torch's), else the toolkit's; the headers beside it, else
    the toolkit's."""
    lib = None
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libcupti.so"):
                lib = path
                break
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if lib is None:
        found = sorted(glob.glob(os.path.join(cuda, "extras", "CUPTI",
                                              "lib64", "libcupti.so*"))
                       + glob.glob(os.path.join(cuda, "lib64",
                                                "libcupti.so*")))
        if not found:
            raise RuntimeError("CUPTI not found: no libcupti loaded and "
                               f"none under {cuda}")
        lib = found[0]
    for inc in (os.path.join(os.path.dirname(os.path.dirname(lib)),
                             "include"),
                os.path.join(cuda, "extras", "CUPTI", "include"),
                os.path.join(cuda, "include")):
        if os.path.exists(os.path.join(inc, "cupti.h")):
            return inc, lib
    raise RuntimeError(f"cupti.h not found beside {lib} or under {cuda}")


def build() -> ctypes.CDLL:
    """The counter's library, built at first use and loaded once, after
    CUPTI (loaded into the global scope, where its symbols resolve)."""
    inc, cupti = _cupti()
    ctypes.CDLL(cupti, mode=ctypes.RTLD_GLOBAL)
    lib, _, _ = build_library("kernel_events.cpp", ("-I", inc))
    if lib.ke_start.argtypes is None:
        lib.ke_start.restype = ctypes.c_int
        lib.ke_start.argtypes = [ctypes.c_uint]
        lib.ke_stop.restype = ctypes.c_int
        lib.ke_stop.argtypes = []
        lib.ke_dropped.restype = ctypes.c_longlong
        lib.ke_dropped.argtypes = []
        lib.ke_counts.restype = ctypes.c_char_p
        lib.ke_counts.argtypes = []
        lib.ke_error.restype = ctypes.c_char_p
        lib.ke_error.argtypes = [ctypes.c_int]
    return lib


class KernelEvents:
    """Counts, by demangled kernel name, the kernels the card runs between
    `__enter__` and `__exit__` (both synchronise the card).  `counts`
    maps each name to its runs; raises on exit when CUPTI dropped a
    record, since the counts would then fall short."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self._lib = None

    def __enter__(self) -> "KernelEvents":
        if not torch.cuda.is_available():
            raise RuntimeError("KernelEvents counts a card's kernels: no "
                               "CUDA device")
        self._lib = build()
        torch.cuda.synchronize()
        rc = self._lib.ke_start(FLUSH_PERIOD_MS)
        if rc:
            raise RuntimeError(f"CUPTI would not start: "
                               f"{self._lib.ke_error(rc).decode()}")
        return self

    def __exit__(self, exc_type, *exc) -> None:
        torch.cuda.synchronize()
        rc = self._lib.ke_stop()
        self.counts = {}
        for line in self._lib.ke_counts().decode().splitlines():
            n, name = line.split("\t", 1)
            self.counts[name] = self.counts.get(name, 0) + int(n)
        dropped = self._lib.ke_dropped()
        if exc_type is not None:
            return
        if rc:
            raise RuntimeError(f"CUPTI would not stop: "
                               f"{self._lib.ke_error(rc).decode()}")
        if dropped:
            raise RuntimeError(f"CUPTI dropped {dropped} kernel records: "
                               "the counts fall short")

    def count(self, part: str) -> int:
        """Runs of the kernels whose name contains `part`."""
        return sum(n for name, n in self.counts.items() if part in name)

    @property
    def total(self) -> int:
        return sum(self.counts.values())
