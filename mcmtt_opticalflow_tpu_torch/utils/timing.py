"""Per-stage wall-clock timing (StageTimer, carried from
mcmtt_opticalflow_tpu) and device tracing with torch.profiler.

`profile_trace(logdir)` takes the place of the JAX package's
jax.profiler trace: a Chrome trace (`trace.json`) of the host and, with a
card, of every kernel the card ran, whoever launched it (CUPTI sees the
ctypes-launched LK kernels too).  `summarize_trace` reads one back: the
device's busy share over the traced window, its total time, and the
kernels by time and by count.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Tuple


class StageTimer:
    """Accumulates wall time per named stage across frames."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.samples[name].append(dt)

    def push(self, name: str) -> None:
        """Open a stage without lexical scoping (close with pop())."""
        if not hasattr(self, "_open"):
            self._open: List = []
        self._open.append((name, time.perf_counter()))

    def pop(self) -> None:
        name, t0 = self._open.pop()
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.samples[name].append(dt)

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            tot = self.totals[name]
            med = sorted(self.samples[name])[n // 2] if n else 0.0
            lines.append(f"{name:30s} total={tot:8.3f}s "
                         f"mean={tot / max(n, 1) * 1e3:8.2f}ms "
                         f"med={med * 1e3:8.2f}ms n={n}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.samples.clear()


TRACE_FILE = "trace.json"
# Chrome-trace categories torch.profiler gives the card's own activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the enclosed code with torch.profiler: CPU activity always,
    CUDA activity when a card is present.  On exit the card is
    synchronised (so no launched kernel is left out) and the Chrome trace
    is written to `logdir`/trace.json.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class TraceSummary(NamedTuple):
    busy_share: float                 # device-busy time / traced window
    device_ms: float                  # union of device activity, ms
    top_kernels: List[Tuple[str, float, int]]   # (name, ms, count), by ms
    kernel_counts: Dict[str, int]     # kernel name -> events


def summarize_trace(path: str, top: int = 5) -> TraceSummary:
    """Read a Chrome trace written by `profile_trace` (a file, or the
    logdir holding trace.json).  The window runs from the first to the
    last event of any kind; device activity is the kernel, memcpy and
    memset events, merged where they overlap.  Without device events
    (no card) the busy share and device time are 0."""
    if os.path.isdir(path):
        path = os.path.join(path, TRACE_FILE)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events in the trace")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in DEVICE_CATEGORIES)
    busy, end = 0.0, -float("inf")
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    ms: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("cat") == "kernel":
            ms[e["name"]] += float(e["dur"]) / 1e3
            counts[e["name"]] += 1
    ranked = sorted(ms, key=lambda n: -ms[n])[:top]
    return TraceSummary(
        busy_share=busy / (t1 - t0) if t1 > t0 else 0.0,
        device_ms=busy / 1e3,
        top_kernels=[(n, ms[n], counts[n]) for n in ranked],
        kernel_counts=dict(counts))
