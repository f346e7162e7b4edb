"""The device trace of a steady slice of the window, and its arithmetic.

`Profile` runs torch.profiler (CPU and CUDA activity) over the frames it
is started and stopped around, writes the Chrome trace into a temporary
directory under TMPDIR, reads it back and deletes it.  The arithmetic is
a frozen copy of mcmtt_opticalflow_tpu_torch/utils/timing.py::
summarize_trace at commit 052b569610a6: the window runs from the first to
the last event of any kind, and the device is busy in the union of the
kernel, memcpy and memset intervals.  Beside it: each kernel's time and
count, and the idle time between device intervals split by the
innermost of the benchmark's own `record_function` ranges open over it.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_RANGE = "user_annotation"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], top: int = 10) -> dict:
    """Busy and window seconds, kernel seconds and counts by name, and idle
    gaps by host range, from Chrome-trace complete events (µs)."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError("no complete events in the trace")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in DEVICE_CATEGORIES])
    busy = sum(b - a for a, b in dev)
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("cat") == "kernel":
            kernel_s[e["name"]] += float(e["dur"]) / 1e6
            kernel_n[e["name"]] += 1
    gaps = idle_gaps(events, dev, t0, t1)
    by_label: Dict[str, float] = defaultdict(float)
    for label, sec in gaps:
        by_label[label] += sec
    cats: Dict[str, int] = defaultdict(int)
    for e in events:
        cats[e.get("cat", "")] += 1
    return {
        "events": dict(cats),
        "busy_s": busy / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "kernel_s": dict(kernel_s),
        "kernel_n": dict(kernel_n),
        "device_ops": sorted(([n, s] for n, s in kernel_s.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in by_label.items()),
                            key=lambda x: -x[1])[:top],
    }


def idle_gaps(events, dev, t0, t1):
    """(label, seconds) pieces of the gaps between device intervals in
    [t0, t1], each piece labelled by the innermost of the benchmark's host
    ranges open over it (the latest-started range that contains it), or
    "outside" where none is: what the host was doing while the card
    idled."""
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events if e.get("cat") == HOST_RANGE)
    cuts = sorted({t0, t1, *[x for r in ranges for x in r[:2]
                             if t0 < x < t1]})
    labels = []
    for a, b in zip(cuts, cuts[1:]):
        mid, inner = (a + b) / 2, "outside"
        for s, e, name in ranges:
            if s > mid:
                break
            if e > mid:
                inner = name
        labels.append((a, b, inner))
    edges = [t0] + [x for ab in dev for x in ab] + [t1]
    out, i = [], 0
    for a, b in zip(edges[0::2], edges[1::2]):
        while i < len(labels) and labels[i][1] <= a:
            i += 1
        j = i
        while j < len(labels) and labels[j][0] < b:
            lo, hi = max(a, labels[j][0]), min(b, labels[j][1])
            if hi > lo:
                out.append((labels[j][2], (hi - lo) / 1e6))
            j += 1
    return out


def warm_up() -> None:
    """Start and stop the profiler once on a small op, so that its first
    start (CUPTI's set-up, seconds on a card) falls in the run's set-up and
    not in the traced slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):
        x = torch.ones(8, device="cuda" if cuda else "cpu") + 1
        if cuda:
            torch.cuda.synchronize()
    del x


class Profile:
    """torch.profiler over a slice of the window; `summary` after stop()."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._dir = tempfile.mkdtemp(prefix="bench_trace_")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.summary = None

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self) -> None:
        """End the collection (the trace is read by `finish`)."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def finish(self) -> None:
        """Write the trace, read it into `summary`, delete it."""
        path = os.path.join(self._dir, "trace.json")
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.summary = summarize(json.load(f)["traceEvents"])
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)
