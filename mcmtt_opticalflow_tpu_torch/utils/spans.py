"""The port's span tree: StageTimer's per-name sums, and beside them each
span's parent, self time and frame, counters and device parts.

`Associator3D` installs a `SpanTimer` as its `timer`, so every
`stage`/`push`/`pop` of the associator and of the engine feeds the tree;
`totals`, `counts`, `samples`, `summary()` and `reset()` read as
StageTimer's.  `stage` and `push`/`pop` share one stack of open spans,
which gives each span its parent.  A span's self time is its duration
less the durations of its children.

`TrackingEngine.process_frame` opens a root span `frame` (`root`), which
enters the tree and not StageTimer's sums.  A span or counter opened
under no root (the engine's `flush` and `precompile`, an associator run
on its own) is booked apart as `outside`, so it never enters a frame's
numbers (a bucket's program made in `precompile` counts no capture of
a frame).  Each span also records the frame it worked on (`frame`, which
the engine sets: a pipelined `process_frame(t)` does frame t's 2D work
and frame t-2's association, whose phase 1 joins the solve of frame t-3
in flight: those spans carry t-2 too).  Per path ("frame/assoc.branch/
branch.enum") the tree keeps the total, self time and count; per root,
its spans in opening order, in a ring of the last `RING_FRAMES` roots.

While torch.profiler records, each span is also a `record_function`
range under its name, so the device trace holds the program's spans on
its kernels' clock; with the profiler off a span costs only the
bookkeeping.  Counters (`count`) and device parts (`part`, seconds and
count) go into the same book as the spans around them.

`current()` is the SpanTimer last reset in the process; `export()` gives
everything as a plain dict.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

from mcmtt_opticalflow_tpu_torch.utils.timing import StageTimer

ROOT = "frame"
# roots kept with their spans: a 51 s window at ~24 frames a second
RING_FRAMES = 2048

_current: Optional["SpanTimer"] = None


def current() -> Optional["SpanTimer"]:
    """The SpanTimer last reset in this process (None before any)."""
    return _current


# whether torch.profiler records in this thread: one call a span
recording = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "path", "t0", "child", "frame", "idx", "parent",
                 "rng", "stage")

    def __init__(self, name, path, frame, idx, parent, rng, stage):
        self.name, self.path, self.frame = name, path, frame
        self.idx, self.parent, self.rng, self.stage = idx, parent, rng, stage
        self.child = 0.0
        self.t0 = time.perf_counter()


class _Book:
    """Per-path [total_s, self_s, count], counters, and device parts
    [seconds, count] of one scope (under frame roots, or outside)."""

    def __init__(self):
        self.paths: Dict[str, List] = {}
        self.counters: Dict[str, float] = defaultdict(float)
        self.parts: Dict[str, List] = {}

    def export(self) -> dict:
        return {"paths": {p: {"total_s": a[0], "self_s": a[1],
                              "count": a[2]}
                          for p, a in self.paths.items()},
                "counters": dict(self.counters),
                "parts": {n: {"seconds": a[0], "count": a[1]}
                          for n, a in self.parts.items()}}


class SpanTimer(StageTimer):
    """StageTimer with parent links, self time, frames, counters and
    device parts (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.frame: Optional[int] = None
        self.roots = 0
        self._stack: List[_Span] = []
        self._book = _Book()
        self._outside = _Book()
        self._ring = deque(maxlen=RING_FRAMES)
        self._record: Optional[list] = None
        self._root_t0 = 0.0

    @property
    def in_frame(self) -> bool:
        """Whether a root is open."""
        return bool(self._stack) and not self._stack[0].stage

    def _scope(self) -> _Book:
        return self._book if self.in_frame else self._outside

    def _enter(self, name: str, stage: bool = True) -> _Span:
        rng = None
        if recording():
            rng = record_function(name)
            rng.__enter__()
        parent = self._stack[-1] if self._stack else None
        idx = None
        if self._record is not None:
            idx = len(self._record)
            self._record.append(None)
        span = _Span(name, name if parent is None
                     else parent.path + "/" + name, self.frame, idx,
                     None if parent is None else parent.idx, rng, stage)
        self._stack.append(span)
        return span

    def _leave(self, span: _Span) -> None:
        while self._stack[-1] is not span:   # left open by an exception
            self._leave(self._stack[-1])
        dt = time.perf_counter() - span.t0
        book = self._outside if self._stack[0].stage else self._book
        self._stack.pop()
        if span.stage:
            self.totals[span.name] += dt
            self.counts[span.name] += 1
            self.samples[span.name].append(dt)
        own = dt - span.child
        if self._stack:
            self._stack[-1].child += dt
        agg = book.paths.get(span.path)
        if agg is None:
            agg = book.paths[span.path] = [0.0, 0.0, 0]
        agg[0] += dt
        agg[1] += own
        agg[2] += 1
        if span.idx is not None:
            root_t0 = span.t0 if span.parent is None else self._root_t0
            self._record[span.idx] = (span.name, span.parent, span.frame,
                                      span.t0 - root_t0, dt, own)
        if span.rng is not None:
            span.rng.__exit__(None, None, None)

    @contextlib.contextmanager
    def stage(self, name: str):
        span = self._enter(name)
        try:
            yield
        finally:
            self._leave(span)

    def push(self, name: str) -> None:
        self._enter(name)

    def pop(self) -> None:
        self._leave(self._stack[-1])

    @contextlib.contextmanager
    def root(self, frame: int):
        """A `frame` root for one engine call that works on `frame`."""
        self.frame = frame
        self._record = []
        span = self._enter(ROOT, stage=False)
        self._root_t0 = span.t0
        try:
            yield
        finally:
            self._leave(span)
            self._ring.append((frame, self._record[0][4], self._record))
            self._record = None
            self.frame = None
            self.roots += 1

    def count(self, name: str, n: float = 1) -> None:
        self._scope().counters[name] += n

    def part(self, name: str, seconds: float) -> None:
        """One device part's seconds (from CUDA events)."""
        agg = self._scope().parts.setdefault(name, [0.0, 0])
        agg[0] += seconds
        agg[1] += 1

    def reset(self):
        global _current
        super().reset()
        self._book = _Book()
        self._outside = _Book()
        self._ring.clear()
        self.roots = 0
        _current = self

    def export(self) -> dict:
        """`roots` (frame roots closed since the reset), the frames' book
        (`paths`, `counters`, `parts`), the `outside` book, and `frames`:
        the ring's roots, each with its spans in opening order (`parent`
        the index of the parent span, None for the root; `start_s` from
        the root's start)."""
        out = self._book.export()
        out.update(roots=self.roots, outside=self._outside.export(),
                   frames=[{"frame": f, "wall_s": wall, "spans": [
                       {"name": s[0], "parent": s[1], "frame": s[2],
                        "start_s": s[3], "dur_s": s[4], "self_s": s[5]}
                       for s in rec]} for f, wall, rec in self._ring])
        return out


def root(timer, frame: int):
    """`timer.root(frame)` for a SpanTimer; nothing for another timer."""
    if isinstance(timer, SpanTimer):
        return timer.root(frame)
    return contextlib.nullcontext()


def count(timer, name: str, n: float = 1) -> None:
    if isinstance(timer, SpanTimer):
        timer.count(name, n)


def part(timer, name: str, seconds: float) -> None:
    if isinstance(timer, SpanTimer):
        timer.part(name, seconds)

