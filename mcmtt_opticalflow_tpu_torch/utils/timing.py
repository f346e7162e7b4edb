"""Per-stage wall-clock timing (carried from mcmtt_opticalflow_tpu)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List


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
