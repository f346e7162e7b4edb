"""The end-to-end arithmetic of a closed-loop window.

The window is a run of `process_frame` calls, one after another: frame set
t is due as soon as call t-1 returns.  `walls` holds each call's wall
seconds and `window_s` the seconds from the window's start to the return
of its last call.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def frames_per_s(walls: Sequence[float], window_s: float) -> float:
    """Frame sets whose call returned inside the window, over the window's
    seconds: all the work over all the time, so a stall counts."""
    if window_s <= 0:
        raise ValueError("the window has no length")
    return len(walls) / window_s


def frame_ms_p95(walls: Sequence[float]) -> float:
    """The 95th percentile of the wall time of every call, in ms (linear
    interpolation between closest ranks)."""
    return 1e3 * float(np.percentile(walls, 95.0))
