"""Device-to-host downloads that overlap host work.

Replaces the JAX package's AsyncFetch thread (parallel/mesh.py:65-95):
the copies are enqueued non-blocking into pinned host buffers, a CUDA
event is recorded behind them on each card they come from, and `get()`
waits on those events only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class DeviceFetch:
    """Handle on an in-flight download of a sequence of tensors."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._host = []
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t.detach()
            self._host.append(h)
        self._events = []
        for dev in {t.device for t in tensors if t.is_cuda}:
            with torch.cuda.device(dev):
                self._events.append(torch.cuda.Event())
                self._events[-1].record()

    def get(self) -> Tuple[np.ndarray, ...]:
        """Wait for the copies and return them as numpy arrays that own
        their memory.  A view would keep its pinned block (or, for a CPU
        tensor, the tensor) alive for as long as the host code keeps any
        slice of it: the associator keeps row views of the 2D boxes in
        its tracklets for the engine's life, one pinned block a frame."""
        for event in self._events:
            event.synchronize()
        return tuple(h.numpy().copy() for h in self._host)
