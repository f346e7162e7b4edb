"""Device-to-host downloads that overlap host work.

Replaces the JAX package's AsyncFetch thread (parallel/mesh.py:65-95):
the copies are enqueued non-blocking into pinned host buffers, a CUDA
event is recorded behind them, and `get()` waits on that event only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class DeviceFetch:
    """Handle on an in-flight download of a sequence of tensors."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._host = []
        self._event = None
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t.detach()
            self._host.append(h)
        if any(t.is_cuda for t in tensors):
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self) -> Tuple[np.ndarray, ...]:
        """Wait for the copies and return them as numpy arrays."""
        if self._event is not None:
            self._event.synchronize()
        return tuple(h.numpy() for h in self._host)
