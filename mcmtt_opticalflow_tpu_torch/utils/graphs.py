"""CUDA graphs for the port's fixed-shape device programs.

A `Graphed` holds a function of static buffers: it takes no arguments,
reads the tensors it closes over and returns its outputs.  On a CUDA
device `capture()` records it into a CUDA graph (after one eager run on
a side stream, which fills lazy state such as library handles and
cached constants) and each call replays the graph: one launch of all the
recorded work on the current stream, writing the same output tensors,
whatever the buffers hold then.  On any other device each call runs the
function eagerly.  This is the card's counterpart of a jitted XLA
executable, built once per static shape.

There is no fallback: a capture or replay that fails raises.

A replay runs no Python: the port's kernel wrappers count the launches
of the capture's two calls (the warm-up, which runs, and the recording,
which does not) and none of its replays.  What the card ran is counted
on the card (utils/kernel_events.py).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

# One capture stream per card, every graph of the process captured on its
# card's: a graph pool reuses the blocks that earlier captures freed only
# on the stream they were captured on, and torch.cuda.graph's own default
# stream belongs to the card of the process's first capture.
_capture_streams = {}


def _capture_stream() -> torch.cuda.Stream:
    """The current card's capture stream."""
    index = torch.cuda.current_device()
    if index not in _capture_streams:
        _capture_streams[index] = torch.cuda.Stream()
    return _capture_streams[index]


def device_pool(pools: dict, device):
    """The graph pool of a CUDA `device` in `pools` (a dict by device,
    the pools of one owner's programs), made when first asked for; None
    for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device not in pools:
        pools[device] = torch.cuda.graph_pool_handle()
    return pools[device]


class Graphed:
    """`fn` captured as a CUDA graph on a CUDA `device` (into `pool`, a
    `torch.cuda.graph_pool_handle()` that the graphs of one program
    share), called eagerly elsewhere.  `out` is fn's latest output: on
    the card the graph's static output tensors.  `n_replays` counts its
    replays."""

    def __init__(self, fn: Callable, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self.out = None
        self.capture_s = 0.0
        self.n_replays = 0

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def capture(self) -> None:
        """Warm up and capture, both on the capture stream of the graph's
        card.  Capturing runs nothing: `out` holds the graph's output
        tensors, whose values the first replay writes.  Nothing to do off
        the card or when already captured."""
        if not self.on_card or self.graph is not None:
            return
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = _capture_stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.fn()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                self.out = self.fn()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self):
        if not self.on_card:
            self.out = self.fn()
            return self.out
        if self.graph is None:
            raise RuntimeError("Graphed: call capture() before the first "
                               "replay")
        self.graph.replay()
        self.n_replays += 1
        return self.out
