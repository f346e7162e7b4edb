"""Device mesh and placement helpers (port of
mcmtt_opticalflow_tpu/parallel/mesh.py).

The engine's concurrency axes are those of the JAX package:

  * 'cam'   — camera streams: the per-camera 2D stage is data-parallel;
              cross-camera exchange happens only at tracklet level.
  * 'block' — solver replica blocks: each block runs its own BLS replicas
              and the best clique is picked over the blocks' bests.

PyTorch has no sharded arrays behind one handle, so a placement here
splits a tensor's leading axis into one slice per group and puts each
slice on its group's device (the first device of its 'cam' row, or of
its 'block' column); a replicated placement puts a copy on every device.
Torch has no virtual devices either: a mesh may hold one device more than
once (["cpu"] * 8 in the tests, [cuda:0] * 4 on one card), which runs the
groups one after another on that device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mcmtt_opticalflow_tpu_torch.utils.device import default_device
from mcmtt_opticalflow_tpu_torch.utils.fetch import DeviceFetch
from mcmtt_opticalflow_tpu_torch.utils.tree import tree_leaves, tree_map

AXES = ("cam", "block")


class Mesh:
    """A [cam, block] array of torch.devices."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is [cam, block], got {devices.shape}")
        self.devices = devices

    @property
    def shape(self):
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(num_cam_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('cam', 'block') mesh over `devices` (default: every
    visible CUDA card; raises without one).

    num_cam_shards defaults to the largest power-of-two <= min(4, n).
    """
    if devices is None:
        default_device()                    # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if num_cam_shards is None:
        num_cam_shards = 1
        while (num_cam_shards * 2 <= min(4, n)
               and n % (num_cam_shards * 2) == 0):
            num_cam_shards *= 2
    if n % num_cam_shards:
        raise ValueError(f"{n} devices do not split into {num_cam_shards} "
                         f"'cam' rows")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(num_cam_shards, n // num_cam_shards))


class Placement(NamedTuple):
    """Where a tensor's leading axis goes on a mesh: split over the 'cam'
    rows, over the 'block' columns, or (axis None) replicated on every
    device."""
    mesh: Mesh
    axis: Optional[str]

    @property
    def devices(self) -> List[torch.device]:
        """One device per group: the first of each 'cam' row, of each
        'block' column, or every device when replicated."""
        d = self.mesh.devices
        if self.axis == "cam":
            return list(d[:, 0])
        if self.axis == "block":
            return list(d[0, :])
        return list(d.flat)

    def place(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One tensor per group: equal leading-axis slices (a 0-d tensor,
        which has no axis to split, is copied to every group), or copies
        when replicated."""
        devs = self.devices
        if self.axis is None or x.dim() == 0:
            return [x.to(d) for d in devs]
        if x.shape[0] % len(devs):
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"over {len(devs)} '{self.axis}' groups")
        return [s.to(d) for s, d in zip(torch.chunk(x, len(devs)), devs)]


def cam_sharding(mesh: Mesh) -> Placement:
    """Leading axis over cameras."""
    return Placement(mesh, "cam")


def block_sharding(mesh: Mesh) -> Placement:
    """Leading axis over solver replica blocks."""
    return Placement(mesh, "block")


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def shard_leaves(tree, sharding: Placement) -> list:
    """Place every leaf of a tuple / NamedTuple tree: one tree per group,
    holding that group's slices."""
    parts = tree_map(sharding.place, tree)        # leaves: per-group lists
    return [tree_map(lambda p, i=i: p[i], parts)
            for i in range(len(sharding.devices))]


def fetch(tree):
    """Copy every tensor leaf of a tree to the host as numpy (the JAX
    package's device_get)."""
    return AsyncFetch(tree).get()


class AsyncFetch:
    """Device->host download of a tree that overlaps host work: the
    copies are enqueued at construction (utils/fetch.py's DeviceFetch,
    non-blocking into pinned memory behind a CUDA event) and get() waits
    for them and returns the tree with numpy leaves."""

    def __init__(self, tree):
        self._tree = tree
        self._fetch = DeviceFetch(tree_leaves(tree))

    def get(self):
        leaves = iter(self._fetch.get())
        return tree_map(lambda _: next(leaves), self._tree)
