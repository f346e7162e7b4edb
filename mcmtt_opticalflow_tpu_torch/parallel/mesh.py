"""Device mesh and placement helpers (port of
mcmtt_opticalflow_tpu/parallel/mesh.py).

The engine's concurrency axes are those of the JAX package:

  * 'cam'   — camera streams: the per-camera 2D stage is data-parallel;
              cross-camera exchange happens only at tracklet level.
  * 'block' — solver replica blocks: each block runs its own BLS replicas
              and the best clique is picked over the blocks' bests.

PyTorch has no sharded arrays behind one handle, so a placement here
splits a tensor's leading axis into one slice per group and puts each
slice on its group's device (the first device of its 'cam' row, a device
of its 'block' column, or every device for the split over both axes, the
JAX package's P(("cam", "block"))); a replicated placement puts a copy on
every device.  The slices of a split are held by `Shards`.  Torch has no
virtual devices either: a mesh may hold one device more than once
(["cpu"] * 8 in the tests, [cuda:0] * 4 on one card), which runs the
groups one after another on that device.

A mesh may span processes (parallel/launch.py::global_mesh): it records
which process owns each entry, and a process places, computes and holds
only the groups whose device it owns (`Shards.parts` is None for the
others).  `fetch`, `AsyncFetch` and `join` bring such a tree together
with one cross-process all-gather; a mesh of one process never needs one.
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
    """A [cam, block] array of torch.devices, with the process that owns
    each entry (`owners`, all 0 for a mesh of one process) and this
    process's index."""

    def __init__(self, devices: np.ndarray, owners: Optional[np.ndarray] = None,
                 process_index: int = 0):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is [cam, block], got {devices.shape}")
        self.devices = devices
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else np.asarray(owners, np.int64).reshape(devices.shape))
        self.process_index = process_index
        if process_index not in self.owners:
            raise ValueError(f"process {process_index} owns no mesh entry")

    @property
    def shape(self):
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def processes(self) -> List[int]:
        """The processes that own entries, in increasing order."""
        return sorted(set(self.owners.ravel().tolist()))

    @property
    def home(self) -> torch.device:
        """This process's first device (flat order): where the work that
        every process repeats (the replicated part of a program) runs."""
        first = np.argmax(self.owners.ravel() == self.process_index)
        return self.devices.flat[int(first)]

    def __repr__(self):
        owned = (f", owners {self.owners.flatten().tolist()}"
                 if len(self.processes) > 1 else "")
        return (f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]}"
                f"{owned})")


def make_mesh(num_cam_shards: Optional[int] = None,
              devices: Optional[Sequence] = None,
              owners: Optional[Sequence[int]] = None,
              process_index: int = 0) -> Mesh:
    """Build a ('cam', 'block') mesh over `devices` (default: every
    visible CUDA card; raises without one); `owners` names each device's
    process (default: all this one's).

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
    shape = (num_cam_shards, n // num_cam_shards)
    return Mesh(arr.reshape(shape),
                None if owners is None else np.reshape(owners, shape),
                process_index)


class Placement(NamedTuple):
    """Where a tensor's leading axis goes on a mesh: split over the 'cam'
    rows, over the 'block' columns, over every device (axis AXES), or
    (axis None) replicated on every device."""
    mesh: Mesh
    axis: object

    @property
    def _entries(self) -> List[tuple]:
        """(device, owner) of each group."""
        d, o = self.mesh.devices, self.mesh.owners
        if self.axis == "cam":
            return list(zip(d[:, 0], o[:, 0]))
        if self.axis == "block":
            # block b runs in one process: the (b * P // B)-th of the P
            # owning processes, on its first entry of column b (the
            # column's first entry when that process owns none of it), so
            # blocks spread over the processes; one process: row 0
            procs, nblock = self.mesh.processes, d.shape[1]
            out = []
            for b in range(nblock):
                want = procs[b * len(procs) // nblock]
                rows = np.flatnonzero(o[:, b] == want)
                r = int(rows[0]) if len(rows) else 0
                out.append((d[r, b], o[r, b]))
            return out
        return list(zip(d.flat, o.flat))

    @property
    def devices(self) -> List[torch.device]:
        """One device per group."""
        return [d for d, _ in self._entries]

    @property
    def owners(self) -> List[int]:
        """The process of each group."""
        return [int(o) for _, o in self._entries]

    @property
    def local(self) -> List[bool]:
        """Whether this process holds each group."""
        return [o == self.mesh.process_index for o in self.owners]

    def place(self, x: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """One tensor per group: equal leading-axis slices (a 0-d tensor,
        which has no axis to split, is copied to every group), or copies
        when replicated; None for the groups of other processes."""
        devs, local = self.devices, self.local
        if self.axis is None or x.dim() == 0:
            parts = [x] * len(devs)
        elif x.shape[0] % len(devs):
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"over {len(devs)} '{self.axis}' groups")
        else:
            parts = torch.chunk(x, len(devs))
        return [p.to(d) if ok else None
                for p, d, ok in zip(parts, devs, local)]

    def split(self, x: torch.Tensor) -> "Shards":
        """`place` for a split placement, as one Shards value."""
        return Shards(self, self.place(x))


def cam_sharding(mesh: Mesh) -> Placement:
    """Leading axis over cameras."""
    return Placement(mesh, "cam")


def block_sharding(mesh: Mesh) -> Placement:
    """Leading axis over solver replica blocks."""
    return Placement(mesh, "block")


def device_sharding(mesh: Mesh) -> Placement:
    """Leading axis over every device, in flat mesh order (the JAX
    package's P(("cam", "block")))."""
    return Placement(mesh, AXES)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


class Shards:
    """A tensor split along its leading axis over a placement's groups:
    `parts[g]` is group g's slice on its device, or None where another
    process holds it.  The whole value is the groups' slices in order."""

    def __init__(self, placement: Placement, parts: List):
        self.placement = placement
        self.parts = list(parts)

    @property
    def remote(self) -> bool:
        """Whether some slice lives in another process."""
        return any(p is None for p in self.parts)

    def local_parts(self):
        """(group index, device, slice) of each slice this process holds."""
        return [(g, d, p) for g, (d, p) in
                enumerate(zip(self.placement.devices, self.parts))
                if p is not None]

    def __repr__(self):
        return (f"Shards({self.placement.axis}, "
                f"{[None if p is None else tuple(p.shape) for p in self.parts]})")


def shard_leaves(tree, sharding: Placement) -> list:
    """Place every leaf of a tuple / NamedTuple tree: one tree per group,
    holding that group's slices (None for the groups of other
    processes)."""
    parts = tree_map(sharding.place, tree)        # leaves: per-group lists
    return [tree_map(lambda p, i=i: p[i], parts) if ok else None
            for i, ok in enumerate(sharding.local)]


def all_gather_host(obj) -> list:
    """Every process's `obj` (picklable host data), in process order: the
    one cross-process collective of this module.  torch.distributed must
    be initialised (parallel/launch.py::init)."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def fetch(tree):
    """Copy every tensor leaf of a tree to the host as numpy (the JAX
    package's device_get); a Shards leaf comes back whole, its other
    processes' slices by one all-gather for the whole tree."""
    return AsyncFetch(tree).get()


class AsyncFetch:
    """Device->host download of a tree that overlaps host work: the
    copies of this process's tensors are enqueued at construction
    (utils/fetch.py's DeviceFetch, non-blocking into pinned memory behind
    a CUDA event) and get() waits for them and returns the tree with
    numpy leaves.  When a Shards leaf has slices in other processes, get()
    makes one all-gather of every process's slices, which every process
    of the mesh must reach in the same order."""

    def __init__(self, tree):
        self._tree = tree
        leaves = tree_leaves(tree)
        self._remote = any(isinstance(x, Shards) and x.remote
                           for x in leaves)
        tensors = []
        for x in leaves:
            tensors += ([p for _, _, p in x.local_parts()]
                        if isinstance(x, Shards) else [x])
        self._fetch = DeviceFetch(tensors)

    def get(self):
        host = iter(self._fetch.get())
        # per leaf: the array, or {group: slice} of a Shards leaf
        mine = [{g: next(host) for g, _, _ in x.local_parts()}
                if isinstance(x, Shards) else next(host)
                for x in tree_leaves(self._tree)]
        if self._remote:
            everyone = all_gather_host(
                [m if isinstance(m, dict) else None for m in mine])
            for i, m in enumerate(mine):
                if isinstance(m, dict):
                    for theirs in everyone:
                        m.update(theirs[i])
        leaves = iter(np.concatenate([m[g] for g in sorted(m)])
                      if isinstance(m, dict) else m for m in mine)
        return tree_map(lambda _: next(leaves), self._tree)


def join(tree, device, out=None):
    """Every leaf whole on `device`: a Shards leaf's slices concatenated
    there (one all-gather for the tree when some live in other
    processes), a tensor moved there.  With `out`, a tree of tensors of
    the whole shapes on `device`, each leaf is written into its own and
    `out` is returned."""
    if any(isinstance(x, Shards) and x.remote for x in tree_leaves(tree)):
        whole = fetch(tree)
        if out is None:
            return tree_map(lambda a: torch.from_numpy(a).to(device), whole)
        for dst, a in zip(tree_leaves(out), tree_leaves(whole)):
            dst.copy_(torch.from_numpy(a))
        return out

    def local(x, dst=None):
        parts = x.parts if isinstance(x, Shards) else [x]
        if dst is None and not isinstance(x, Shards):
            return x.to(device)
        return torch.cat([p.to(device) for p in parts], out=dst)
    if out is None:
        return tree_map(local, tree)
    return tree_map(local, tree, out)
