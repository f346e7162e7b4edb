"""Multi-process launch helpers (port of
mcmtt_opticalflow_tpu/parallel/launch.py).

The JAX package scales across hosts with jax.distributed and one global
mesh.  Here the processes join one torch.distributed process group, and
`global_mesh` builds one ('cam', 'block') mesh over every process's local
devices, in process order, recording which process owns each entry
(parallel/mesh.py).  Each process runs the groups it owns; the
cross-process collectives are parallel/mesh.py's all-gathers.

Typical 2-process launch (one process per card or host):

    python -c "from mcmtt_opticalflow_tpu_torch.parallel.launch import init; \\
               init('host0:1234', num_processes=2, process_id=0)"

(parallel/multihost_sim.py runs the whole path in two processes.)
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mcmtt_opticalflow_tpu_torch.parallel.mesh import (Mesh, all_gather_host,
                                                       make_mesh)
from mcmtt_opticalflow_tpu_torch.utils.device import default_device


def _own_card() -> torch.device:
    """This process's card: rank modulo the visible cards (raises
    without one)."""
    default_device()
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         backend: Optional[str] = None) -> None:
    """Join the process group at tcp://<coordinator_address> (host:port)
    as rank `process_id` of `num_processes`; with no address, from
    torch.distributed's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  backend None: nccl when a CUDA card is visible,
    else gloo; a backend that is named is used as named.  Under nccl the
    process's own card becomes its current device."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, **kwargs)
    if backend == "nccl":
        torch.cuda.set_device(_own_card())


def global_mesh(num_cam_shards: Optional[int] = None,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over every process's local devices, in process order, with
    each entry's owner (call after init()).  local_devices defaults to
    this process's own card, and raises without one: the CPU is taken
    only when named (e.g. ["cpu"] * 4)."""
    if local_devices is None:
        local_devices = [_own_card()]
    per_process = all_gather_host([str(torch.device(d))
                                   for d in local_devices])
    devices = [d for p in per_process for d in p]
    owners = [i for i, p in enumerate(per_process) for _ in p]
    return make_mesh(num_cam_shards, devices, owners, dist.get_rank())


def scaling_report(mesh, frames_per_sec_1chip: float,
                   frames_per_sec_mesh: float) -> dict:
    """Scaling-efficiency record for BASELINE.json's 1 chip / 1 host /
    N hosts measurement protocol."""
    n = mesh.size
    ideal = frames_per_sec_1chip * n
    return {
        "devices": n,
        "mesh": dict(mesh.shape),
        "fps_1chip": frames_per_sec_1chip,
        "fps_mesh": frames_per_sec_mesh,
        "scaling_efficiency": (frames_per_sec_mesh / ideal) if ideal else 0.0,
    }


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
