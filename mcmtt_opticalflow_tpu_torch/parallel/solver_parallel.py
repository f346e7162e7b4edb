"""Replica-sharded BLS solve with a global best (port of
mcmtt_opticalflow_tpu/parallel/solver_parallel.py).

The reference solves its K hypotheses on OpenMP threads in one address
space (ref psn_where/PSNWhere_Associator3D.cpp:2676-2684).  Here each
mesh 'block' runs an independent set of BLS replicas with its own random
fields on its own device, picks its local best, and the block bests are
gathered onto the mesh's first device for a global argmax (JAX: an
all_gather over 'block' inside shard_map).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from mcmtt_opticalflow_tpu_torch.config import SolverConfig
from mcmtt_opticalflow_tpu_torch.models.mwcp import (GeneratorFields,
                                                     solve_mwcp)
from mcmtt_opticalflow_tpu_torch.parallel.mesh import Mesh, block_sharding


def split_fields(generator: torch.Generator, devices) -> list:
    """One field source per block device, seeded from `generator` (the
    counterpart of jax.random.split(key, nblock))."""
    seeds = torch.randint(0, 2 ** 62, (len(devices),), generator=generator,
                          device=generator.device).tolist()
    return [GeneratorFields(torch.Generator(device=d).manual_seed(s))
            for s, d in zip(seeds, devices)]


def solve_mwcp_sharded(weights, adj, valid, init_mask,
                       fields: Union[Sequence, torch.Generator],
                       mesh: Mesh, cfg: SolverConfig, iters: int = 500):
    """Solve one MWCP instance with replicas spread over the 'block' axis.

    Block b runs cfg.num_replicas BLS replicas (`solve_mwcp`) on the first
    device of mesh column b, drawing from fields[b] (a sequence of one
    field source per block, or a torch.Generator split into one per
    block); its best replica (argmax, first index) is its candidate, and
    the candidates are compared on the mesh's first device.

    Returns (best_mask [V] bool, best_score scalar, all_masks [B*R, V],
    all_scores [B*R]) with B = number of 'block' groups, on the mesh's
    first device.
    """
    devices = block_sharding(mesh).devices
    if isinstance(fields, torch.Generator):
        fields = split_fields(fields, devices)
    if len(fields) != len(devices):
        raise ValueError(f"{len(devices)} blocks need as many field "
                         f"sources, got {len(fields)}")
    home = mesh.devices.flat[0]
    results = [solve_mwcp(weights.to(d), adj.to(d), valid.to(d),
                          init_mask.to(d), f, cfg, iters)
               for d, f in zip(devices, fields)]
    local = [torch.argmax(r.best_score) for r in results]
    scores = torch.stack([r.best_score[i].to(home)
                          for r, i in zip(results, local)])       # [B]
    masks = torch.stack([r.best_mask[i].to(home)
                         for r, i in zip(results, local)])        # [B, V]
    gi = torch.argmax(scores)
    return (masks[gi], scores[gi],
            torch.cat([r.best_mask.to(home) for r in results]),
            torch.cat([r.best_score.to(home) for r in results]))
