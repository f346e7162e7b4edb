"""Replica-sharded BLS solve with a global best (port of
mcmtt_opticalflow_tpu/parallel/solver_parallel.py).

The reference solves its K hypotheses on OpenMP threads in one address
space (ref psn_where/PSNWhere_Associator3D.cpp:2676-2684).  Here each
mesh 'block' runs an independent set of BLS replicas with its own random
fields on its own device, in one process, picks its local best, and the
block bests are gathered onto every process's first mesh device for a
global argmax (JAX: an all_gather over 'block' inside shard_map).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from mcmtt_opticalflow_tpu_torch.config import SolverConfig
from mcmtt_opticalflow_tpu_torch.models.mwcp import (GeneratorFields,
                                                     solve_mwcp)
from mcmtt_opticalflow_tpu_torch.parallel.mesh import (Mesh, Shards,
                                                       block_sharding, join)


def split_fields(generator: torch.Generator, devices) -> list:
    """One field source per block device, seeded from `generator` (the
    counterpart of jax.random.split(key, nblock)); None for a None
    device (a block of another process, which still takes its seed)."""
    seeds = torch.randint(0, 2 ** 62, (len(devices),), generator=generator,
                          device=generator.device).tolist()
    return [None if d is None else
            GeneratorFields(torch.Generator(device=d).manual_seed(s))
            for s, d in zip(seeds, devices)]


def solve_mwcp_sharded(weights, adj, valid, init_mask,
                       fields: Union[Sequence, torch.Generator],
                       mesh: Mesh, cfg: SolverConfig, iters: int = 500):
    """Solve one MWCP instance with replicas spread over the 'block' axis.

    Block b runs cfg.num_replicas BLS replicas (`solve_mwcp`) on its
    device of the 'block' placement (the first device of mesh column b
    for a mesh of one process; on a mesh over several processes, exactly
    one process runs each block), drawing from fields[b] (a sequence of
    one field source per block, or a torch.Generator split into one per
    block); its best replica (argmax, first index) is its candidate.  The
    candidates and every replica's result are gathered onto the mesh's
    `home` device (one all-gather when blocks run in other processes),
    where every process takes the same argmax.

    Returns (best_mask [V] bool, best_score scalar, all_masks [B*R, V],
    all_scores [B*R]) with B = number of 'block' groups, on `mesh.home`.
    """
    placement = block_sharding(mesh)
    devices, local = placement.devices, placement.local
    if isinstance(fields, torch.Generator):
        fields = split_fields(fields, [d if ok else None
                                       for d, ok in zip(devices, local)])
    if len(fields) != len(devices):
        raise ValueError(f"{len(devices)} blocks need as many field "
                         f"sources, got {len(fields)}")
    # per block: (candidate score [1], candidate mask [1, V], replica
    # masks [R, V], replica scores [R]), None for other processes' blocks
    parts = [None] * len(devices)
    for b, (d, f, ok) in enumerate(zip(devices, fields, local)):
        if ok:
            r = solve_mwcp(weights.to(d), adj.to(d), valid.to(d),
                           init_mask.to(d), f, cfg, iters)
            i = torch.argmax(r.best_score)
            parts[b] = (r.best_score[i][None], r.best_mask[i][None],
                        r.best_mask, r.best_score)
    scores, masks, all_masks, all_scores = join(
        tuple(Shards(placement, [None if p is None else p[k] for p in parts])
              for k in range(4)), mesh.home)
    gi = torch.argmax(scores)
    return masks[gi], scores[gi], all_masks, all_scores
