"""Replica-sharded BLS solve with a global best (port of
mcmtt_opticalflow_tpu/parallel/solver_parallel.py).

The reference solves its K hypotheses on OpenMP threads in one address
space (ref psn_where/PSNWhere_Associator3D.cpp:2676-2684).  Here each
mesh 'block' runs an independent set of BLS replicas with its own PRNG
key on its own device, in one process, picks its local best, and the
block bests are gathered onto every process's first mesh device for a
global argmax (JAX: an all_gather over 'block' inside shard_map).

The JAX package compiles the solve as one program under shard_map.  Its
counterpart here is one `BlockProgram` per block this process runs: the
block's solve on static buffers on the block's device, in the parts that
the fused 3D program (models/associator3d.py::FrameProgram) runs it in,
each captured as a CUDA graph on a card (utils/graphs.py::Graphed) and
run eagerly from the same buffers elsewhere.  A program is made at the
first call of its shape and replayed by every later one.  The key split,
the copy-in, the gather onto `mesh.home` and the global argmax run
outside the graphs.  `_solve_mwcp_sharded_eager`, the per-block
`solve_mwcp` calls, is the reference the programs are held against.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import torch

from mcmtt_opticalflow_tpu_torch.config import SolverConfig
from mcmtt_opticalflow_tpu_torch.models.mwcp import (MwcpFields, bls_result,
                                                     bls_start, bls_steps,
                                                     iters_padded,
                                                     solve_mwcp,
                                                     threefry_fields)
from mcmtt_opticalflow_tpu_torch.parallel.mesh import (Mesh, Shards,
                                                       block_sharding, join)
from mcmtt_opticalflow_tpu_torch.utils import prng
from mcmtt_opticalflow_tpu_torch.utils.graphs import Graphed, device_pool

# iterations a captured block replays (FrameProgram.BLOCK)
BLOCK = 50


def _candidate(masks, scores):
    """A block's (candidate score [1], candidate mask [1, V], replica
    masks, replica scores): the best replica, first index on ties, picked
    on the device (a [1] index: no host read)."""
    i = torch.argmax(scores).view(1)
    return scores[i], masks[i], masks, scores


class BlockProgram:
    """One block's solve — V vertices, `cfg.num_replicas` replicas, the
    warm-start rows `init_shape`, `iters_pad` iterations — on static
    buffers on `device`: weights [V], adj [V, V], valid [V], the warm
    starts, the block's key ([2] int64, read on the device by the draw
    kernel) and the five fields.  Its parts, in the order FrameProgram
    runs them: the field draw (in place into `fields`), the start
    (`bls_start`), a block of BLOCK iterations replayed iters_pad // BLOCK
    times and a block of the rest (`bls_steps`), and the result
    (`bls_result` and the block's argmax: the candidate's score [1] and
    mask [1, V], with every replica's masks [R, V] and scores [R]).  On
    the card `capture()` captures every part into `pool`."""

    def __init__(self, device, v: int, cfg: SolverConfig, init_shape,
                 iters_pad: int, pool=None):
        r = cfg.num_replicas

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.weights = zeros((v,))
        self.adj = zeros((v, v), torch.bool)
        self.valid = zeros((v,), torch.bool)
        self.init = zeros(tuple(init_shape), torch.bool)
        self.key = zeros((2,), torch.int64)
        self.fields = MwcpFields(
            noise=zeros((r, v)), u_dir=zeros((iters_pad, r)),
            g_dir=zeros((iters_pad, r, v)), u_ten=zeros((iters_pad, r)),
            g_rnd=zeros((iters_pad, r, v)))
        self._draw_args = (r, v, iters_pad, device)

        def draw():
            return threefry_fields(self.key, r, v, iters_pad, device,
                                   self.fields)

        def head():
            return bls_start(self.weights, self.adj, self.valid, self.init,
                             self.fields, cfg, v)

        def steps(n):
            return lambda: bls_steps(self.head.out, self.fields, cfg, n)

        def tail():
            res = bls_result(self.head.out)
            return _candidate(res.best_mask, res.best_score)

        self.draw = Graphed(draw, device, pool)
        self.head = Graphed(head, device, pool)
        self.blocks = iters_pad // BLOCK
        self.block = Graphed(steps(BLOCK), device, pool) \
            if self.blocks else None
        self.rest = Graphed(steps(iters_pad % BLOCK), device, pool) \
            if iters_pad % BLOCK else None
        self.tail = Graphed(tail, device, pool)

    def parts(self):
        """Every part, in the order a call runs them."""
        return [p for p in (self.draw, self.head, self.block, self.rest,
                            self.tail) if p is not None]

    @property
    def capture_s(self) -> float:
        return sum(p.capture_s for p in self.parts())

    def capture(self) -> None:
        """Capture every part not yet captured, in the order they run;
        nothing off the card.  The head is replayed before each
        iteration part's capture, whose warm-up advances the solver
        state from iteration 0 (as FrameProgram.capture)."""
        for part in self.parts():
            if not part.on_card or part.graph is not None:
                continue
            if part is self.block or part is self.rest:
                self.head.graph.replay()
            part.capture()

    def __call__(self, weights, adj, valid, init_mask, source):
        """One solve: copy the inputs into the buffers, and the key (or a
        field source's fields, in place of the draw), then run every
        part.  Returns the tail's outputs, which the next call
        overwrites."""
        self.capture()
        for buf, x in ((self.weights, weights), (self.adj, adj),
                       (self.valid, valid), (self.init, init_mask)):
            buf.copy_(x, non_blocking=True)
        if isinstance(source, torch.Tensor):
            self.key.copy_(source, non_blocking=True)
            self.draw()
        else:
            for dst, src in zip(self.fields,
                                source.draw(*self._draw_args)):
                dst.copy_(src)
        self.head()
        for _ in range(self.blocks):
            self.block()
        if self.rest is not None:
            self.rest()
        return self.tail()


# the programs made so far, by (block, device, V, R, warm-start rows,
# padded iterations, config), and the graph pool of each card
programs: Dict[tuple, BlockProgram] = {}
_graph_pools: Dict[torch.device, tuple] = {}


def graph_pools():
    """The graph pools made so far, one a card."""
    return list(_graph_pools.values())


def block_program(b: int, device, v: int, cfg: SolverConfig, init_shape,
                  iters_pad: int) -> BlockProgram:
    """Block b's program of this shape on `device`, made (and on the
    card captured) when first met.  Two blocks on one device each have
    their own: both are in flight in one call."""
    key = (b, str(device), v, cfg.num_replicas, tuple(init_shape),
           iters_pad, cfg)
    prog = programs.get(key)
    if prog is None:
        prog = BlockProgram(device, v, cfg, init_shape, iters_pad,
                            device_pool(_graph_pools, device))
        prog.capture()
        programs[key] = prog
    return prog


def _block_fields(fields, nblock: int, home):
    """One key or field source a block.  A key is split where it lies
    (a host key on the host: a few hundred tiny operations, which on the
    card would be as many launches) and a host key's split goes to a
    card `home` from pinned memory, so that no copy from the host waits
    for a block's work on the card."""
    if isinstance(fields, torch.Tensor):
        keys = prng.split(fields, nblock)
        if keys.device.type == "cpu" and torch.device(home).type == "cuda":
            keys = keys.pin_memory().to(home, non_blocking=True)
        fields = keys
    if len(fields) != nblock:
        raise ValueError(f"{nblock} blocks need as many keys or field "
                         f"sources, got {len(fields)}")
    return fields


def _global_best(placement, parts, home):
    """Gather the blocks' (candidate score, candidate mask, replica masks,
    replica scores) onto `home` (one all-gather when blocks run in other
    processes) and take the argmax of the candidates (on the device: no
    host read)."""
    scores, masks, all_masks, all_scores = join(
        tuple(Shards(placement, [None if p is None else p[k] for p in parts])
              for k in range(4)), home)
    gi = torch.argmax(scores).view(1)
    return masks[gi][0], scores[gi][0], all_masks, all_scores


def solve_mwcp_sharded(weights, adj, valid, init_mask,
                       fields: Union[Sequence, torch.Tensor],
                       mesh: Mesh, cfg: SolverConfig, iters: int = 500):
    """Solve one MWCP instance with replicas spread over the 'block' axis.

    Block b runs cfg.num_replicas BLS replicas on its device of the
    'block' placement (the first device of mesh column b for a mesh of
    one process; on a mesh over several processes, exactly one process
    runs each block) as its `BlockProgram`, drawing from fields[b]: a
    sequence of one PRNG key or field source per block, or a key split
    into one per block as the JAX package splits it
    (jax.random.split(key, nblock)), which every process derives alike.
    A block's best replica (argmax, first index) is its candidate.  The
    candidates and every replica's result are gathered onto the mesh's
    `home` device (one all-gather when blocks run in other processes),
    where every process takes the same argmax.  Equal, bit for bit, to
    the per-block `solve_mwcp` calls (`_solve_mwcp_sharded_eager`).

    Returns (best_mask [V] bool, best_score scalar, all_masks [B*R, V],
    all_scores [B*R]) with B = number of 'block' groups, on `mesh.home`.
    """
    placement = block_sharding(mesh)
    fields = _block_fields(fields, len(placement.devices), mesh.home)
    ip = iters_padded(cfg, iters)
    parts = [None] * len(placement.devices)
    for b, (d, f, ok) in enumerate(zip(placement.devices, fields,
                                       placement.local)):
        if ok:
            prog = block_program(b, d, weights.shape[0], cfg,
                                 init_mask.shape, ip)
            parts[b] = prog(weights, adj, valid, init_mask, f)
    return _global_best(placement, parts, mesh.home)


def _solve_mwcp_sharded_eager(weights, adj, valid, init_mask, fields,
                              mesh: Mesh, cfg: SolverConfig,
                              iters: int = 500):
    """`solve_mwcp_sharded` with each block solved eagerly by one
    `solve_mwcp` call on its device: the reference the block programs
    are held against."""
    placement = block_sharding(mesh)
    fields = _block_fields(fields, len(placement.devices), mesh.home)
    parts = [None] * len(placement.devices)
    for b, (d, f, ok) in enumerate(zip(placement.devices, fields,
                                       placement.local)):
        if ok:
            r = solve_mwcp(weights.to(d), adj.to(d), valid.to(d),
                           init_mask.to(d), f, cfg, iters)
            parts[b] = _candidate(r.best_mask, r.best_score)
    return _global_best(placement, parts, mesh.home)
