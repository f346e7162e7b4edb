"""Batched Breakout Local Search for the maximum-weight clique problem
(port of mcmtt_opticalflow_tpu/models/mwcp.py).

R replicas run in lockstep (ref hj::CGraphSolver,
psn_where/GraphSolver.cpp:532-669, one serial chain per hypothesis
there): the PA (insert) and OM (swap) move sets follow from neighbour
counts, and the adaptive perturbation runs one move per iteration.
Every distinct local optimum lands in a per-replica ring buffer;
`device_k_best` merges, dedups and sorts them on the device
(`collect_k_best` is its host copy, carried over).  The JAX package's
two device loops, the greedy start and the BLS iterations, are CUDA
kernels on a card (ops/mwcp_kernel.py: `greedy_start`, `bls_steps`,
and `clique_weights` for the start's scores in the BLS kernel's order;
their plain versions, [R, V] masks and [R, V] x [V, V] products, run
for CPU tensors).

Randomness is the JAX package's: a solve takes a PRNG key
(utils/prng.py) and draws its fields from it exactly as the JAX
solve_mwcp draws them from its key (mwcp.py:134-141, 279-284), on the
solve's device (on a card in one kernel launch, ops/threefry_kernel.py).  In place of a key a caller may hand in a *field source*,
an object whose ``draw(r, v, iters_pad, device)`` returns the
`MwcpFields` of one solve; `ThreefryFields` is the one that splits a key
per solve as the JAX associator does.

The solve runs in three parts, so that a caller can capture each as a
CUDA graph (models/associator3d.py): `bls_start` (the warm starts, the
greedy starts and the first record), `bls_steps` (any number of
iterations, reading the iteration number from a device counter, as the
JAX package's while_loop does) and `bls_result` (the last record).  No
part reads a device value on the host.  `solve_mwcp` runs the three in
turn.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmtt_opticalflow_tpu_torch.config import SolverConfig
from mcmtt_opticalflow_tpu_torch.ops.mwcp_kernel import (  # noqa: F401
    _argmax_first, _record, bls_steps, clique_weights)
from mcmtt_opticalflow_tpu_torch.ops.mwcp_kernel import \
    greedy_start as _greedy_initial
from mcmtt_opticalflow_tpu_torch.ops import threefry_kernel
from mcmtt_opticalflow_tpu_torch.utils import prng

NEG = -1e30


class MwcpResult(NamedTuple):
    best_mask: torch.Tensor      # [R, V] bool, per-replica best clique
    best_score: torch.Tensor     # [R]
    sol_masks: torch.Tensor      # [R, S, V] bool local-optima ring buffers
    sol_scores: torch.Tensor     # [R, S] (NEG = empty slot)


class MwcpFields(NamedTuple):
    """The random numbers of one solve (shapes as mwcp.py:134, 279-284)."""
    noise: torch.Tensor          # [R, V] uniform, replica greedy-order noise
    u_dir: torch.Tensor          # [I, R] uniform, directed-perturbation draw
    g_dir: torch.Tensor          # [I, R, V] gumbel, directed pick
    u_ten: torch.Tensor          # [I, R] uniform, tabu tenure
    g_rnd: torch.Tensor          # [I, R, V] gumbel, random pick


def threefry_fields(key: torch.Tensor, r: int, v: int, iters_pad: int,
                    device, out: MwcpFields | None = None) -> MwcpFields:
    """The fields the JAX package's solve_mwcp(key=key) draws: one split
    into r replica keys (their greedy-order noise) and one more, split in
    four for the loop's fields (mwcp.py:134-141, 279-284).  On a card one
    launch of the draw kernel (ops/threefry_kernel.py), for a CPU key its
    plain version; with `out` the fields are written into its tensors."""
    return MwcpFields(*threefry_kernel.threefry_fields(
        torch.as_tensor(key, device=device), r, v, iters_pad, out))


def draw_fields(fields, r: int, v: int, iters_pad: int,
                device) -> MwcpFields:
    """The fields of one solve from a PRNG key or a field source."""
    if isinstance(fields, torch.Tensor):
        return threefry_fields(fields, r, v, iters_pad, device)
    return fields.draw(r, v, iters_pad, device)


def iters_padded(cfg: SolverConfig, iters: int | None = None) -> int:
    """The iteration count rounded up to whole unrolled trips (the rows
    of the loop's fields)."""
    if iters is None:
        iters = cfg.max_iterations
    unroll = max(int(cfg.unroll), 1)
    return ((iters + unroll - 1) // unroll) * unroll


class ThreefryFields:
    """Field source splitting a PRNG key once per solve, as the JAX
    associator splits its solver key (associator3d.py:2544): each draw
    gives the fields of the next subkey."""

    def __init__(self, key: torch.Tensor):
        self.key = key

    def draw(self, r: int, v: int, iters_pad: int, device) -> MwcpFields:
        self.key, k = prng.split(self.key)
        return threefry_fields(k, r, v, iters_pad, device)


class BlsState(NamedTuple):
    """A solve between its parts: the graph (weights, adjacency and
    validity, the perturbation lengths) and the replicas' loop state,
    with `it` the number of the next iteration ([1] int32 on the device).
    `bls_steps` writes the loop state back into these tensors, so that a
    captured block of iterations replays from where the last one
    stopped."""
    weights: torch.Tensor
    adj: torch.Tensor
    valid: torch.Tensor
    l0: torch.Tensor
    lmax: torch.Tensor
    in_c: torch.Tensor
    tabu: torch.Tensor
    fbest: torch.Tensor
    best: torch.Tensor
    cp: torch.Tensor
    wcnt: torch.Tensor
    l_left: torch.Tensor
    use_directed: torch.Tensor
    sol_masks: torch.Tensor
    sol_scores: torch.Tensor
    sol_next: torch.Tensor
    it: torch.Tensor


def replica_orders(weights: torch.Tensor, valid: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """The greedy starts' vertex orders [R, V]: descending weight plus the
    replica's scaled uniform `noise` [R, V], valid vertices first."""
    noise = noise * torch.clamp(torch.max(torch.abs(weights)), min=1.0) * 0.3
    # replica 0's order is the weights' own, even where an infinite weight
    # (a track of infinite cost outside the graph) makes the scale inf
    noise[0] = 0.0
    return torch.argsort(-torch.where(valid, weights + noise, NEG), dim=-1,
                         stable=True)


def bls_start(weights: torch.Tensor,
              adj: torch.Tensor,
              valid: torch.Tensor,
              init_mask: torch.Tensor,
              f: MwcpFields,
              cfg: SolverConfig,
              bound: int) -> BlsState:
    """The solve's start: each replica's initial solution and the first
    record.  Replica i starts from its warm start when that is a valid
    nonempty clique, else greedily from a randomly perturbed weight order
    (replica 0 keeps the unperturbed order).  `bound` >= sum(valid) is
    the greedy loop's static length (see
    ops/mwcp_kernel.py::greedy_start_reference)."""
    dev = weights.device
    v = weights.shape[0]
    r = cfg.num_replicas
    s = cfg.solutions_per_replica
    nvalid_t = torch.sum(valid)
    l0 = torch.clamp(cfg.l0_ratio * nvalid_t, min=1.0)
    lmax = torch.clamp(cfg.lmax_ratio * nvalid_t, min=2.0)

    if init_mask.dim() == 1:
        init_mask = init_mask[None, :]
    warm = torch.zeros((r, v), dtype=torch.bool, device=dev)
    rw = min(init_mask.shape[0], r)
    warm[:rw] = init_mask[:rw]
    cnt = (warm.to(torch.float32) @ adj.to(torch.float32).T).to(torch.int64)
    wsize = torch.sum(warm, -1)
    is_clique = (torch.all(~warm | (cnt == (wsize - 1)[:, None]), -1)
                 & torch.any(warm, -1) & torch.all(~warm | valid, -1))
    greedy = _greedy_initial(weights, adj, valid,
                             replica_orders(weights, valid, f.noise), bound)
    in_c = torch.where(is_clique[:, None], warm, greedy)
    score0 = clique_weights(in_c, weights)

    sol_masks = torch.zeros((r, s, v), dtype=torch.bool, device=dev)
    sol_scores = torch.full((r, s), NEG, device=dev)
    sol_next = torch.zeros(r, dtype=torch.int64, device=dev)
    true_r = torch.ones(r, dtype=torch.bool, device=dev)
    _record(sol_masks, sol_scores, sol_next, in_c, score0, true_r, s)
    return BlsState(
        weights=weights, adj=adj, valid=valid, l0=l0, lmax=lmax, in_c=in_c,
        tabu=torch.zeros((r, v), dtype=torch.int32, device=dev),
        fbest=score0.clone(), best=in_c.clone(), cp=in_c.clone(),
        wcnt=torch.zeros(r, dtype=torch.int32, device=dev),
        l_left=torch.zeros(r, device=dev),
        use_directed=torch.zeros(r, dtype=torch.bool, device=dev),
        sol_masks=sol_masks, sol_scores=sol_scores, sol_next=sol_next,
        it=torch.zeros(1, dtype=torch.int32, device=dev))


def bls_result(st: BlsState) -> MwcpResult:
    """The solve's result: the final bests folded into the rings."""
    r, s, _ = st.sol_masks.shape
    true_r = torch.ones(r, dtype=torch.bool, device=st.in_c.device)
    _record(st.sol_masks, st.sol_scores, st.sol_next, st.best, st.fbest,
            true_r, s)
    return MwcpResult(best_mask=st.best, best_score=st.fbest,
                      sol_masks=st.sol_masks, sol_scores=st.sol_scores)


def solve_mwcp(weights: torch.Tensor,
               adj: torch.Tensor,
               valid: torch.Tensor,
               init_mask: torch.Tensor,
               fields,
               cfg: SolverConfig,
               iters: int | None = None) -> MwcpResult:
    """Solve one max-weight-clique instance with R lockstep BLS replicas.

    Args:
      weights:   [V] vertex weights (track log-likelihoods), float32.
      adj:       [V, V] bool compatibility, diag False.
      valid:     [V] bool vertex mask.
      init_mask: warm starts, [V] or [R', V] bool with R' <= R: replica i
                 starts from row i when that row is a valid nonempty
                 clique (ref BLS_SetInitialSolutions,
                 GraphSolver.cpp:820-956).
      fields:    a PRNG key or a field source (see the module docstring).
    """
    v = weights.shape[0]
    iters_pad = iters_padded(cfg, iters)
    f = draw_fields(fields, cfg.num_replicas, v, iters_pad, weights.device)
    st = bls_start(weights, adj, valid, init_mask, f, cfg, v)
    bls_steps(st, f, cfg, iters_pad)
    return bls_result(st)


def solve_mwcp_batch(weights: torch.Tensor,
                     adj: torch.Tensor,
                     valid: torch.Tensor,
                     init_mask: torch.Tensor,
                     fields,
                     cfg: SolverConfig,
                     iters: int | None = None) -> MwcpResult:
    """B independent instances over a leading axis (the JAX package's
    vmap of solve_mwcp): weights [B, V], adj [B, V, V], valid [B, V],
    init_mask [B, V] or [B, R', V], and one PRNG key or field source per
    instance in `fields` (JAX vmaps over one PRNG key per instance).  Returns the
    MwcpResult with every leaf stacked on a leading [B] axis."""
    if len(fields) != weights.shape[0]:
        raise ValueError(f"{weights.shape[0]} instances need as many keys "
                         f"or field sources, got {len(fields)}")
    outs = [solve_mwcp(weights[b], adj[b], valid[b], init_mask[b],
                       fields[b], cfg, iters)
            for b in range(weights.shape[0])]
    return MwcpResult(*[torch.stack(leaf) for leaf in zip(*outs)])


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap of an int64 tensor (jnp int32
    arithmetic overflows this way)."""
    return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31


def device_k_best(result: MwcpResult, k: int):
    """Top-k distinct local optima: [K, V] masks + [K] scores (empty slots
    score NEG) — merge all replicas' rings, dedup identical cliques, sort
    by score.  Dedup key: (score, two multiplicative int32 hashes of the
    mask), exactly as the JAX version computes it."""
    v = result.sol_masks.shape[-1]
    dev = result.sol_masks.device
    flat_m = result.sol_masks.reshape(-1, v)
    flat_s = result.sol_scores.reshape(-1)
    iota = torch.arange(v, dtype=torch.int64, device=dev)
    salt1 = _wrap32((iota + 1) * -1640531527)        # Knuth multiplicative
    salt2 = _wrap32((iota + 1) * (iota + 7) * 40503)
    m = flat_m.to(torch.int64)
    h1 = _wrap32(torch.sum(m * salt1[None, :], -1))
    h2 = _wrap32(torch.sum(m * salt2[None, :], -1))
    # lexsort((h2, h1, -s)): stable sorts from the least significant key
    order = torch.argsort(h2, stable=True)
    order = order[torch.argsort(h1[order], stable=True)]
    order = order[torch.argsort(-flat_s[order], stable=True)]
    ss, hh1, hh2 = flat_s[order], h1[order], h2[order]
    dup = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=dev),
        (ss[1:] == ss[:-1]) & (hh1[1:] == hh1[:-1]) & (hh2[1:] == hh2[:-1])])
    empty = ss <= NEG / 2
    uniq = ~dup & ~empty
    rank = torch.cumsum(uniq.to(torch.int64), 0) - 1
    n = flat_s.shape[0]
    slot = torch.where(uniq, torch.clamp(rank, max=k), k)   # k = dropped
    src = torch.full((k + 1,), n, dtype=torch.int64, device=dev)
    src = src.scatter_reduce(0, slot, torch.arange(n, device=dev), "amin")[:k]
    got = src < n
    src_safe = torch.clamp(src, 0, n - 1)
    masks = torch.where(got[:, None], flat_m[order][src_safe], False)
    scores = torch.where(got, ss[src_safe], NEG)
    return masks, scores


def collect_k_best(result: MwcpResult, k: int):
    """Host-side: merge all replicas' local optima, dedup by (score, mask),
    sort by score descending, return top-k (mask, score) pairs — the
    reference's K-best list semantics (ref GraphSolver.cpp:653-660 +
    Hypothesis_BranchHypotheses dedup, Associator3D.cpp:2797-2828)."""
    import numpy as np

    masks = result.sol_masks.cpu().numpy().reshape(-1, result.sol_masks.shape[-1])
    scores = result.sol_scores.cpu().numpy().reshape(-1)
    keep = scores > NEG / 2
    masks, scores = masks[keep], scores[keep]
    order = np.argsort(-scores)
    # identical masks always carry identical scores (score is the mask's
    # weight sum), so dedup hashes the packed mask bytes — O(n), not the
    # reference's O(n^2) pairwise comparison
    packed = np.packbits(masks[order], axis=1)
    out_masks, out_scores = [], []
    seen = set()
    for j, i in enumerate(order):
        key = packed[j].tobytes()
        if key in seen:
            continue
        seen.add(key)
        out_masks.append(masks[i])
        out_scores.append(float(scores[i]))
        if len(out_masks) >= k:
            break
    return out_masks, out_scores
