"""Batched Breakout Local Search for the maximum-weight clique problem
(port of mcmtt_opticalflow_tpu/models/mwcp.py).

R replicas run in lockstep (ref hj::CGraphSolver,
psn_where/GraphSolver.cpp:532-669, one serial chain per hypothesis
there): membership is an [R, V] bool mask, neighbour counts and swap
partner weights are [R, V] x [V, V] products, the PA (insert) and OM
(swap) move sets are masks, and the adaptive perturbation runs one move
per iteration.  Every distinct local optimum lands in a per-replica ring
buffer; `device_k_best` merges, dedups and sorts them on the device
(`collect_k_best` is its host copy, carried over).

Randomness is the JAX package's: a solve takes a PRNG key
(utils/prng.py) and draws its fields from it exactly as the JAX
solve_mwcp draws them from its key (mwcp.py:134-141, 279-284), on the
solve's device.  In place of a key a caller may hand in a *field source*,
an object whose ``draw(r, v, iters_pad, device)`` returns the
`MwcpFields` of one solve; `ThreefryFields` is the one that splits a key
per solve as the JAX associator does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmtt_opticalflow_tpu_torch.config import SolverConfig
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
                    device) -> MwcpFields:
    """The fields the JAX package's solve_mwcp(key=key) draws: one split
    into r replica keys (their greedy-order noise) and one more, split in
    four for the loop's fields (mwcp.py:134-141, 279-284)."""
    keys = prng.split(torch.as_tensor(key, device=device), r + 1)
    ku1, kg2, ku3, kg4 = prng.split(keys[r], 4)
    return MwcpFields(noise=prng.uniform(keys[:r], (v,)),
                      u_dir=prng.uniform(ku1, (iters_pad, r)),
                      g_dir=prng.gumbel(kg2, (iters_pad, r, v)),
                      u_ten=prng.uniform(ku3, (iters_pad, r)),
                      g_rnd=prng.gumbel(kg4, (iters_pad, r, v)))


class ThreefryFields:
    """Field source splitting a PRNG key once per solve, as the JAX
    associator splits its solver key (associator3d.py:2544): each draw
    gives the fields of the next subkey."""

    def __init__(self, key: torch.Tensor):
        self.key = key

    def draw(self, r: int, v: int, iters_pad: int, device) -> MwcpFields:
        self.key, k = prng.split(self.key)
        return threefry_fields(k, r, v, iters_pad, device)


def _greedy_initial(weights, adj, valid, orders, nvalid: int):
    """Greedy weight-descending clique construction for every row of
    `orders` [R, V] (ref BLS_GenerateInitialSolution,
    GraphSolver.cpp:986-1090).  Only the first `nvalid` positions can
    admit a vertex: every order puts the valid vertices first."""
    r, v = orders.shape
    rows = torch.arange(r, device=weights.device)
    in_c = torch.zeros((r, v), dtype=torch.bool, device=weights.device)
    size = torch.zeros(r, dtype=torch.long, device=weights.device)
    for i in range(nvalid):
        idx = orders[:, i]
        cnt = torch.sum(adj[idx] & in_c, -1)
        can = valid[idx] & (weights[idx] >= 0.0) & (cnt == size)
        in_c[rows, idx] |= can
        size += can
    return in_c


def _argmax_first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _record(sol_masks, sol_scores, sol_next, mask, score, do, s):
    """Insert a local optimum per replica unless empty, non-positive or a
    duplicate (ref BLS_InsertSolution + CheckSolutionExistance,
    GraphSolver.cpp:686-701, 967-975).  Updates the ring in place."""
    dup = torch.any((torch.abs(sol_scores - score[:, None]) < 1e-5)
                    & torch.all(sol_masks == mask[:, None, :], -1), -1)
    ok = do & ~dup & (score > 0.0) & torch.any(mask, -1)
    rows = torch.arange(mask.shape[0], device=mask.device)
    slot = sol_next % s
    sol_masks[rows, slot] = torch.where(ok[:, None], mask,
                                        sol_masks[rows, slot])
    sol_scores[rows, slot] = torch.where(ok, score, sol_scores[rows, slot])
    sol_next += ok.to(sol_next.dtype)


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
    dev = weights.device
    v = weights.shape[0]
    r = cfg.num_replicas
    s = cfg.solutions_per_replica
    if iters is None:
        iters = cfg.max_iterations
    unroll = max(int(cfg.unroll), 1)
    iters_pad = ((iters + unroll - 1) // unroll) * unroll
    nvalid_t = torch.sum(valid)
    l0 = torch.clamp(cfg.l0_ratio * nvalid_t, min=1.0)
    lmax = torch.clamp(cfg.lmax_ratio * nvalid_t, min=2.0)
    rows = torch.arange(r, device=dev)

    if init_mask.dim() == 1:
        init_mask = init_mask[None, :]
    warm = torch.zeros((r, v), dtype=torch.bool, device=dev)
    rw = min(init_mask.shape[0], r)
    warm[:rw] = init_mask[:rw]
    f = (threefry_fields(fields, r, v, iters_pad, dev)
         if isinstance(fields, torch.Tensor)
         else fields.draw(r, v, iters_pad, dev))

    # ---- initial solutions per replica -------------------------------------
    # replica i: its warm start when that is a valid nonempty clique, else
    # greedy from a randomly perturbed weight order (replica 0 keeps the
    # unperturbed order)
    adj_f = adj.to(torch.float32)
    adjc_f = (~adj).to(torch.float32)
    warm_f = warm.to(torch.float32)
    cnt = (warm_f @ adj_f.T).to(torch.int64)
    wsize = torch.sum(warm, -1)
    is_clique = (torch.all(~warm | (cnt == (wsize - 1)[:, None]), -1)
                 & torch.any(warm, -1) & torch.all(~warm | valid, -1))
    noise = f.noise * torch.clamp(torch.max(torch.abs(weights)), min=1.0) * 0.3
    # replica 0's order is the weights' own, even where an infinite weight
    # (a track of infinite cost outside the graph) makes the scale inf
    noise[0] = 0.0
    orders = torch.argsort(-torch.where(valid, weights + noise, NEG), dim=-1,
                           stable=True)
    greedy = _greedy_initial(weights, adj, valid, orders,
                             int(nvalid_t.item()))
    in_c = torch.where(is_clique[:, None], warm, greedy)
    score0 = torch.sum(torch.where(in_c, weights, 0.0), -1)

    tabu = torch.zeros((r, v), dtype=torch.int32, device=dev)
    fbest = score0.clone()
    best = in_c.clone()
    cp = in_c.clone()
    wcnt = torch.zeros(r, dtype=torch.int32, device=dev)
    l_left = torch.zeros(r, device=dev)
    use_directed = torch.zeros(r, dtype=torch.bool, device=dev)
    sol_masks = torch.zeros((r, s, v), dtype=torch.bool, device=dev)
    sol_scores = torch.full((r, s), NEG, device=dev)
    sol_next = torch.zeros(r, dtype=torch.int64, device=dev)
    true_r = torch.ones(r, dtype=torch.bool, device=dev)
    _record(sol_masks, sol_scores, sol_next, in_c, score0, true_r, s)

    for it in range(iters_pad):
        in_c_f = in_c.to(torch.float32)
        cnt = (in_c_f @ adj_f.T).to(torch.int64)
        csize = torch.sum(in_c, -1)[:, None]
        free = valid & ~in_c
        pa = free & (cnt == csize)
        om = free & (cnt == csize - 1) & (csize > 0)
        fc = torch.sum(torch.where(in_c, weights, 0.0), -1)

        # swap partner weights via the complement product (diag of ~adj
        # is True but only contributes for vertices already in C).  A
        # select, not in_c_f * weights: a pool track whose cost is +inf
        # has weight -inf, and 0 * -inf would put NaN into every product
        # (XLA rewrites the JAX package's multiply into this select)
        in_w = torch.where(in_c, weights, 0.0)
        w_partner = in_w @ adjc_f.T
        gain_ins = torch.where(pa, weights, NEG)
        gain_swp = torch.where(om, weights - w_partner, NEG)
        bi = torch.argmax(gain_ins, -1)
        bs = torch.argmax(gain_swp, -1)
        gi = gain_ins[rows, bi]
        gs = gain_swp[rows, bs]
        use_swap = gs > gi
        gain = torch.maximum(gi, gs)
        mv_v = torch.where(use_swap, bs, bi)
        partner = _argmax_first(in_c & ~adj[mv_v])
        improving = gain > 1e-9
        searching = l_left <= 0

        # ---- local-search move -------------------------------------------
        ls_in_c = in_c.clone()
        ls_in_c[rows, mv_v] = True
        ls_in_c[rows[use_swap], partner[use_swap]] = False
        do_ls = searching & improving

        # ---- local optimum event -----------------------------------------
        at_opt = searching & ~improving
        better = fc > fbest
        up = at_opt & better
        fbest = torch.where(up, fc, fbest)
        best = torch.where(up[:, None], in_c, best)
        new_w = torch.where(at_opt, torch.where(better, 0, wcnt + 1), wcnt)

        same_as_cp = torch.all(in_c == cp, -1)
        esc = new_w > cfg.t_nonimprove
        l_new = torch.where(esc, lmax,
                            torch.where(same_as_cp, l_left + 1.0, l0))
        new_w = torch.where(at_opt & esc, 0, new_w).to(torch.int32)
        _record(sol_masks, sol_scores, sol_next, in_c, fc,
                at_opt & ~same_as_cp & ~esc, s)
        cp = torch.where(at_opt[:, None], in_c, cp)

        # perturbation flavour (ref BLS_Perturbation, GraphSolver.cpp:1173-1184)
        p = torch.where(wcnt == 0, 0.0,
                        torch.clamp(torch.exp(-wcnt / cfg.t_nonimprove),
                                    max=cfg.p0))
        directed = f.u_dir[it] < p
        use_dir_now = torch.where(at_opt, directed, use_directed)
        new_l = torch.where(at_opt, l_new, l_left)

        # ---- perturbation move -------------------------------------------
        perturbing = (l_left > 0) | at_opt
        tabu_ok = tabu <= it
        # directed: uniform among {PA insert, OM swap (tabu ok)} U {C removal}
        dir_mask = (pa & tabu_ok) | (om & tabu_ok) | in_c
        dv = torch.argmax(torch.where(dir_mask, f.g_dir[it], NEG), -1)
        dany = torch.any(dir_mask, -1)
        d_is_rem = in_c[rows, dv]
        d_is_swap = om[rows, dv]
        d_partner = _argmax_first(in_c & ~adj[dv])
        pert_dir = in_c.clone()
        pert_dir[rows, dv] = ~d_is_rem
        sw = d_is_swap & ~d_is_rem
        pert_dir[rows[sw], d_partner[sw]] = False
        # tabu stamp on removed vertices (ref :1658-1661)
        om_count = torch.sum(om, -1)
        tenure = cfg.phi + (f.u_ten[it] * torch.clamp(om_count, min=1)
                            ).to(torch.int32)

        # random: uniform among OC with (tabu ok | strong neighbourhood),
        # repaired by removing non-neighbours (M4, ref GraphSolver.cpp:1281-1338)
        alpha = torch.where(wcnt == 0, cfg.alpha_s, cfg.alpha_r)
        nbr_w_in_c = in_w @ adj_f.T
        rnd_mask = free & (tabu_ok | (nbr_w_in_c >= (alpha * fc)[:, None]))
        rv = torch.argmax(torch.where(rnd_mask, f.g_rnd[it], NEG), -1)
        rany = torch.any(rnd_mask, -1)
        pert_rnd = in_c & adj[rv]
        pert_rnd[rows, rv] = True

        pert = torch.where((use_dir_now & dany)[:, None], pert_dir,
                           torch.where(rany[:, None], pert_rnd, in_c))

        # ---- combine ------------------------------------------------------
        out_in_c = torch.where(do_ls[:, None], ls_in_c,
                               torch.where(perturbing[:, None], pert, in_c))
        left = in_c & ~out_in_c
        tabu = torch.where(left, it + tenure[:, None], tabu)
        l_left = torch.where(do_ls, l_left, torch.clamp(new_l - 1.0, min=0.0))
        use_directed = torch.where(at_opt, directed, use_directed)
        wcnt = new_w
        in_c = out_in_c

    # fold the final bests into the ring buffers
    _record(sol_masks, sol_scores, sol_next, best, fbest, true_r, s)
    return MwcpResult(best_mask=best, best_score=fbest,
                      sol_masks=sol_masks, sol_scores=sol_scores)


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
