# Plain copy of mcmtt_opticalflow_tpu_torch/ops/mwcp_kernel.py (the *_reference functions) at commit 052b569610a6.
"""The max-weight-clique solver's two loops and its start scores in plain
PyTorch: `greedy_start` builds each replica's greedy clique along its
vertex order, `bls_steps` runs BLS iterations of every replica in place
on a solve's state, and `clique_weights` scores the start cliques.
"""

from __future__ import annotations


import torch


NEG = -1e30

def greedy_start_reference(weights, adj, valid, orders, bound: int):
    """Greedy weight-descending clique construction for every row of
    `orders` [R, V] (ref BLS_GenerateInitialSolution,
    GraphSolver.cpp:986-1090), over the first `bound` positions.
    Positions at or past sum(valid) admit nothing (every order puts the
    valid vertices first), so any bound >= sum(valid) — the graph
    bucket, or V as the JAX package runs it — gives the cliques of a loop
    to sum(valid), without reading that count on the host."""
    r, v = orders.shape
    dev = weights.device
    rows = torch.arange(r, device=dev)
    admits = (valid[orders] & (weights[orders] >= 0.0)
              & (torch.arange(v, device=dev) < torch.sum(valid)))
    in_c = torch.zeros((r, v), dtype=torch.bool, device=dev)
    size = torch.zeros(r, dtype=torch.long, device=dev)
    for i in range(bound):
        idx = orders[:, i]
        cnt = torch.sum(adj[idx] & in_c, -1)
        can = admits[:, i] & (cnt == size)
        in_c[rows, idx] |= can
        size += can
    return in_c


def clique_weights_reference(masks, weights):
    """Each row's clique weight: the weights of masks [R, V] summed, [R]."""
    return torch.sum(torch.where(masks, weights, 0.0), -1)


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


def _at(x: torch.Tensor, it: torch.Tensor) -> torch.Tensor:
    """Row `it` ([1] on the device) of a field, read on the device."""
    return x.index_select(0, it)[0]


def _bls_step(st, f, cfg, rows: torch.Tensor, true_r: torch.Tensor,
              adj_f: torch.Tensor, adjc_f: torch.Tensor):
    """One lockstep BLS iteration of every replica; the ring buffers are
    updated in place, the rest comes back new.  `rows` is arange(R) and
    `true_r` R Trues, on the device: an indexed write of a Python scalar
    would copy it from the host.  `adj_f` and `adjc_f` are the adjacency
    and its complement as float32."""
    weights, adj, valid, in_c, it = st.weights, st.adj, st.valid, st.in_c, \
        st.it
    s = st.sol_masks.shape[1]
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
    searching = st.l_left <= 0

    # ---- local-search move -----------------------------------------------
    # (every row writes its partner; rows that do not swap write it back
    # unchanged: a masked row write would need a host read of the mask)
    ls_in_c = in_c.clone()
    ls_in_c[rows, mv_v] = true_r
    ls_in_c[rows, partner] &= ~use_swap
    do_ls = searching & improving

    # ---- local optimum event ---------------------------------------------
    at_opt = searching & ~improving
    better = fc > st.fbest
    up = at_opt & better
    fbest = torch.where(up, fc, st.fbest)
    best = torch.where(up[:, None], in_c, st.best)
    new_w = torch.where(at_opt, torch.where(better, 0, st.wcnt + 1), st.wcnt)

    same_as_cp = torch.all(in_c == st.cp, -1)
    esc = new_w > cfg.t_nonimprove
    l_new = torch.where(esc, st.lmax,
                        torch.where(same_as_cp, st.l_left + 1.0, st.l0))
    new_w = torch.where(at_opt & esc, 0, new_w).to(torch.int32)
    _record(st.sol_masks, st.sol_scores, st.sol_next, in_c, fc,
            at_opt & ~same_as_cp & ~esc, s)
    cp = torch.where(at_opt[:, None], in_c, st.cp)

    # perturbation flavour (ref BLS_Perturbation, GraphSolver.cpp:1173-1184)
    p = torch.where(st.wcnt == 0, 0.0,
                    torch.clamp(torch.exp(-st.wcnt / cfg.t_nonimprove),
                                max=cfg.p0))
    directed = _at(f.u_dir, it) < p
    use_dir_now = torch.where(at_opt, directed, st.use_directed)
    new_l = torch.where(at_opt, l_new, st.l_left)

    # ---- perturbation move -----------------------------------------------
    perturbing = (st.l_left > 0) | at_opt
    tabu_ok = st.tabu <= it
    # directed: uniform among {PA insert, OM swap (tabu ok)} U {C removal}
    dir_mask = (pa & tabu_ok) | (om & tabu_ok) | in_c
    dv = torch.argmax(torch.where(dir_mask, _at(f.g_dir, it), NEG), -1)
    dany = torch.any(dir_mask, -1)
    d_is_rem = in_c[rows, dv]
    d_is_swap = om[rows, dv]
    d_partner = _argmax_first(in_c & ~adj[dv])
    pert_dir = in_c.clone()
    pert_dir[rows, dv] = ~d_is_rem
    pert_dir[rows, d_partner] &= ~(d_is_swap & ~d_is_rem)
    # tabu stamp on removed vertices (ref :1658-1661)
    om_count = torch.sum(om, -1)
    tenure = cfg.phi + (_at(f.u_ten, it) * torch.clamp(om_count, min=1)
                        ).to(torch.int32)

    # random: uniform among OC with (tabu ok | strong neighbourhood),
    # repaired by removing non-neighbours (M4, ref GraphSolver.cpp:1281-1338)
    alpha = torch.where(st.wcnt == 0, cfg.alpha_s, cfg.alpha_r)
    nbr_w_in_c = in_w @ adj_f.T
    rnd_mask = free & (tabu_ok | (nbr_w_in_c >= (alpha * fc)[:, None]))
    rv = torch.argmax(torch.where(rnd_mask, _at(f.g_rnd, it), NEG), -1)
    rany = torch.any(rnd_mask, -1)
    pert_rnd = in_c & adj[rv]
    pert_rnd[rows, rv] = true_r

    pert = torch.where((use_dir_now & dany)[:, None], pert_dir,
                       torch.where(rany[:, None], pert_rnd, in_c))

    # ---- combine ---------------------------------------------------------
    out_in_c = torch.where(do_ls[:, None], ls_in_c,
                           torch.where(perturbing[:, None], pert, in_c))
    left = in_c & ~out_in_c
    return st._replace(
        in_c=out_in_c,
        tabu=torch.where(left, it + tenure[:, None], st.tabu),
        fbest=fbest, best=best, cp=cp, wcnt=new_w,
        l_left=torch.where(do_ls, st.l_left,
                           torch.clamp(new_l - 1.0, min=0.0)),
        use_directed=torch.where(at_opt, directed, st.use_directed),
        it=it + 1)


def bls_steps_reference(st, f, cfg, n: int) -> None:
    """Run `n` iterations from the solve state `st` (models/mwcp.py's
    BlsState) on the fields `f` and write the loop state back into its
    tensors."""
    r = st.in_c.shape[0]
    dev = st.in_c.device
    rows = torch.arange(r, device=dev)
    true_r = torch.ones(r, dtype=torch.bool, device=dev)
    adj_f = st.adj.to(torch.float32)
    adjc_f = (~st.adj).to(torch.float32)
    cur = st
    for _ in range(n):
        cur = _bls_step(cur, f, cfg, rows, true_r, adj_f, adjc_f)
    for dst, src in zip(st, cur):
        if src is not dst:
            dst.copy_(src)



greedy_start = greedy_start_reference
clique_weights = clique_weights_reference
bls_steps = bls_steps_reference
