"""The max-weight-clique solver's two device loops and its start scores:
the hand-written CUDA kernels (csrc/mwcp_bls.cu) and their plain PyTorch
versions.

- `greedy_start` builds each replica's greedy clique along its vertex
  order (the JAX package's `_greedy_initial` fori_loop over V,
  mcmtt_opticalflow_tpu/models/mwcp.py:48-60, vmapped over the replicas);
  plain version `greedy_start_reference`.
- `bls_steps` runs BLS iterations of every replica in place on a solve's
  state (the JAX package's while_loop, mwcp.py:286-324, over its body
  `one_replica_step`, :177-273); plain version `bls_steps_reference`.
- `clique_weights` scores the start cliques in the BLS kernel's order
  (members ascending), so that a clique scores alike wherever it is
  summed; plain version `clique_weights_reference` (torch.sum).

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel, on the current stream with no host
read (a CUDA graph captures it), or raises.  `greedy_start.launches`,
`bls_steps.launches` and `clique_weights.launches` count kernel
launches.  `greedy_work`, `bls_work` and `clique_work` give the bytes,
operations and serial steps behind a kernel's bound.

The plain versions keep the arithmetic that, on the CPU, equals the JAX
engine (models/mwcp.py's module docstring); the kernel's sums differ
from them in order only (see csrc/mwcp_bls.cu).
"""

from __future__ import annotations

import ctypes

import torch

from mcmtt_opticalflow_tpu_torch.ops.nvcc_build import build_library

NEG = -1e30
HBM_BYTES_PER_S = 3.35e12    # H100 SXM: HBM3 rate, FP32 rate (no tensor
OPS_PER_S = 67e12            # cores: integer and bit operations at it)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the work behind the bounds
# ---------------------------------------------------------------------------

def _bound(nbytes: int, ops: int) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def greedy_work(weights, adj, valid, orders, bound: int) -> dict:
    """The bytes and operations one `greedy_start` call needs on these
    inputs, and its serial steps.

    - bytes: orders (8 B an entry), adjacency (1 B), valid (1 B) and
      weights (4 B) read once, in_c (1 B an entry) written once.
    - operations: per replica and round (a round admits one vertex, and
      one more finds none), one test per position (the first admissible)
      and one AND per vertex (its adjacency to the new member): 2 V.
    - steps: rounds, the clique's size plus one, summed over the replicas
      (`steps`) and of the largest clique (`max_steps`: the replicas run
      side by side).  Counted by running `greedy_start` (the kernel on a
      card, bit-equal to the plain version).

    Returns {"bytes", "ops", "steps", "max_steps", "bound_s",
    "bound_by"}."""
    r, v = orders.shape
    rounds = torch.sum(greedy_start(weights, adj, valid, orders, bound),
                       -1) + 1
    steps = int(rounds.sum())
    nbytes = r * v * 8 + v * v + v + v * 4 + r * v
    ops = 2 * v * steps
    return {"bytes": nbytes, "ops": ops, "steps": steps,
            "max_steps": int(rounds.max()) if r else 0,
            **_bound(nbytes, ops)}


def clique_work(masks, weights) -> dict:
    """The bytes and operations one `clique_weights` call needs: masks
    (1 B an entry) and weights (4 B) read once, the [R] scores (4 B)
    written once; one addition a member, a serial chain in each row
    (`steps` the members of all rows, `max_steps` those of the largest
    clique).  Returns {"bytes", "ops", "steps", "max_steps", "bound_s",
    "bound_by"}."""
    r, v = masks.shape
    sizes = torch.sum(masks, -1)
    nbytes = r * v + v * 4 + r * 4
    ops = int(sizes.sum())
    return {"bytes": nbytes, "ops": ops, "steps": ops,
            "max_steps": int(sizes.max()) if r else 0,
            **_bound(nbytes, ops)}


def bls_work(st, f, cfg, n: int) -> dict:
    """The bytes and operations `bls_steps(st, f, cfg, n)` needs from
    this state, and its serial steps; `st` is left as it was.

    - bytes: the fields' rows read (g_dir and g_rnd 4 B a replica and
      vertex, u_dir and u_ten 4 B a replica, per iteration), the graph
      (weights 4 B, valid 1 B, adjacency 1 B a pair) and the replicas'
      state read once and written once (in_c, best, cp 1 B and tabu 4 B
      a vertex, the ring 1 B a slot and vertex plus 4 B a score, 17 B of
      scalars).
    - operations: per iteration, replica and vertex, one AND per member
      for its neighbour count and one addition per member for its
      neighbour weight sum, plus 20 for its masks, gains and the three
      argmaxes: V (2 |C| + 20), with |C| the clique's size at that
      iteration (counted by running `bls_steps` one iteration at a time
      on a copy: the kernel on a card).
    - steps: the iterations, a serial chain (`steps` = n).

    Returns {"bytes", "ops", "steps", "bound_s", "bound_by"}."""
    r, v = st.in_c.shape
    s = st.sol_masks.shape[1]
    copy = type(st)(*[x.clone() for x in st])
    sizes = []
    for _ in range(n):
        sizes.append(torch.sum(copy.in_c, -1))
        bls_steps(copy, f, cfg, 1)
    members = int(torch.stack(sizes).sum()) if sizes else 0
    state = r * v * (3 + 4) + r * s * (v + 4) + r * 17
    nbytes = (n * r * (2 * v * 4 + 2 * 4) + v * 4 + v + v * v
              + 2 * state)
    ops = v * (2 * members + 20 * n * r)
    return {"bytes": nbytes, "ops": ops, "steps": n, **_bound(nbytes, ops)}


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def build() -> ctypes.CDLL:
    """The library of csrc/mwcp_bls.cu, built at first use (once per
    source hash) and loaded once."""
    lib, _, _ = build_library("mwcp_bls.cu")
    if lib.bls_steps_launch.argtypes is None:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.greedy_start_launch.restype = i
        lib.greedy_start_launch.argtypes = [p] * 4 + [i] * 3 + [p] * 3
        lib.greedy_scratch_words.restype = ctypes.c_longlong
        lib.greedy_scratch_words.argtypes = [i]
        lib.greedy_layout.restype = None
        lib.greedy_layout.argtypes = [i, p]
        lib.bls_steps_launch.restype = i
        lib.bls_steps_launch.argtypes = ([p] * 22 + [i] * 7 + [fl] * 3
                                         + [p])
        lib.bls_scratch_words.restype = ctypes.c_longlong
        lib.bls_scratch_words.argtypes = [i] * 3
        lib.bls_layout.restype = None
        lib.bls_layout.argtypes = [i, i, p]
        lib.clique_weight_launch.restype = i
        lib.clique_weight_launch.argtypes = [p, p, i, i, p, p]
    return lib


def greedy_layout(v: int) -> dict:
    """Where the greedy kernel keeps a V-vertex graph (see
    csrc/mwcp_bls.cu): {"tier": 0 (the packed columns and the replicas'
    orders in shared memory), 1 (the columns in device memory) or 2 (the
    orders read from device memory too), "replicas_per_block",
    "smem_bytes"}."""
    out = (ctypes.c_longlong * 3)()
    build().greedy_layout(v, out)
    return {"tier": out[0], "replicas_per_block": out[1],
            "smem_bytes": out[2]}


def greedy_scratch(v: int, device) -> torch.Tensor:
    """The greedy kernel's scratch for a V-vertex graph: the adjacency's
    columns packed as bits."""
    return torch.empty(build().greedy_scratch_words(v), dtype=torch.int32,
                       device=device)


def bls_layout(v: int, s: int) -> dict:
    """Where the BLS kernel keeps a V-vertex graph with S ring slots (see
    csrc/mwcp_bls.cu): {"tier": 0 (adjacency, state and fields in shared
    memory), 1 (the adjacency in device memory) or 2 (all in device
    memory), "replicas_per_block", "smem_bytes"}."""
    out = (ctypes.c_longlong * 3)()
    build().bls_layout(v, s, out)
    return {"tier": out[0], "replicas_per_block": out[1],
            "smem_bytes": out[2]}


def _need(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _device(fn, tensors):
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: all inputs must be on one device")
    return dev


def _check_greedy(weights, adj, valid, orders, bound):
    if orders.dim() != 2:
        raise ValueError(f"orders must be [R, V], got {tuple(orders.shape)}")
    r, v = orders.shape
    _need("orders", orders, torch.int64, (r, v))
    _need("adj", adj, torch.bool, (v, v))
    _need("valid", valid, torch.bool, (v,))
    _need("weights", weights, torch.float32, (v,))
    if not 0 <= bound <= v:
        raise ValueError(f"bound must be in [0, {v}], got {bound}")


def _launch_greedy(weights, adj, valid, orders, bound, in_c,
                   scratch) -> None:
    """Launch the greedy kernels (the adjacency's columns packed, then the
    rounds) on checked, contiguous tensors and `greedy_scratch` on the
    current stream: no count.  greedy_start's launch path, and a timing
    loop's."""
    r, v = orders.shape
    lib = build()
    with torch.cuda.device(orders.device):
        err = lib.greedy_start_launch(
            orders.data_ptr(), adj.data_ptr(), valid.data_ptr(),
            weights.data_ptr(), r, v, bound, in_c.data_ptr(),
            scratch.data_ptr(),
            torch.cuda.current_stream(orders.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"greedy_start kernel launch failed: CUDA error "
                           f"{err}")


def greedy_start(weights: torch.Tensor, adj: torch.Tensor,
                 valid: torch.Tensor, orders: torch.Tensor,
                 bound: int) -> torch.Tensor:
    """Each replica's greedy clique along its row of `orders` [R, V] int64
    (permutations putting the valid vertices first) over the first
    `bound` positions, with adj [V, V] bool, valid [V] bool and weights
    [V] float32: in_c [R, V] bool, as `greedy_start_reference`, on the
    inputs' device (the kernel on a card: any V, and any adjacency, read
    as adj[candidate][member] whether it is symmetric or not).
    `greedy_start.launches` counts kernel launches."""
    _check_greedy(weights, adj, valid, orders, bound)
    dev = _device("greedy_start", (weights, adj, valid, orders))
    if dev.type == "cpu":
        return greedy_start_reference(weights, adj, valid, orders, bound)
    r, v = orders.shape
    in_c = torch.empty((r, v), dtype=torch.bool, device=dev)
    if r and v:
        _launch_greedy(weights.contiguous(), adj.contiguous(),
                       valid.contiguous(), orders.contiguous(), bound, in_c,
                       greedy_scratch(v, dev))
        greedy_start.launches += 1
    return in_c


greedy_start.launches = 0


def _launch_clique(masks, weights, out) -> None:
    """Launch the clique-weight kernel on checked, contiguous tensors on
    the current stream: no count."""
    r, v = masks.shape
    lib = build()
    with torch.cuda.device(masks.device):
        err = lib.clique_weight_launch(
            masks.data_ptr(), weights.data_ptr(), r, v, out.data_ptr(),
            torch.cuda.current_stream(masks.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"clique_weights kernel launch failed: CUDA "
                           f"error {err}")


def clique_weights(masks: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """The weight of each row's clique, masks [R, V] bool over weights
    [V] float32: [R] float32 on their device.  On a card the members are
    added in ascending order, as the BLS kernel sums a clique, so a start
    and an iteration that hold one clique give it one score (the ring's
    duplicate test is tighter than two orders' rounding); for CPU tensors
    `clique_weights_reference`.  `clique_weights.launches` counts kernel
    launches."""
    if masks.dim() != 2:
        raise ValueError(f"masks must be [R, V], got {tuple(masks.shape)}")
    r, v = masks.shape
    _need("masks", masks, torch.bool, (r, v))
    _need("weights", weights, torch.float32, (v,))
    dev = _device("clique_weights", (masks, weights))
    if dev.type == "cpu":
        return clique_weights_reference(masks, weights)
    out = torch.empty((r,), dtype=torch.float32, device=dev)
    if r:
        _launch_clique(masks.contiguous(), weights.contiguous(), out)
        clique_weights.launches += 1
    return out


clique_weights.launches = 0

# BlsState's loop state: name, dtype, shape by (R, V, S)
_STATE = (("in_c", torch.bool, "rv"), ("tabu", torch.int32, "rv"),
          ("fbest", torch.float32, "r"), ("best", torch.bool, "rv"),
          ("cp", torch.bool, "rv"), ("wcnt", torch.int32, "r"),
          ("l_left", torch.float32, "r"),
          ("use_directed", torch.bool, "r"),
          ("sol_masks", torch.bool, "rsv"),
          ("sol_scores", torch.float32, "rs"),
          ("sol_next", torch.int64, "r"), ("it", torch.int32, "1"))


def _check_bls(st, f, n):
    if st.in_c.dim() != 2 or st.sol_masks.dim() != 3:
        raise ValueError(f"in_c must be [R, V] and sol_masks [R, S, V], "
                         f"got {tuple(st.in_c.shape)} and "
                         f"{tuple(st.sol_masks.shape)}")
    r, v = st.in_c.shape
    s = st.sol_masks.shape[1]
    dims = {"r": r, "v": v, "s": s, "1": 1}
    for name, dtype, shape in _STATE:
        _need(name, getattr(st, name), dtype, [dims[c] for c in shape])
    _need("weights", st.weights, torch.float32, (v,))
    _need("adj", st.adj, torch.bool, (v, v))
    _need("valid", st.valid, torch.bool, (v,))
    _need("l0", st.l0, torch.float32, ())
    _need("lmax", st.lmax, torch.float32, ())
    if f.g_dir.dim() != 3:
        raise ValueError(f"g_dir must be [I, R, V], got "
                         f"{tuple(f.g_dir.shape)}")
    i = f.g_dir.shape[0]
    for name in ("g_dir", "g_rnd"):
        _need(name, getattr(f, name), torch.float32, (i, r, v))
    for name in ("u_dir", "u_ten"):
        _need(name, getattr(f, name), torch.float32, (i, r))
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")


def _launch_bls(st, f, cfg, n, scratch) -> None:
    """Launch the BLS kernels (the adjacency's packing, then n iterations)
    on checked tensors on the current stream: no count, `it` not
    advanced.  bls_steps' launch path, and a timing loop's."""
    r, v = st.in_c.shape
    lib = build()
    dev = st.in_c.device
    ptrs = [x.data_ptr() for x in (
        st.weights, st.adj, st.valid, st.l0, st.lmax, st.in_c, st.tabu,
        st.fbest, st.best, st.cp, st.wcnt, st.l_left, st.use_directed,
        st.sol_masks, st.sol_scores, st.sol_next, st.it, f.u_dir, f.g_dir,
        f.u_ten, f.g_rnd, scratch)]
    with torch.cuda.device(dev):
        err = lib.bls_steps_launch(
            *ptrs, r, v, st.sol_masks.shape[1], f.g_dir.shape[0], n,
            int(cfg.t_nonimprove), int(cfg.phi), float(cfg.p0),
            float(cfg.alpha_s), float(cfg.alpha_r),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bls_steps kernel launch failed: CUDA error "
                           f"{err}")


def bls_scratch(st) -> torch.Tensor:
    """The BLS kernel's scratch for a solve state's shapes: the packed
    adjacency, and the replicas' state where it does not fit in shared
    memory."""
    r, v = st.in_c.shape
    words = build().bls_scratch_words(r, v, st.sol_masks.shape[1])
    return torch.empty(words, dtype=torch.int32, device=st.in_c.device)


def bls_steps(st, f, cfg, n: int) -> None:
    """Run `n` iterations from the solve state `st` (models/mwcp.py's
    BlsState) on the fields `f` (MwcpFields) and write the loop state back
    into its tensors, `it` advanced by n, on their device (the kernel on a
    card, reading the iteration number there; iterations past the
    fields' last row are not run).  `bls_steps.launches` counts kernel
    launches."""
    _check_bls(st, f, n)
    tensors = [getattr(st, name) for name, _, _ in _STATE] + [
        st.weights, st.adj, st.valid, st.l0, st.lmax, *f[1:]]
    dev = _device("bls_steps", tensors)
    if dev.type == "cpu":
        return bls_steps_reference(st, f, cfg, n)
    r, v = st.in_c.shape
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("bls_steps: the state and fields must be "
                         "contiguous (they are written in place)")
    if n == 0 or r == 0 or v == 0:
        return None
    _launch_bls(st, f, cfg, n, bls_scratch(st))
    st.it.add_(n)
    bls_steps.launches += 1
    return None


bls_steps.launches = 0
