"""The solver's device loops and start scores (ops/mwcp_kernel.py):
`greedy_start`, on CPU tensors its plain version, against the JAX
package's _greedy_initial run on every order row (exact, on random graphs
with ties in the weights, a -inf weight outside the graph, an adjacency
that is not symmetric, an empty valid set and bounds below V);
`bls_steps` run in pieces against one call of the whole count
(bit-equal, `it` advanced); `clique_weights`, on CPU
tensors torch.sum; the wrappers' checks; the work counts behind the
kernels' bounds against a hand count; the plain solve against the JAX
solve past the size where the BLS kernel's state leaves shared memory
(V = 4160, not a multiple of 32); a random move that drops most of the
clique in one iteration; the clique weights at V = 1, 33 and 1000 and
R = 0; and (on a card only) the CUDA kernels against
their plain versions, bit-equal on graphs whose weights are integers
(every sum exact in any order) at V from 64 to 8192, the clique weights
bit-equal to an ascending float32 sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.config import SolverConfig as JaxSolverConfig
from mcmtt_opticalflow_tpu.models import mwcp as jax_mwcp
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.models import mwcp
from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel
from mcmtt_opticalflow_tpu_torch.ops.mwcp_kernel import (
    bls_steps, bls_steps_reference, bls_work, clique_weights,
    clique_weights_reference, clique_work, greedy_layout, greedy_start,
    greedy_start_reference, greedy_work)
from mcmtt_opticalflow_tpu_torch.utils import prng
from torch_parity import (cuda_device, jax_mwcp_fields,  # noqa: F401
                          to_torch_fields)

torch.set_num_threads(2)

NEG = mwcp.NEG
_jax_greedy = jax.jit(jax.vmap(jax_mwcp._greedy_initial,
                               in_axes=(None, None, None, 0)))


def _graph(seed, v, n, dens=0.6, ties=False, inf_outside=True,
           integer=False, sym=True):
    """Weights [v] (few distinct values with `ties`, integers with
    `integer`, -inf at one vertex outside the graph with
    `inf_outside`), an adjacency with a False diagonal (symmetric unless
    `sym` is False), valid vertices among the first n (about 80%); numpy
    arrays."""
    rng = np.random.RandomState(seed)
    w = rng.rand(v) * 10
    if ties:
        w = rng.choice([0.0, 1.5, 2.0, 4.0], v)
    if integer:
        w = np.floor(w * 3)
    w = w.astype(np.float32)
    up = np.triu(rng.rand(v, v) < dens, 1)
    adj = up | up.T
    if not sym:
        adj = (rng.rand(v, v) < dens) & ~np.eye(v, dtype=bool)
    valid = (np.arange(v) < n) & (rng.rand(v) < 0.8)
    if inf_outside and n + 2 < v:
        w[n + 2] = -np.inf
    adj[:, ~valid] = adj[~valid, :] = False
    return w, adj, valid


def _orders(w, valid, r, seed):
    """The engine's replica orders (models/mwcp.py::bls_start): the
    weights plus scaled noise (none for row 0), valid vertices first,
    stable ties."""
    rng = np.random.RandomState(100 + seed)
    fin = np.abs(w[np.isfinite(w)])
    scale = max(float(fin.max()) if fin.size else 1.0, 1.0)
    noise = (rng.rand(r, len(w)) * scale * 0.3).astype(np.float32)
    noise[0] = 0.0
    key = -np.where(valid, w[None] + noise, np.float32(NEG))
    return np.argsort(key, axis=-1, kind="stable")


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


GREEDY_CASES = {
    "v64": dict(seed=0, v=64, n=60),
    "v256": dict(seed=1, v=256, n=200, dens=0.7),
    "v1000": dict(seed=2, v=1000, n=700, dens=0.9),
    "ties": dict(seed=3, v=256, n=230, ties=True),
    "no_inf": dict(seed=4, v=64, n=50, inf_outside=False),
    "dense": dict(seed=5, v=96, n=96, dens=0.97),
    # adj[candidate][member] read, as the JAX loop reads it
    "asymmetric": dict(seed=7, v=160, n=150, dens=0.8, sym=False),
}


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_start_equals_jax(case):
    kw = GREEDY_CASES[case]
    w, adj, valid = _graph(**kw)
    r, v = 6, len(w)
    orders = _orders(w, valid, r, kw["seed"])
    want = np.asarray(_jax_greedy(jnp.asarray(w), jnp.asarray(adj),
                                  jnp.asarray(valid),
                                  jnp.asarray(orders.astype(np.int32))))
    assert want.any()
    wt, at, vt, ot = _t(w, adj, valid, orders)
    nvalid = int(valid.sum())
    for bound in (nvalid, (nvalid + v) // 2, v):
        got = greedy_start(wt, at, vt, ot, bound)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(bound))
        assert torch.equal(greedy_start_reference(wt, at, vt, ot, bound),
                           got)
    assert greedy_start.launches == 0          # CPU tensors: no kernel


def test_greedy_start_empty_valid_set():
    w, adj, valid = _graph(6, 64, 60)
    valid[:] = False
    orders = _orders(w, valid, 4, 6)
    want = np.asarray(_jax_greedy(jnp.asarray(w), jnp.asarray(adj),
                                  jnp.asarray(valid),
                                  jnp.asarray(orders.astype(np.int32))))
    for bound in (0, 64):
        got = greedy_start(*_t(w, adj, valid, orders), bound)
        assert not got.any() and not want.any()


def _state(seed, v=96, n=80, r=6, iters=120, integer=False):
    w, adj, valid = _graph(seed, v, n, integer=integer)
    init = np.zeros((3, v), bool)
    a = np.flatnonzero(valid)[0]
    init[0, [a, np.flatnonzero(adj[a])[0]]] = True
    cfg = tcfg.SolverConfig(num_replicas=r, max_vertices=v,
                            solutions_per_replica=8)
    f = mwcp.threefry_fields(prng.prng_key(seed), r, v, iters, "cpu")
    wt, at, vt, it_ = _t(w, adj, valid, init)
    st = mwcp.bls_start(wt, at, vt, it_, f, cfg, n + 2)
    return st, f, cfg


def _clone(st):
    return type(st)(*[x.clone() for x in st])


@pytest.mark.parametrize("seed", [0, 1])
def test_bls_steps_in_pieces_equal_one_call(seed):
    """1 + 7 + 50 + the rest iterations, as the captured program's blocks
    split a solve, against one call of the whole count."""
    iters = 120
    st, f, cfg = _state(seed, iters=iters)
    whole = _clone(st)
    bls_steps(whole, f, cfg, iters)
    assert int(whole.it) == iters
    for n in (1, 7, 50, iters - 58):
        before = int(st.it)
        bls_steps(st, f, cfg, n)
        assert int(st.it) == before + n
    for name, a, b in zip(st._fields, st, whole):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert (whole.tabu != 0).any()            # vertices have left C
    assert bls_steps.launches == 0
    assert mwcp.bls_steps is bls_steps        # the solver's own name


def test_bls_steps_zero_iterations_change_nothing():
    st, f, cfg = _state(2, iters=10)
    before = _clone(st)
    bls_steps(st, f, cfg, 0)
    for a, b in zip(st, before):
        assert torch.equal(a, b)


def test_clique_weights_on_cpu_are_the_plain_version():
    """On CPU tensors the plain version, torch.sum (the start score that
    the solve parity tests hold to the JAX solve), equal to the float64
    sums within float32 rounding, for random masks, an empty one and a
    -inf weight outside every mask."""
    w, _, valid = _graph(7, 96, 80)
    masks = np.random.RandomState(7).rand(9, 96) < 0.3
    masks &= valid[None]
    masks[0] = False
    got = clique_weights(*_t(masks, w))
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.sum(torch.where(
        torch.from_numpy(masks), torch.from_numpy(w), 0.0), -1))
    assert torch.equal(clique_weights_reference(*_t(masks, w)), got)
    want = np.where(masks, w.astype(np.float64), 0.0).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[0] == 0.0 and clique_weights.launches == 0


# (R, V): one vertex, V not a multiple of 16 or 32, no rows
CLIQUE_SHAPES = [(4, 1), (6, 33), (5, 1000), (0, 64)]


def _ascending(masks, w):
    """Each row's members' weights added in ascending order from 0 in
    float32, as the kernel sums them."""
    out = np.zeros(masks.shape[0], np.float32)
    for i, row in enumerate(masks):
        for c in np.flatnonzero(row):
            out[i] = np.float32(out[i] + w[c])
    return out


def _clique_case(r, v):
    rng = np.random.RandomState(r * 1000 + v)
    w = (rng.randn(v) * 50).astype(np.float32)
    return rng.rand(r, v) < 0.3, w


@pytest.mark.parametrize("r,v", CLIQUE_SHAPES)
def test_clique_weights_on_cpu_at_any_shape(r, v):
    """On CPU tensors torch.sum(torch.where()), within float32 rounding of
    the ascending sum, an [R] float32 result even for R = 0 or V = 1."""
    masks, w = _clique_case(r, v)
    got = clique_weights(*_t(masks, w))
    assert got.dtype == torch.float32 and got.shape == (r,)
    assert torch.equal(got, clique_weights_reference(*_t(masks, w)))
    np.testing.assert_allclose(got.numpy(), _ascending(masks, w),
                               rtol=1e-5, atol=1e-4)
    assert clique_weights.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("r,v", CLIQUE_SHAPES)
def test_cuda_clique_weights_at_any_shape(cuda_device, r, v):
    """The kernel at the same shapes: the ascending float32 sum bit for
    bit, one launch where there are rows."""
    masks, w = _clique_case(r, v)
    launches = clique_weights.launches
    got = clique_weights(*[t.to(cuda_device) for t in _t(masks, w)])
    assert clique_weights.launches == launches + (r > 0)
    np.testing.assert_array_equal(got.cpu().numpy(), _ascending(masks, w))


def test_clique_weights_rejects_bad_inputs():
    masks, w = _t(np.ones((3, 8), bool), np.ones(8, np.float32))
    with pytest.raises(ValueError, match="masks"):
        clique_weights(masks[0], w)
    with pytest.raises(ValueError, match="masks"):
        clique_weights(masks.to(torch.uint8), w)
    with pytest.raises(ValueError, match="weights"):
        clique_weights(masks, w[:4])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        clique_weights(masks.to("meta"), w.to("meta"))


def test_clique_work_hand_count():
    masks = np.zeros((3, 8), bool)
    masks[0, :5] = True
    masks[2, [1, 6]] = True
    work = clique_work(*_t(masks, np.ones(8, np.float32)))
    assert work["ops"] == work["steps"] == 7 and work["max_steps"] == 5
    assert work["bytes"] == 3 * 8 + 8 * 4 + 3 * 4


def test_greedy_start_rejects_bad_inputs():
    w, adj, valid = _t(*_graph(0, 16, 14))
    orders = torch.argsort(-w).expand(3, 16).contiguous()
    with pytest.raises(ValueError, match="orders"):
        greedy_start(w, adj, valid, orders[0], 16)
    with pytest.raises(ValueError, match="orders"):
        greedy_start(w, adj, valid, orders.to(torch.int32), 16)
    with pytest.raises(ValueError, match="weights"):
        greedy_start(w.double(), adj, valid, orders, 16)
    with pytest.raises(ValueError, match="adj"):
        greedy_start(w, adj[:8], valid, orders, 16)
    with pytest.raises(ValueError, match="valid"):
        greedy_start(w, adj, valid.to(torch.uint8), orders, 16)
    with pytest.raises(ValueError, match="bound"):
        greedy_start(w, adj, valid, orders, 17)
    meta = [x.to("meta") for x in (w, adj, valid, orders)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        greedy_start(*meta, 16)


def test_bls_steps_rejects_bad_inputs():
    st, f, cfg = _state(0, v=32, n=28, r=4, iters=8)
    with pytest.raises(ValueError, match="tabu"):
        bls_steps(st._replace(tabu=st.tabu.long()), f, cfg, 1)
    with pytest.raises(ValueError, match="sol_scores"):
        bls_steps(st._replace(sol_scores=st.sol_scores[:, :3]), f, cfg, 1)
    with pytest.raises(ValueError, match="adj"):
        bls_steps(st._replace(adj=st.adj.float()), f, cfg, 1)
    with pytest.raises(ValueError, match="g_rnd"):
        bls_steps(st, f._replace(g_rnd=f.g_rnd[:, :2]), cfg, 1)
    with pytest.raises(ValueError, match="u_ten"):
        bls_steps(st, f._replace(u_ten=f.u_ten.double()), cfg, 1)
    with pytest.raises(ValueError, match="n must be"):
        bls_steps(st, f, cfg, -1)
    meta = type(st)(*[x.to("meta") for x in st])
    fmeta = type(f)(*[x.to("meta") for x in f])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bls_steps(meta, fmeta, cfg, 1)


def test_greedy_work_hand_count():
    """A triangle {0, 1, 2} and a valid isolated vertex 3, weights in
    order: every replica admits the triangle and finds no fourth, so 4
    rounds a replica."""
    adj = np.zeros((4, 4), bool)
    for a, b in ((0, 1), (1, 2), (0, 2)):
        adj[a, b] = adj[b, a] = True
    w = np.array([3.0, 2.0, 1.0, 0.5], np.float32)
    valid = np.ones(4, bool)
    orders = np.array([[0, 1, 2, 3], [0, 1, 2, 3]])
    work = greedy_work(*_t(w, adj, valid, orders), 4)
    assert work["steps"] == 8 and work["max_steps"] == 4
    assert work["bytes"] == 2 * 4 * 8 + 16 + 4 + 16 + 2 * 4
    assert work["ops"] == 2 * 4 * 8
    assert work["bound_by"] == "bytes"
    assert work["bound_s"] == pytest.approx(work["bytes"] / 3.35e12)


def test_bls_work_hand_count():
    """Two adjacent valid vertices and u_dir = 1 (never directed): every
    replica holds the clique {0, 1} at every iteration (no free vertex to
    move to), so the members counted are 2 a replica and iteration."""
    v, r, n, s = 2, 2, 5, 16
    w = torch.tensor([1.0, 2.0])
    adj = torch.tensor([[False, True], [True, False]])
    valid = torch.ones(2, dtype=torch.bool)
    cfg = tcfg.SolverConfig(num_replicas=r, max_vertices=v,
                            solutions_per_replica=s)
    f = mwcp.threefry_fields(prng.prng_key(0), r, v, n, "cpu")
    f = f._replace(u_dir=torch.ones_like(f.u_dir))
    st = mwcp.bls_start(w, adj, valid, torch.zeros((1, v), dtype=torch.bool),
                        f, cfg, v)
    before = _clone(st)
    work = bls_work(st, f, cfg, n)
    for a, b in zip(st, before):               # the state is left as it was
        assert torch.equal(a, b)
    members = n * r * 2
    state = r * v * 7 + r * s * (v + 4) + r * 17
    assert work["steps"] == n
    assert work["ops"] == v * (2 * members + 20 * n * r)
    assert work["bytes"] == (n * r * (2 * v * 4 + 8) + v * 4 + v + v * v
                             + 2 * state)
    bls_steps(st, f, cfg, n)
    assert st.in_c.all()


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions(cuda_device):
    """Both kernels against their plain versions on the card, on graphs
    with integer weights (every sum exact whatever its order), at V from
    64 to 8192: the adjacency in shared memory up to ~1200 vertices, in
    device memory above, and the replicas' state there too past ~5000
    (4160 is no multiple of 32, 8192 twice the old kernel's limit)."""
    mwcp_kernel.build()
    for seed, (v, n) in enumerate([(64, 60), (256, 220), (1024, 700),
                                   (2048, 1400), (4160, 4100),
                                   (8192, 8000)]):
        st, f, cfg = _state(seed, v=v, n=n, r=10, iters=100, integer=True)
        st = type(st)(*[x.to(cuda_device) for x in st])
        f = type(f)(*[x.to(cuda_device) for x in f])
        orders = torch.argsort(-torch.where(st.valid, st.weights, NEG),
                               dim=-1, stable=True).expand(10, v)
        orders = orders.contiguous()
        launches = greedy_start.launches
        got = greedy_start(st.weights, st.adj, st.valid, orders, n + 2)
        assert greedy_start.launches == launches + 1
        assert torch.equal(got, greedy_start_reference(
            st.weights, st.adj, st.valid, orders, n + 2))
        ref = _clone(st)
        launches = bls_steps.launches
        bls_steps(st, f, cfg, 37)
        bls_steps(st, f, cfg, 63)
        assert bls_steps.launches == launches + 2
        bls_steps_reference(ref, f, cfg, 100)
        for name, a, b in zip(st._fields, st, ref):
            assert torch.equal(a, b), (v, name)


@pytest.mark.cuda
def test_cuda_greedy_start_any_size_and_asymmetric(cuda_device):
    """The greedy kernel against its plain version in each of its layouts
    (`greedy_layout`): past the 6 V bytes of shared memory a block-wide
    layout would ask for (V = 40000, 256 valid vertices, bound 256: tier
    2, the orders read from device memory too), V = 6144 (tier 1, the
    columns in device memory), V = 1100 (tier 0 past the register bit
    sets), V = 1024 and 160 (tier 0, registers), and on an adjacency that
    is not symmetric (the packed columns hold adj[candidate][member] as
    the plain version reads it)."""
    mwcp_kernel.build()
    for seed, (v, n, dens, sym, bound, tier) in enumerate([
            (40000, 256, 0.8, True, 256, 2),
            (1024, 900, 0.8, False, 1024, 0),
            (160, 150, 0.8, False, 160, 0),
            (6144, 1500, 0.8, True, 1500, 1),
            (1100, 1000, 0.8, False, 1100, 0)]):
        assert greedy_layout(v)["tier"] == tier
        rng = np.random.RandomState(seed)
        w = torch.tensor(np.floor(rng.rand(v) * 30), dtype=torch.float32,
                         device=cuda_device)
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        adj = torch.rand((v, v), generator=g, device=cuda_device) < dens
        if sym:
            adj = torch.triu(adj, 1)
            adj |= adj.T.clone()
        valid = torch.zeros(v, dtype=torch.bool, device=cuda_device)
        valid[torch.tensor(rng.permutation(v)[:n], device=cuda_device)] = True
        orders = torch.argsort(-torch.where(valid, w, NEG), dim=-1,
                               stable=True).expand(6, v).contiguous()
        launches = greedy_start.launches
        got = greedy_start(w, adj, valid, orders, bound)
        assert greedy_start.launches == launches + 1
        assert torch.equal(got, greedy_start_reference(w, adj, valid,
                                                       orders, bound))
        del adj


def _drop_state(r=4, v=48, iters=40):
    """A clique of 8 (vertices 0-7) and 40 free vertices adjacent to vertex
    0 only, integer weights, every replica perturbing (l_left = 5) with
    directed moves ruled out (u_dir = 1, use_directed False): the first
    iteration's random move keeps vertex 0 and the pick, and drops the
    other 7 members."""
    adj = np.zeros((v, v), bool)
    adj[:8, :8] = True
    adj[0, 8:] = adj[8:, 0] = True
    np.fill_diagonal(adj, False)
    w = np.where(np.arange(v) < 8, 3.0, 1.0).astype(np.float32)
    cfg = tcfg.SolverConfig(num_replicas=r, max_vertices=v,
                            solutions_per_replica=8)
    f = mwcp.threefry_fields(prng.prng_key(5), r, v, iters, "cpu")
    f = f._replace(u_dir=torch.ones_like(f.u_dir))
    in_c = torch.zeros((r, v), dtype=torch.bool)
    in_c[:, :8] = True
    st = mwcp.BlsState(
        weights=torch.from_numpy(w), adj=torch.from_numpy(adj),
        valid=torch.ones(v, dtype=torch.bool), l0=torch.tensor(1.0),
        lmax=torch.tensor(4.0), in_c=in_c,
        tabu=torch.zeros((r, v), dtype=torch.int32),
        fbest=torch.full((r,), 24.0), best=in_c.clone(), cp=in_c.clone(),
        wcnt=torch.zeros(r, dtype=torch.int32), l_left=torch.full((r,), 5.0),
        use_directed=torch.zeros(r, dtype=torch.bool),
        sol_masks=torch.zeros((r, 8, v), dtype=torch.bool),
        sol_scores=torch.full((r, 8), NEG),
        sol_next=torch.zeros(r, dtype=torch.int64),
        it=torch.zeros(1, dtype=torch.int32))
    return st, f, cfg


def test_random_move_drops_most_of_the_clique():
    """The plain version on _drop_state: one iteration leaves vertex 0 and
    one of the free vertices, the 7 others stamped tabu."""
    st, f, cfg = _drop_state()
    bls_steps(st, f, cfg, 1)
    assert torch.equal(st.in_c.sum(-1), torch.full((4,), 2))
    assert st.in_c[:, 0].all() and not st.in_c[:, 1:8].any()
    assert (st.tabu[:, 1:8] > 0).all() and (st.tabu[:, 8:] == 0).all()
    bls_steps(st, f, cfg, 39)               # and on from there
    assert int(st.it) == 40


def test_plain_solve_equals_jax_past_shared_memory():
    """The port's solve (plain version) against the JAX solve_mwcp at V =
    4160 (n = 4100 valid, R = 4, S = 8, 20 iterations) on the JAX fields:
    the size at which the BLS kernel keeps its adjacency in device memory
    and which the kernel before it refused.  Masks equal, scores within
    1e-4, as test_torch_ops.py::test_mwcp_with_jax_fields."""
    rng = np.random.RandomState(11)
    v, n, iters = 4160, 4100, 20
    w = np.zeros(v, np.float32)
    w[:n] = rng.rand(n).astype(np.float32) * 10
    up = np.triu(rng.rand(v, v) < 0.45, 1)
    adj = up | up.T
    adj[n:] = False
    adj[:, n:] = False
    valid = np.arange(v) < n
    init = np.zeros((3, v), bool)         # a clique, a non-clique, empty
    init[0, 0] = True
    for u in range(1, n):
        if adj[u, init[0]].all():
            init[0, u] = True
    init[1, :5] = True
    cfg = tcfg.SolverConfig(num_replicas=4, max_vertices=v,
                            solutions_per_replica=8, seed=11)
    jcfg = JaxSolverConfig(num_replicas=4, max_vertices=v,
                           solutions_per_replica=8, seed=11)
    key = jax.random.PRNGKey(211)
    ref = jax_mwcp.solve_mwcp(jnp.asarray(w), jnp.asarray(adj),
                              jnp.asarray(valid), jnp.asarray(init), key,
                              jcfg, iters)
    fields = to_torch_fields(jax_mwcp_fields(key, 4, v, iters))

    class Fixed:
        def draw(self, r, v_, iters_pad, device):
            assert (r, v_, iters_pad) == (4, v, iters)
            return fields

    got = mwcp.solve_mwcp(*_t(w, adj, valid, init), Fixed(), cfg, iters)
    assert init[0].sum() > 3 and np.asarray(ref.best_score).min() > 0
    np.testing.assert_array_equal(got.best_mask.numpy(),
                                  np.asarray(ref.best_mask))
    np.testing.assert_array_equal(got.sol_masks.numpy(),
                                  np.asarray(ref.sol_masks))
    np.testing.assert_allclose(got.best_score.numpy(),
                               np.asarray(ref.best_score), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(got.sol_scores.numpy(),
                               np.asarray(ref.sol_scores), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_random_move_drops_most_of_the_clique(cuda_device):
    """The BLS kernel against its plain version on _drop_state, after the
    first iteration (7 of 8 members dropped at once: the kernel counts its
    neighbour state anew) and after 39 more."""
    ref, f_cpu, cfg = _drop_state()
    st = type(ref)(*[x.to(cuda_device) for x in ref])
    f = type(f_cpu)(*[x.to(cuda_device) for x in f_cpu])
    for n in (1, 39):
        launches = bls_steps.launches
        bls_steps(st, f, cfg, n)
        assert bls_steps.launches == launches + 1
        bls_steps_reference(ref, f_cpu, cfg, n)
        for name, a, b in zip(st._fields, st, ref):
            assert torch.equal(a.cpu(), b), (n, name)
    assert int(st.in_c.sum()) < 4 * 8


@pytest.mark.cuda
def test_cuda_clique_weights_sum_members_ascending(cuda_device):
    """The clique-weight kernel against an ascending float32 sum, bit for
    bit, and its plain version within the two orders' rounding."""
    rng = np.random.RandomState(3)
    for r, v in ((5, 64), (38, 1024), (7, 1000)):
        w = (rng.rand(v) * 50).astype(np.float32)
        masks = rng.rand(r, v) < 0.1
        want = np.zeros(r, np.float32)
        for i in range(r):
            for c in np.flatnonzero(masks[i]):
                want[i] = np.float32(want[i] + w[c])
        launches = clique_weights.launches
        got = clique_weights(*[t.to(cuda_device) for t in _t(masks, w)])
        assert clique_weights.launches == launches + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        np.testing.assert_allclose(
            got.cpu().numpy(), clique_weights_reference(*_t(masks, w)),
            rtol=1e-5)
