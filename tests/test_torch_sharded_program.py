"""The sharded solve as captured per-block programs
(parallel/solver_parallel.py: `solve_mwcp_sharded` runs one
`BlockProgram` per block, the counterpart of the JAX package's one
shard_map program), on the CPU, where the same parts run eagerly from
the same static buffers:

- it equals the eager per-block `solve_mwcp` calls
  (`_solve_mwcp_sharded_eager`) bit for bit: the global best's mask and
  score, and the mask and score of every replica of every block, with
  warm starts and with an iteration count that leaves a rest block;
- it equals the JAX `solve_mwcp_sharded` on the conftest's 8-CPU mesh
  (masks equal, scores within 1e-4, as
  tests/test_torch_parallel.py::TestShardedSolver does);
- a second call with other inputs of the same shape reuses the programs
  (none built) and follows its inputs, and going back to the first
  inputs gives the first result: no stale buffer;
- a field source per block equals a key per block with the same fields;
- the programs' parts read nothing on the host (what a capture on the
  card would refuse).

On the card the `cuda` case covers the same ground; chip_smoke.py's mesh
phase is its check there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.config import SolverConfig as JaxSolverConfig
from mcmtt_opticalflow_tpu.parallel import make_mesh as jax_make_mesh
from mcmtt_opticalflow_tpu.parallel import \
    solve_mwcp_sharded as jax_solve_sharded
from mcmtt_opticalflow_tpu_torch.config import SolverConfig
from mcmtt_opticalflow_tpu_torch.models.mwcp import iters_padded
from mcmtt_opticalflow_tpu_torch.ops.threefry_kernel import \
    threefry_fields_reference
from mcmtt_opticalflow_tpu_torch.parallel import make_mesh, solver_parallel
from mcmtt_opticalflow_tpu_torch.parallel.solver_parallel import (
    BLOCK, _solve_mwcp_sharded_eager, solve_mwcp_sharded)
from mcmtt_opticalflow_tpu_torch.utils import prng
from torch_parity import cuda_device, jax_mwcp_fields  # noqa: F401
from torch_parity import to_torch_fields

torch.set_num_threads(2)

CFG = SolverConfig(num_replicas=3, max_vertices=40, solutions_per_replica=4)
ITERS = 2 * BLOCK + 17          # two captured blocks and a rest block


def _instance(v=40, seed=0, warm_rows=2):
    """A random graph, every vertex valid, and `warm_rows` warm starts:
    row 0 a clique (greedy by index), row 1 not one."""
    rng = np.random.RandomState(seed)
    weights = rng.rand(v).astype(np.float32)
    up = np.triu(rng.rand(v, v) < 0.6, 1)
    adj = up | up.T
    init = np.zeros((warm_rows, v), bool)
    clique = []
    for u in range(v):
        if all(adj[u, c] for c in clique):
            clique.append(u)
    init[0, clique] = True
    if warm_rows > 1:
        init[1, :3] = True
    return [torch.from_numpy(x) for x in (weights, adj, np.ones(v, bool),
                                          init)]


def _same(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g, w)


def _mesh(blocks=3):
    return make_mesh(num_cam_shards=1, devices=["cpu"] * blocks)


def _programs_of(mesh, ins, cfg=CFG, iters=ITERS):
    ip = iters_padded(cfg, iters)
    return {k: p for k, p in solver_parallel.programs.items()
            if k[2:] == (ins[0].shape[0], cfg.num_replicas,
                         tuple(ins[3].shape), ip, cfg)}


@pytest.mark.parametrize("warm_rows", [0, 2])
def test_program_equals_eager_per_block(warm_rows):
    ins = _instance(warm_rows=max(warm_rows, 1))
    if not warm_rows:                   # no warm start: one [V] row
        ins[3] = torch.zeros(40, dtype=torch.bool)
    mesh = _mesh()
    key = prng.prng_key(7)
    got = solve_mwcp_sharded(*ins, key, mesh, CFG, iters=ITERS)
    _same(got, _solve_mwcp_sharded_eager(*ins, key, mesh, CFG, iters=ITERS))
    assert got[2].shape == (9, 40)
    progs = _programs_of(mesh, ins)
    assert sorted(k[0] for k in progs) == [0, 1, 2]
    for p in progs.values():
        assert p.blocks == 2 and p.rest is not None
        assert len(p.parts()) == 5


@pytest.mark.parametrize("form", ["captured", "eager"])
def test_matches_jax_on_8_cpu_mesh(form):
    """cam 4 x block 2, V=40, R=3, with warm starts; block b draws the
    fields of jax.random.split(key, 2)[b], as the JAX shard does."""
    jmesh = jax_make_mesh()
    cfg = SolverConfig(num_replicas=3, max_vertices=40,
                       solutions_per_replica=4)
    jcfg = JaxSolverConfig(num_replicas=3, max_vertices=40,
                           solutions_per_replica=4)
    ins = _instance(seed=3)
    key = jax.random.PRNGKey(4)
    ref = jax_solve_sharded(*[jnp.asarray(x.numpy()) for x in ins], key,
                            jmesh, jcfg, iters=ITERS)

    class Fixed:
        def __init__(self, fields):
            self.fields = fields

        def draw(self, r, v, iters_pad, device):
            return to_torch_fields(self.fields, device)
    fields = [Fixed(jax_mwcp_fields(k, 3, 40, ITERS))
              for k in jax.random.split(key, 2)]
    solve = solve_mwcp_sharded if form == "captured" else \
        _solve_mwcp_sharded_eager
    got = solve(*ins, fields, make_mesh(devices=["cpu"] * 8), cfg,
                iters=ITERS)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(float(got[1]), float(ref[1]), atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]),
                               atol=1e-4)
    assert got[2].shape == (6, 40)


def test_second_call_reuses_the_programs_and_follows_its_inputs():
    mesh = _mesh(2)
    a, b = _instance(seed=5), _instance(seed=6)
    ka, kb = prng.prng_key(1), prng.prng_key(2)
    first = solve_mwcp_sharded(*a, ka, mesh, CFG, iters=ITERS)
    made = dict(_programs_of(mesh, a))
    n = len(solver_parallel.programs)
    second = solve_mwcp_sharded(*b, kb, mesh, CFG, iters=ITERS)
    assert len(solver_parallel.programs) == n
    assert _programs_of(mesh, b) == made
    _same(second, _solve_mwcp_sharded_eager(*b, kb, mesh, CFG, iters=ITERS))
    assert not torch.equal(second[2], first[2])
    again = solve_mwcp_sharded(*a, ka, mesh, CFG, iters=ITERS)
    _same(again, first)
    # another key on the same graph: the draw follows the key buffer
    other = solve_mwcp_sharded(*a, kb, mesh, CFG, iters=ITERS)
    _same(other, _solve_mwcp_sharded_eager(*a, kb, mesh, CFG, iters=ITERS))
    assert len(solver_parallel.programs) == n


def test_field_source_equals_key():
    mesh = _mesh(2)
    ins = _instance(seed=8)
    key = prng.prng_key(9)
    ip = iters_padded(CFG, ITERS)

    class Drawn:
        def __init__(self, k):
            self.k = k

        def draw(self, r, v, iters_pad, device):
            assert (r, v, iters_pad) == (3, 40, ip)
            return threefry_fields_reference(self.k.to(device), r, v,
                                             iters_pad)
    sources = [Drawn(k) for k in prng.split(key, 2)]
    _same(solve_mwcp_sharded(*ins, sources, mesh, CFG, iters=ITERS),
          solve_mwcp_sharded(*ins, key, mesh, CFG, iters=ITERS))


def test_parts_read_nothing_on_the_host(monkeypatch):
    """Every part of a block program runs with the host reads of device
    values patched to raise."""
    mesh = _mesh(2)
    ins = _instance(seed=10)
    solve_mwcp_sharded(*ins, prng.prng_key(3), mesh, CFG, iters=ITERS)
    progs = list(_programs_of(mesh, ins).values())

    def refuse(*a, **k):
        raise AssertionError("host read of a device value")
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for p in progs:
        p.draw()
        p.head()
        for _ in range(p.blocks):
            p.block()
        p.rest()
        p.tail()


def test_wrong_number_of_keys_raises():
    mesh = _mesh(3)
    ins = _instance()
    with pytest.raises(ValueError, match="3 blocks need"):
        solve_mwcp_sharded(*ins, [prng.prng_key(1)] * 2, mesh, CFG,
                           iters=ITERS)


@pytest.mark.cuda
def test_cuda_programs_equal_eager_per_block(cuda_device):
    """Two blocks on one card: the captured programs equal the eager
    per-block solves, and a second call replays them."""
    mesh = make_mesh(num_cam_shards=1, devices=[cuda_device] * 2)
    ins = [x.to(cuda_device) for x in _instance(seed=11)]
    key = prng.prng_key(12).to(cuda_device)
    got = solve_mwcp_sharded(*ins, key, mesh, CFG, iters=ITERS)
    _same(got, _solve_mwcp_sharded_eager(*ins, key, mesh, CFG, iters=ITERS))
    progs = list(_programs_of(mesh, ins).values())
    replays = [p.head.n_replays for p in progs]
    solve_mwcp_sharded(*ins, key, mesh, CFG, iters=ITERS)
    assert [p.head.n_replays for p in progs] == [r + 1 for r in replays]
