"""The port's single-process mesh: the ('cam', 'block') mesh over torch
devices (one device may repeat, as the JAX tests' 8 virtual CPU devices),
its split / replicate placements and fetches, `solve_mwcp_sharded`
against the JAX function on the conftest's 8-CPU mesh, and the engine on
a ["cpu"] * 8 mesh against the engine without one (the scene of
tests/test_parallel.py::TestEngineOnMesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.config import SolverConfig as JaxSolverConfig
from mcmtt_opticalflow_tpu.parallel import make_mesh as jax_make_mesh
from mcmtt_opticalflow_tpu.parallel import \
    solve_mwcp_sharded as jax_solve_sharded
from mcmtt_opticalflow_tpu_torch.config import (EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models.mwcp import ThreefryFields, solve_mwcp
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.parallel import (block_sharding,
                                                  cam_sharding, make_mesh,
                                                  replicated,
                                                  solve_mwcp_sharded)
from mcmtt_opticalflow_tpu_torch.models.associator3d import Associator3D
from mcmtt_opticalflow_tpu_torch.parallel.mesh import (AsyncFetch, Shards,
                                                       device_sharding, fetch,
                                                       join, shard_leaves)
from mcmtt_opticalflow_tpu_torch.utils import prng
from mcmtt_opticalflow_tpu_torch.utils.tree import tree_leaves, tree_map
from torch_parity import jax_mwcp_fields, to_torch_fields

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


class TestMesh:
    def test_mesh_shape(self):
        mesh = make_mesh(devices=CPU8)
        assert mesh.shape == {"cam": 4, "block": 2} == dict(
            jax_make_mesh().shape)
        assert mesh.size == 8
        assert make_mesh(num_cam_shards=2, devices=CPU8).shape == {
            "cam": 2, "block": 4}
        assert make_mesh(devices=["cpu"] * 6).shape == {"cam": 2, "block": 3}

    def test_no_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh()

    def test_placements(self):
        mesh = make_mesh(devices=CPU8)
        x = torch.arange(4 * 6).reshape(4, 6)
        parts = cam_sharding(mesh).place(x)
        assert len(parts) == 4 and all(p.shape == (1, 6) for p in parts)
        assert torch.equal(torch.cat(parts), x)
        parts = block_sharding(mesh).place(x)
        assert len(parts) == 2 and parts[1].shape == (2, 6)
        assert len(replicated(mesh).place(x)) == 8
        with pytest.raises(ValueError, match="does not split"):
            cam_sharding(mesh).place(torch.zeros(6))
        tree = (x, (x[:, :2], torch.tensor(3)))
        groups = shard_leaves(tree, cam_sharding(mesh))
        assert len(groups) == 4
        assert groups[2][1][0].shape == (1, 2)
        assert int(groups[3][1][1]) == 3          # 0-d: copied to each group

    def test_fetch(self):
        tree = (torch.arange(3), (torch.ones(2, 2), torch.tensor(True)))
        for out in (fetch(tree), AsyncFetch(tree).get()):
            assert isinstance(out[1][0], np.ndarray)
            np.testing.assert_array_equal(out[0], [0, 1, 2])
            assert bool(out[1][1])

    def test_split_over_every_device(self):
        """The counterpart of P(("cam", "block")): one slice per device in
        flat order, whole again after a fetch or a join (no collective
        in one process)."""
        mesh = make_mesh(devices=CPU8)
        x = torch.arange(16 * 3).reshape(16, 3)
        s = device_sharding(mesh).split(x)
        assert isinstance(s, Shards) and not s.remote
        assert [p.shape for p in s.parts] == [(2, 3)] * 8
        np.testing.assert_array_equal(fetch((s, x))[0], x.numpy())
        assert torch.equal(join(s, "cpu"), x)

    def test_owners(self):
        """A mesh over two processes (as seen by process 1): each group
        belongs to the process that owns its device; blocks spread over
        the processes; other processes' slices are None."""
        owners = [0] * 4 + [1] * 4
        devs = [f"cpu:{i}" for i in range(8)]
        mesh = make_mesh(devices=devs, owners=owners, process_index=1)
        assert mesh.processes == [0, 1] and str(mesh.home) == "cpu:4"
        assert cam_sharding(mesh).owners == [0, 0, 1, 1]
        blocks = block_sharding(mesh)
        assert blocks.owners == [0, 1] and blocks.local == [False, True]
        assert [str(d) for d in blocks.devices] == ["cpu:0", "cpu:5"]
        s = device_sharding(mesh).split(torch.arange(8))
        assert s.remote and [p is None for p in s.parts] == [True] * 4 + [
            False] * 4
        assert shard_leaves((torch.zeros(4),), cam_sharding(mesh))[:2] == [
            None, None]
        for shape, want in ((2, [0, 1]), (1, [0, 0, 1, 1])):
            m = make_mesh(shape, devices=devs[:4], owners=[0, 0, 1, 1])
            assert block_sharding(m).owners == want
        with pytest.raises(ValueError, match="owns no mesh entry"):
            make_mesh(devices=devs, owners=owners, process_index=2)
        # a mesh of one process keeps its first row for every block
        assert block_sharding(make_mesh(devices=devs)).devices == [
            torch.device("cpu:0"), torch.device("cpu:1")]


def _instance(v=32, seed=0):
    rng = np.random.RandomState(seed)
    weights = rng.rand(v).astype(np.float32)
    adj = rng.rand(v, v) < 0.6
    adj = np.triu(adj, 1) | np.triu(adj, 1).T
    return weights, adj, np.ones(v, bool), np.zeros(v, bool)


class _Fixed:
    def __init__(self, fields):
        self.fields = fields

    def draw(self, r, v, iters_pad, device):
        return to_torch_fields(self.fields, device)


class TestShardedSolver:
    def test_matches_jax_on_8_cpu_mesh(self):
        """cam 4 x block 2, V=32, R=2, 100 iterations; block b draws the
        fields of jax.random.split(key, 2)[b], as the JAX shard does."""
        jmesh = jax_make_mesh()
        assert dict(jmesh.shape) == {"cam": 4, "block": 2}
        cfg = SolverConfig(num_replicas=2, max_vertices=32,
                           solutions_per_replica=4)
        jcfg = JaxSolverConfig(num_replicas=2, max_vertices=32,
                               solutions_per_replica=4)
        w, adj, valid, init = _instance()
        key = jax.random.PRNGKey(1)
        ref = jax_solve_sharded(jnp.asarray(w), jnp.asarray(adj),
                                jnp.asarray(valid), jnp.asarray(init), key,
                                jmesh, jcfg, iters=100)
        fields = [_Fixed(jax_mwcp_fields(k, 2, 32, 100))
                  for k in jax.random.split(key, 2)]
        got = solve_mwcp_sharded(torch.tensor(w), torch.tensor(adj),
                                 torch.tensor(valid), torch.tensor(init),
                                 fields, make_mesh(devices=CPU8), cfg,
                                 iters=100)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(float(got[1]), float(ref[1]), atol=1e-4)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]),
                                   atol=1e-4)
        assert got[2].shape == (4, 32)
        members = np.flatnonzero(got[0].numpy())
        assert adj[np.ix_(members, members)].sum() == len(members) * (
            len(members) - 1)

    def test_generator_equals_per_block_solves(self):
        """A key is split into one key per block (the generator of every
        block's fields); the result is the blocks' own solves plus the
        global argmax, and a field source per block draws the same."""
        cfg = SolverConfig(num_replicas=3, max_vertices=32,
                           solutions_per_replica=4)
        w, adj, valid, init = map(torch.tensor, _instance(seed=2))
        mesh = make_mesh(num_cam_shards=1, devices=["cpu"] * 3)
        got = solve_mwcp_sharded(w, adj, valid, init, prng.prng_key(5), mesh,
                                 cfg, iters=60)
        keys = prng.split(prng.prng_key(5), len(block_sharding(mesh).devices))
        blocks = [solve_mwcp(w, adj, valid, init, k, cfg, 60) for k in keys]
        best = [r.best_score.max() for r in blocks]
        b = int(torch.argmax(torch.stack(best)))
        assert float(got[1]) == float(best[b])
        assert torch.equal(got[0], blocks[b].best_mask[
            int(torch.argmax(blocks[b].best_score))])
        assert torch.equal(got[2], torch.cat([r.best_mask for r in blocks]))
        # a field source per block: each draws from its key's next subkey
        again = solve_mwcp_sharded(w, adj, valid, init,
                                   [ThreefryFields(k) for k in keys], mesh,
                                   cfg, iters=60)
        sub = [solve_mwcp(w, adj, valid, init, prng.split(k)[1], cfg, 60)
               for k in keys]
        assert torch.equal(again[2], torch.cat([r.best_mask for r in sub]))


def _engine_cfg():
    return EngineConfig(
        num_cameras=4, image_width=128, image_height=96,
        tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=4),
        solver=SolverConfig(num_replicas=2, max_vertices=64,
                            solutions_per_replica=4, max_iterations=100,
                            solve_batch=8))


def test_engine_parity_on_mesh():
    """The engine on a ["cpu"] * 8 mesh (cam 4 x block 2) against the
    engine without one: ids equal and points within 1 mm every frame
    (tests/test_parallel.py:81-101), with the 2D state split into 4 camera
    groups of one camera each."""
    sc = make_scenario(num_cameras=4, num_frames=12, num_people=4,
                       image_size=(128, 96), arena=3000.0, seed=5)
    mesh = make_mesh(devices=CPU8)
    ea = TrackingEngine(_engine_cfg(), sc.cameras, device="cpu")
    eb = TrackingEngine(_engine_cfg(), sc.cameras, mesh=mesh)
    saw_tracks = False
    for t in range(12):
        frames = np.stack(sc.frames(t))
        ra = ea.process_frame(frames, sc.detections[t], frame_idx=t)
        rb = eb.process_frame(frames, sc.detections[t], frame_idx=t)
        assert ra.ids == rb.ids, f"frame {t}: {ra.ids} vs {rb.ids}"
        if len(ra.ids):
            saw_tracks = True
            np.testing.assert_allclose(ra.points, rb.points, atol=1.0)
    assert saw_tracks, "scenario produced no tracks - test is vacuous"
    assert eb.mesh is mesh and eb.assoc.mesh is mesh
    assert eb.device == eb.assoc.device == torch.device("cpu")
    assert len(eb.state2d_groups) == 4 and len(ea.state2d_groups) == 1
    assert all(g.frames.shape[0] == 1 and g.next_id.shape == (1,)
               for g in eb.state2d_groups)
    # the joined state is the unsplit engine's
    for a, b in zip(tree_leaves(ea.state2d), tree_leaves(eb.state2d)):
        assert a.shape == b.shape
    np.testing.assert_array_equal(ea.state2d.trk_id, eb.state2d.trk_id)


def test_engine_mesh_checks():
    """A mesh names the engine's device itself, and its 'cam' rows must
    divide the cameras."""
    sc = make_scenario(num_cameras=4, num_frames=1, num_people=1,
                       image_size=(128, 96), seed=1)
    with pytest.raises(ValueError, match="not both"):
        TrackingEngine(_engine_cfg(), sc.cameras,
                       mesh=make_mesh(devices=CPU8), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        TrackingEngine(_engine_cfg(), sc.cameras,
                       mesh=make_mesh(num_cam_shards=3,
                                      devices=["cpu"] * 3))


# the fused program's arguments (Associator3D._rescore_and_solve) that
# the JAX package uploads with _dev(x, True) (associator3d.py:2549-2559)
_SPLIT_ARGS = {0: "pts", 1: "raws", 2: "rmask", 3: "merr", 4: "lens",
               7: "tree_ids", 9: "pos_grid", 10: "have", 11: "pvalid"}


def _whole(x):
    return torch.cat(x.parts) if isinstance(x, Shards) else x


@pytest.fixture(scope="module")
def fused_calls():
    """The engine on an 8-device and a 3-device CPU mesh for 6 frames:
    the arguments of every fused-program call."""
    sc = make_scenario(num_cameras=4, num_frames=6, num_people=4,
                       image_size=(128, 96), arena=3000.0, seed=5)
    out = {}
    for n in (8, 3):
        eng = TrackingEngine(_engine_cfg(), sc.cameras,
                             mesh=make_mesh(devices=["cpu"] * n))
        calls, orig = [], eng.assoc._rescore_and_solve

        def record(*args, calls=calls, orig=orig):
            calls.append(args)
            return orig(*args)
        eng.assoc._rescore_and_solve = record
        for t in range(6):
            eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                              frame_idx=t)
        assert calls, "no fused-program call: the test is vacuous"
        out[n] = (eng, calls)
    return sc, out


def test_dev_splits_by_the_jax_rule():
    """_dev(x, True) splits the leading axis over every mesh device when
    it divides mesh.size and replicates otherwise; _dev(x) replicates."""
    sc = make_scenario(num_cameras=4, num_frames=1, num_people=1,
                       image_size=(128, 96), seed=1)
    assoc = Associator3D(_engine_cfg(), sc.cameras,
                         mesh=make_mesh(devices=CPU8))
    x = np.arange(16 * 2).reshape(16, 2)
    s = assoc._dev(x, True)
    assert isinstance(s, Shards) and len(s.parts) == 8
    np.testing.assert_array_equal(_whole(s).numpy(), x)
    for y, shard in ((x, False), (x[:12], True), (np.int32(3), True)):
        t = assoc._dev(y, shard)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), y)
    plain = Associator3D(_engine_cfg(), sc.cameras, device="cpu")
    assert isinstance(plain._dev(x, True), torch.Tensor)


@pytest.mark.parametrize("n", [8, 3])
def test_fused_program_row_inputs_split_by_the_rule(fused_calls, n):
    """Every split argument of every call is Shards of mesh.size chunks
    exactly when its leading axis divides mesh.size (always at 8: the
    row buckets are powers of two >= 64; never at 3); the others, and
    the compatibility columns, are replicated tensors, each the whole of
    its rows."""
    _, out = fused_calls
    _, calls = out[n]
    for args in calls:
        for i, x in enumerate(args[:13]):
            rows = _whole(x).shape[0]
            split = i in _SPLIT_ARGS and rows % n == 0
            assert isinstance(x, Shards) is split, (n, i, rows)
            if split:
                assert len(x.parts) == n and not x.remote
        assert (n == 8) == isinstance(args[0], Shards)
        cols = args[15]
        for c, i in zip(cols, (7, 9, 10)):
            assert isinstance(c, torch.Tensor) and torch.equal(
                c, _whole(args[i]))


def test_fused_program_equals_no_mesh_bit_for_bit(fused_calls):
    """Each recorded call on the 8-device mesh, replayed with equal
    fields, against the same call on whole tensors without a mesh."""
    sc, out = fused_calls
    eng, calls = out[8]
    plain = Associator3D(_engine_cfg(), sc.cameras, device="cpu")
    for args in calls:
        got = Associator3D._rescore_and_solve(
            eng.assoc, *args[:13], prng.prng_key(9), args[14], args[15])
        want = plain._rescore_and_solve(
            *[_whole(x) for x in args[:13]], prng.prng_key(9), args[14],
            args[15])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_scaling_report_matches_jax():
    from mcmtt_opticalflow_tpu.parallel.launch import \
        scaling_report as jax_scaling_report
    from mcmtt_opticalflow_tpu_torch.parallel.launch import scaling_report
    for rates in ((2.0, 11.0), (0.0, 3.0), (1.5, 1.5)):
        assert scaling_report(make_mesh(devices=CPU8), *rates) == \
            jax_scaling_report(jax_make_mesh(), *rates)
