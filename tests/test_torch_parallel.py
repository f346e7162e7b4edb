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
from mcmtt_opticalflow_tpu_torch.models.mwcp import GeneratorFields, solve_mwcp
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.parallel import (block_sharding,
                                                  cam_sharding, make_mesh,
                                                  replicated,
                                                  solve_mwcp_sharded)
from mcmtt_opticalflow_tpu_torch.parallel.mesh import (AsyncFetch, fetch,
                                                       shard_leaves)
from mcmtt_opticalflow_tpu_torch.parallel.solver_parallel import split_fields
from mcmtt_opticalflow_tpu_torch.utils.tree import tree_leaves
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
        """A generator is split into one field source per block; the
        result is the blocks' own solves plus the global argmax."""
        cfg = SolverConfig(num_replicas=3, max_vertices=32,
                           solutions_per_replica=4)
        w, adj, valid, init = map(torch.tensor, _instance(seed=2))
        mesh = make_mesh(num_cam_shards=1, devices=["cpu"] * 3)
        got = solve_mwcp_sharded(w, adj, valid, init,
                                 torch.Generator().manual_seed(5), mesh,
                                 cfg, iters=60)
        blocks = [solve_mwcp(w, adj, valid, init, f, cfg, 60) for f in
                  split_fields(torch.Generator().manual_seed(5),
                               block_sharding(mesh).devices)]
        best = [r.best_score.max() for r in blocks]
        b = int(torch.argmax(torch.stack(best)))
        assert float(got[1]) == float(best[b])
        assert torch.equal(got[0], blocks[b].best_mask[
            int(torch.argmax(blocks[b].best_score))])
        assert torch.equal(got[2], torch.cat([r.best_mask for r in blocks]))
        assert isinstance(split_fields(torch.Generator(), ["cpu"])[0],
                          GeneratorFields)


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
