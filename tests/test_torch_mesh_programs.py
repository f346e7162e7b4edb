"""The mesh path as captured programs, on the CPU meshes of
tests/test_torch_parallel.py (["cpu"] * 8: cam 4 x block 2; ["cpu"] * 3:
one camera group, no row input split), where each part of a program runs
eagerly from its static buffers: the programs' plumbing.

- each camera group's 2D program (models/pipeline.py::Tracker2DProgram,
  one per group) equals tracker2d_step on that group's cameras, bit for
  bit, every frame's pack and state leaf over 12 frames;
- the fused 3D program on a mesh (models/associator3d.py::FrameProgram:
  a row part per chunk, the join, the parts on the home device) equals
  the eager body Associator3D._rescore_and_solve on the same uploads,
  bit for bit, on every call of 12 frames at n = 8 and n = 3;
- two buckets taken in turn keep their own buffers, chunks included;
- with every part captured (stand-in graphs), a frame replays each row
  part, the draw, the head and the tail once, and each group's 2D program
  once; capturing leaves every group's state as it was;
- a snapshot saved and restored on a mesh puts the 2D state back into
  the groups' program buffers;
- the program reads no device value on the host in one process;
- the port's mesh engine on the gather LK equals the JAX engine on its
  8-CPU mesh (ids every frame, points within 1 mm).

The captures themselves (CUDA graphs) run only on a card: chip_smoke.py's
mesh phase holds the replays against the eager route there."""

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.config import EngineConfig as JaxEngineConfig
from mcmtt_opticalflow_tpu.config import SolverConfig as JaxSolverConfig
from mcmtt_opticalflow_tpu.config import \
    Tracker2DConfig as JaxTracker2DConfig
from mcmtt_opticalflow_tpu.data import make_scenario as j_make_scenario
from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine as JaxEngine
from mcmtt_opticalflow_tpu.parallel import make_mesh as jax_make_mesh
from mcmtt_opticalflow_tpu_torch.checkpoint import (load_snapshot,
                                                    save_snapshot)
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.geometry.tsai import stack_cameras
from mcmtt_opticalflow_tpu_torch.models.associator3d import (
    _GRAPH_ROWS, _SPLIT_ARGS, Associator3D, FrameProgram)
from mcmtt_opticalflow_tpu_torch.models.pipeline import (TrackingEngine,
                                                         _pack2d)
from mcmtt_opticalflow_tpu_torch.models.tracker2d import (
    init_tracker2d_state, tracker2d_step)
from mcmtt_opticalflow_tpu_torch.parallel import make_mesh
from mcmtt_opticalflow_tpu_torch.parallel.mesh import Shards
from mcmtt_opticalflow_tpu_torch.utils.graphs import Graphed
from mcmtt_opticalflow_tpu_torch.utils.tree import tree_leaves
from test_torch_graphs import _grow_rows
from test_torch_graphs import _same_bits as _same
from test_torch_parallel import _engine_cfg, record_program_calls

torch.set_num_threads(2)

FRAMES = 12
POINT_ATOL_MM = 1.0


def _scene():
    return make_scenario(num_cameras=4, num_frames=FRAMES, num_people=4,
                         image_size=(128, 96), arena=3000.0, seed=5)


@pytest.fixture(scope="module")
def mesh_runs():
    """The engine on make_mesh(["cpu"] * n) for n = 8 and 3 over FRAMES
    frames.  After each frame, each group's 2D program inputs, pack and
    state; at each call of the fused 3D program, its bucket, host arrays,
    uploads as its buffers hold them (the arguments of _rescore_and_solve:
    the 13 uploads, the subkey, the iterations, the columns) and its
    outputs, all cloned."""
    sc = _scene()
    out = {}
    for n in (8, 3):
        eng = TrackingEngine(_engine_cfg(), sc.cameras,
                             mesh=make_mesh(devices=["cpu"] * n))
        frames2d = []

        def record2d(eng, frames2d=frames2d):
            frames2d.append([{
                "inputs": [x.clone() for x in (p.gray_u8, p.boxes, p.mask)],
                "frame_idx": int(p.frame_idx),
                "pack": p.graph.out.clone(),
                "state": [x.clone() for x in tree_leaves(p.state)]}
                for p in eng._progs2d])
        calls = record_program_calls(eng, sc, FRAMES, record2d)
        assert len(calls) >= 6 and any(len(r.ids) for r in eng.results), \
            "the scene solved too few frames: the tests would be vacuous"
        out[n] = (eng, calls, frames2d)
    return sc, out


def test_group_2d_programs_equal_the_eager_step(mesh_runs):
    """Each of the four camera groups' programs against tracker2d_step on
    the group's cameras from a zero state (frame numbers as Python ints),
    on the inputs the program held: every pack and state leaf."""
    sc, out = mesh_runs
    eng, _, frames2d = out[8]
    cfg = eng.cfg
    assert len(eng._progs2d) == 4
    for g, prog in enumerate(eng._progs2d):
        assert prog.state is eng.state2d_groups[g]
        cams = stack_cameras(sc.cameras[g:g + 1], "cpu")
        state = init_tracker2d_state(cfg.tracker2d, cfg.image_height,
                                     cfg.image_width, 1, device="cpu")
        for t in range(FRAMES):
            f = frames2d[t][g]
            gray_u8, boxes, mask = f["inputs"]
            assert f["frame_idx"] == t and gray_u8.shape[0] == 1
            state, o = tracker2d_step(state, gray_u8.float() * (1.0 / 255.0),
                                      boxes, mask, cams, t, cfg.tracker2d)
            _same([f["pack"]] + f["state"], [_pack2d(o)] + tree_leaves(state))
    assert any(f[g]["pack"][..., 1].sum() > 0 for f in frames2d
               for g in range(4)), "no tracklet: the test is vacuous"


@pytest.mark.parametrize("n", [8, 3])
def test_mesh_3d_program_equals_the_eager_body(mesh_runs, n):
    """Every program call's outputs against the eager body on the same
    uploads and subkey.  At 8 every row input splits (a row part per
    chunk); at 3 none does."""
    _, out = mesh_runs
    eng, calls, _ = out[n]
    for c in calls:
        args = c["args"]
        assert isinstance(args[0], Shards) is (n == 8)
        assert isinstance(args[7], Shards) is (n == 8)
        _same(c["out"], Associator3D._rescore_and_solve(eng.assoc, *args))
    for prog in eng.assoc._programs.values():
        assert len(prog.rows) == (8 if n == 8 else 0)
        assert all(r.device == torch.device("cpu") for r in prog.rows)


def _uploads(assoc, host):
    """_rescore_and_solve's first 13 arguments, uploaded by the JAX
    package's rule (`_dev`), and its columns."""
    args = [assoc._dev(x, i in _SPLIT_ARGS) for i, x in enumerate(host)]
    return args, tuple(assoc._dev(host[i]) for i in _GRAPH_ROWS)


def test_mesh_buckets_in_turn_keep_their_own_buffers(mesh_runs):
    """Two buckets on the 8-device mesh, run in turn on two frames each:
    every result equals the eager body on its uploads, and no buffer of
    one bucket, a chunk's included, shares storage with the other's."""
    sc, out = mesh_runs
    eng, calls, _ = out[8]
    assoc = Associator3D(_engine_cfg(), sc.cameras, mesh=eng.mesh)
    (nr, nb, iters), c1, c2 = calls[-2]["bucket"], calls[-2], calls[-1]
    runs = [(nr, c1["host"], c1["args"][13]),
            (2 * nr, _grow_rows(c2["host"], 2 * nr), c2["args"][13]),
            (nr, c2["host"], c2["args"][13]),
            (2 * nr, _grow_rows(c1["host"], 2 * nr), c1["args"][13])]
    for rows, host, key in runs:
        got = assoc._program(rows, nb, iters)(host, key)
        assert got[0].shape[0] == rows
        args, cols = _uploads(assoc, host)
        assert isinstance(args[0], Shards) and len(args[0].parts) == 8
        _same(got, assoc._rescore_and_solve(*args, key, iters, cols))
    a, b = (assoc._programs[(x, nb, iters)] for x in (nr, 2 * nr))

    def storages(p):
        leaves = [t for x in (*p.inputs, *p.cols, *p.joined)
                  for t in (x.parts if isinstance(x, Shards) else [x])]
        return {t.untyped_storage().data_ptr()
                for t in (*leaves, p.key, *p.fields)}
    assert not storages(a) & storages(b)


class _Replayed:
    """A stand-in CUDA graph: replaying runs the Graphed's function."""

    def __init__(self, graphed):
        self.graphed, self.replays = graphed, 0

    def replay(self):
        self.replays += 1
        self.graphed.out = self.graphed.fn()


def _stand_in_capture(g):
    """What Graphed.capture does, off the card's API: one eager warm-up
    run (whose outputs stand for the recording's), then a graph (a
    stand-in)."""
    g.out = g.fn()
    g.graph = _Replayed(g)


def test_captured_mesh_programs_replay_each_part_once_a_frame(mesh_runs,
                                                              monkeypatch):
    """On the 8-device mesh with stand-in graphs: precompile captures every
    group's 2D program without moving its state; the fused program's
    capture runs its row parts before the join's buffers are made and the
    head before each iteration part.  Then a frame replays each 2D
    program once, and each row part, the draw, the head and the tail
    once, the block iters // BLOCK times and the remainder once, and its
    results are the eager run's."""
    sc, out = mesh_runs
    _, calls, frames2d = out[8]
    eng = TrackingEngine(_engine_cfg(), sc.cameras,
                         mesh=make_mesh(devices=["cpu"] * 8))
    for t in range(3):
        eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                          frame_idx=t)
    before = [[x.clone() for x in tree_leaves(s)]
              for s in eng.state2d_groups]
    monkeypatch.setattr(Graphed, "on_card", property(lambda g: True))
    monkeypatch.setattr(Graphed, "capture", _stand_in_capture)
    eng.precompile()
    for prog, state in zip(eng._progs2d, before):
        assert isinstance(prog.graph.graph, _Replayed)
        assert prog.graph.graph.replays == 0
        _same(tree_leaves(prog.state), state)
    c = calls[-1]
    prog = eng.assoc._program(*c["bucket"])
    prog.capture()
    assert all(isinstance(p.graph, _Replayed) for p in prog.parts())
    assert len(prog.rows) == 8 and prog.joined is not None
    # the head's capture replayed nothing; one head replay ahead of each
    # iteration part's capture
    loops = [x for x in (prog.block, prog.rest) if x is not None]
    assert prog.head.graph.replays == len(loops)
    for p in prog.parts():
        p.graph.replays = 0
    got = prog(c["host"], c["args"][13])
    _same(got, c["out"])
    want = {prog.draw: 1, prog.head: 1, prog.block: prog.blocks,
            prog.rest: 1, prog.tail: 1}
    assert [p.graph.replays for p in prog.parts()] == \
        [want.get(p, 1) for p in prog.parts()]
    assert prog.blocks == c["bucket"][2] // FrameProgram.BLOCK > 0
    eng.process_frame(np.stack(sc.frames(3)), sc.detections[3], frame_idx=3)
    for g, p in enumerate(eng._progs2d):
        assert p.graph.graph.replays == 1
        _same([p.graph.out] + tree_leaves(p.state),
              [frames2d[3][g]["pack"]] + frames2d[3][g]["state"])


def test_mesh_snapshot_restores_the_group_program_buffers(mesh_runs,
                                                          tmp_path):
    """save_snapshot joins the groups' states; load_snapshot writes each
    group's slice into a fresh mesh engine's program buffers (they stay
    the programs'), and the next frame's 2D outputs are the run's."""
    sc, out = mesh_runs
    _, _, frames2d = out[8]
    mesh = make_mesh(devices=["cpu"] * 8)
    a = TrackingEngine(_engine_cfg(), sc.cameras, mesh=mesh)
    for t in range(4):
        a.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                        frame_idx=t)
    path = str(tmp_path / "snap.pkl")
    save_snapshot(a, path)
    b = TrackingEngine(_engine_cfg(), sc.cameras, mesh=mesh)
    buffers = [tree_leaves(p.state) for p in b._progs2d]
    assert load_snapshot(b, path) == 3
    for g, p in enumerate(b._progs2d):
        assert b.state2d_groups[g] is p.state
        assert all(x is y for x, y in zip(tree_leaves(p.state), buffers[g]))
        _same(tree_leaves(p.state), frames2d[3][g]["state"])
    b.process_frame(np.stack(sc.frames(4)), sc.detections[4], frame_idx=4)
    for g, p in enumerate(b._progs2d):
        _same([p.graph.out] + tree_leaves(p.state),
              [frames2d[4][g]["pack"]] + frames2d[4][g]["state"])
    # the joined getter hands out a copy
    held = b.state2d
    b.process_frame(np.stack(sc.frames(5)), sc.detections[5], frame_idx=5)
    for g in range(4):
        _same([x[g:g + 1] for x in tree_leaves(held)],
              frames2d[4][g]["state"])


def test_mesh_program_reads_nothing_on_the_host(mesh_runs, monkeypatch):
    """The 8-device mesh program (row parts, join, home parts) with the
    host reads of device values patched to raise, and indexed writes of
    host values (a copy from the host on the card) refused."""
    sc, out = mesh_runs
    eng, calls, _ = out[8]
    c = calls[-1]
    assoc = Associator3D(_engine_cfg(), sc.cameras, mesh=eng.mesh)
    prog = assoc._program(*c["bucket"])
    assert len(prog.rows) == 8

    def refuse(*a, **k):
        raise AssertionError("host read of a device value")
    setitem = torch.Tensor.__setitem__

    def device_values_only(t, index, value):
        advanced = any(isinstance(i, torch.Tensor) for i in (
            index if isinstance(index, tuple) else (index,)))
        if advanced and not isinstance(value, torch.Tensor):
            raise AssertionError("indexed write of a host value")
        return setitem(t, index, value)
    monkeypatch.setattr(torch.Tensor, "__setitem__", device_values_only)
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    got = prog(c["host"], c["args"][13])
    monkeypatch.undo()
    _same(got, c["out"])


def _jax_cfg():
    return JaxEngineConfig(
        num_cameras=4, image_width=128, image_height=96,
        tracker2d=JaxTracker2DConfig(max_detections=8, max_trackers=16,
                                     max_features=16, lk_window=8,
                                     lk_pyramid_levels=2, lk_iterations=4),
        solver=JaxSolverConfig(num_replicas=2, max_vertices=64,
                               solutions_per_replica=4, max_iterations=100,
                               solve_batch=8))


def test_mesh_engine_equals_jax_engine_on_its_mesh(monkeypatch):
    """The scene of test_engine_parity_on_mesh through the JAX engine on
    its 8-CPU mesh and the port's engine on ["cpu"] * 8, both on the
    gather LK (MCMTT_LK_BACKEND=xla) and the JAX solver stream: ids equal
    every frame, points within 1 mm."""
    monkeypatch.setenv("MCMTT_LK_BACKEND", "xla")
    jmesh = jax_make_mesh()
    assert dict(jmesh.shape) == {"cam": 4, "block": 2}
    jsc = j_make_scenario(num_cameras=4, num_frames=FRAMES, num_people=4,
                          image_size=(128, 96), arena=3000.0, seed=5)
    sc = _scene()
    ja = JaxEngine(_jax_cfg(), jsc.cameras, mesh=jmesh)
    tb = TrackingEngine(_engine_cfg(), sc.cameras,
                        mesh=make_mesh(devices=["cpu"] * 8))
    seen = 0
    for t in range(FRAMES):
        frames = np.stack(sc.frames(t))
        ra = ja.process_frame(frames, jsc.detections[t], frame_idx=t)
        rb = tb.process_frame(frames, sc.detections[t], frame_idx=t)
        assert list(ra.ids) == rb.ids, f"frame {t}: {ra.ids} vs {rb.ids}"
        if len(rb.ids):
            seen += 1
            np.testing.assert_allclose(
                np.reshape(rb.points, (-1, 3)),
                np.reshape(np.asarray(ra.points), (-1, 3)), rtol=0,
                atol=POINT_ATOL_MM, err_msg=f"frame {t}")
    assert seen, "the scene produced no tracks: the test is vacuous"
    assert all(len(p.rows) == 8 for p in tb.assoc._programs.values())
