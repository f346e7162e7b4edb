"""The port's cross-process path: two gloo processes on the CPU, each with
["cpu"] * 4, run mcmtt_opticalflow_tpu_torch/parallel/multihost_sim.py on
the global cam 4 x block 2 mesh (the counterpart of
tests/test_multiprocess.py).  Both processes must return the same
per-frame ids and points, equal to the engine on make_mesh(["cpu"] * 8)
in one process (ids equal, points within 1 mm, expected 0); the sharded
solve must equal its one-process result bit for bit; a cross-process
fetch must return whole leaves.

Every run of the scene takes the gather LK (MCMTT_LK_BACKEND=xla), as
the JAX engine does on the CPU, so the processes are also held against
the JAX engine on the 8-device CPU mesh of tests/conftest.py in one step
(ids equal, points within 1 mm).  The processes draw the port's own
solver fields; the one-process run that draws the JAX package's fields
(JaxFieldSource) must equal the JAX engine too, so no difference of the
random draws hides behind the first comparison."""

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.config import (EngineConfig, SolverConfig,
                                          Tracker2DConfig)
from mcmtt_opticalflow_tpu.data import make_scenario
from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine as JaxEngine
from mcmtt_opticalflow_tpu.parallel import make_mesh as jax_make_mesh
from mcmtt_opticalflow_tpu_torch.parallel import make_mesh
from mcmtt_opticalflow_tpu_torch.parallel import multihost_sim
from torch_parity import JaxFieldSource

torch.set_num_threads(2)

FRAMES = 10
CHILD_LIMIT_S = 240
POINT_ATOL_MM = 1.0


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Both processes (multihost_sim.spawn, each killed at CHILD_LIMIT_S):
    process 0's report and each process's RESULT."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")      # the children inherit it
        report, outs = multihost_sim.spawn(
            2, ["--local-devices", "cpu,cpu,cpu,cpu", "--backend", "gloo",
                "--engine-frames", str(FRAMES)],
            str(tmp_path_factory.mktemp("mp")), CHILD_LIMIT_S)
    for pid, (rc, out, err, result) in enumerate(outs):
        assert rc == 0, f"process {pid} failed (rc {rc}):\n{out}\n{err[-3000:]}"
        assert "ok mesh=" in out and result is not None
    assert report is not None
    return report, [result for *_, result in outs]


@pytest.fixture(scope="module")
def one_process():
    """The solve and the scene on make_mesh(["cpu"] * 8) in this process:
    (solve, engine with the port's fields, engine with the JAX fields)."""
    mesh = make_mesh(devices=["cpu"] * 8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        return (multihost_sim.run_solve(mesh, bench=False),
                multihost_sim.run_engine(mesh, bench=False, frames_n=FRAMES),
                multihost_sim.run_engine(
                    mesh, bench=False, frames_n=FRAMES,
                    make_fields=lambda cfg: JaxFieldSource(cfg.solver.seed)))


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine (pipelined, its CPU gather LK) on the 8-device CPU
    mesh, on the scene and configuration of multihost_sim.run_engine
    (scripts/multihost_sim.py's), in the frames format of run_engine."""
    sc = make_scenario(num_cameras=4, num_frames=FRAMES, num_people=3,
                       image_size=(128, 96), arena=3000.0, seed=0)
    cfg = EngineConfig(
        num_cameras=4, image_width=128, image_height=96,
        tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=4),
        solver=SolverConfig(num_replicas=2, max_vertices=64,
                            solutions_per_replica=4, max_iterations=60))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        eng = JaxEngine(cfg, sc.cameras, pipelined=True,
                        mesh=jax_make_mesh())
        results = []
        for t in range(FRAMES):
            frames = (np.clip(np.stack(sc.frames(t)), 0, 1) * 255).astype(
                np.uint8)
            results.append(eng.process_frame(frames, sc.detections[t],
                                             frame_idx=t))
        while (r := eng.flush()) is not None:
            results.append(r)
    return [{"frame": r.frame_idx, "ids": [int(i) for i in r.ids],
             "points": np.asarray(r.points, np.float64).tolist()}
            for r in results if r is not None]


def test_report(two_processes):
    report, _ = two_processes
    assert report["processes"] == 2
    assert report["devices"] == 8
    assert report["local_devices"] == 4
    assert report["mesh"] == {"cam": 4, "block": 2}
    assert report["engine_track_results"] > 0
    assert report["solver_best_score"] > 0
    assert 0.0 < report["scaling_efficiency"]
    assert len(report["frames"]) == FRAMES


def test_each_process_runs_its_own_groups_and_blocks(two_processes):
    _, (r0, r1) = two_processes
    assert (r0["engine"]["groups_here"], r1["engine"]["groups_here"]) == (
        [0, 1], [2, 3])
    assert (r0["solver"]["blocks_here"], r1["solver"]["blocks_here"]) == (
        [0], [1])
    assert "owners [0, 0, 0, 0, 1, 1, 1, 1]" in r0["mesh"]


def _frames_equal(a, b, label):
    assert [f["frame"] for f in a] == [f["frame"] for f in b] == list(
        range(FRAMES)), label
    for fa, fb in zip(a, b):
        assert fa["ids"] == fb["ids"], f"{label}, frame {fa['frame']}"
        np.testing.assert_allclose(np.reshape(fa["points"], (-1, 3)),
                                   np.reshape(fb["points"], (-1, 3)),
                                   rtol=0, atol=POINT_ATOL_MM,
                                   err_msg=f"{label}, frame {fa['frame']}")


def test_engine_processes_agree_with_one_process(two_processes,
                                                 one_process):
    _, (r0, r1) = two_processes
    _frames_equal(r0["engine"]["frames"], r1["engine"]["frames"],
                  "process 0 vs process 1")
    _frames_equal(r0["engine"]["frames"], one_process[1]["frames"],
                  "two processes vs one")
    assert any(f["ids"] for f in one_process[1]["frames"])


def test_engine_processes_agree_with_jax(two_processes, one_process,
                                         jax_engine):
    """The JAX engine on its 8-device CPU mesh against the two processes
    and against the one-process run that draws the JAX fields."""
    _, results = two_processes
    for pid, r in enumerate(results):
        _frames_equal(r["engine"]["frames"], jax_engine,
                      f"process {pid} vs the JAX engine")
    _frames_equal(one_process[2]["frames"], jax_engine,
                  "one process, JAX fields, vs the JAX engine")
    assert len({i for f in jax_engine for i in f["ids"]}) >= 2


def test_sharded_solve_equals_one_process(two_processes, one_process):
    _, results = two_processes
    want = one_process[0]
    keys = ("best_score", "best_mask", "all_masks_sha256",
            "all_scores_sha256")
    for r in results:
        assert r["solver"]["equals_per_block"] and r["solver"]["clique"]
        assert {k: r["solver"][k] for k in keys} == {k: want[k]
                                                     for k in keys}


def test_collectives_per_frame(two_processes):
    """Two all-gathers a frame, made alike in both processes: the 2D
    packs and the fused program's row results.  The program's
    compatibility columns are uploaded in every process, never gathered,
    and the standalone rescoring pass does not run on this scene.  The
    pipeline's lag puts the first two calls before any gather, and the
    FRAMES + 3 calls (FRAMES process_frame, three flush) end with one
    that gathers nothing."""
    _, (r0, r1) = two_processes
    counts = r0["engine"]["collectives_per_call"]
    assert counts == r1["engine"]["collectives_per_call"]
    assert counts == [0, 0] + [2] * FRAMES + [0], counts


def test_cross_process_fetch_is_whole(two_processes):
    _, results = two_processes
    assert all(r["fetch_ok"] for r in results)
