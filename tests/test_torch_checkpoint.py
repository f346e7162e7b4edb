"""Checkpoint / resume of the port's TrackingEngine: a run that saves a
snapshot after 3 frames and resumes it in a fresh engine gives the same
results as an uninterrupted run, sequential and pipelined (the solver's
generator state travels in the snapshot); and the mirror of
tests/test_aux.py::TestCheckpoint on the port."""

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu_torch.checkpoint import (load_snapshot,
                                                    save_snapshot)
from mcmtt_opticalflow_tpu_torch.config import (EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine

torch.set_num_threads(2)

NUM_FRAMES = 6


def _cfg():
    """tests/test_aux.py::TestCheckpoint's engine."""
    return EngineConfig(
        num_cameras=2, image_width=128, image_height=96,
        tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=4),
        solver=SolverConfig(num_replicas=2, max_vertices=32,
                            solutions_per_replica=4, max_iterations=100))


def _tracking_cfg():
    """tests/test_torch_pipeline.py's engine: its scene yields 3D tracks
    from the third frame on."""
    return EngineConfig(
        num_cameras=2, image_width=256, image_height=192,
        tracker2d=Tracker2DConfig(max_detections=16, max_trackers=32,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=6),
        solver=SolverConfig(num_replicas=4, max_vertices=64,
                            solutions_per_replica=8, max_iterations=200))


def _scene(**kw):
    sc = make_scenario(num_cameras=2, num_frames=NUM_FRAMES, **kw)
    return sc, [np.stack(sc.frames(t)) for t in range(NUM_FRAMES)]


@pytest.fixture(scope="module")
def scene():
    return _scene(num_people=2, image_size=(128, 96), arena=3000.0, seed=5)


@pytest.fixture(scope="module")
def tracking_scene():
    return _scene(num_people=3, image_size=(256, 192), arena=5000.0,
                  seed=11)


def _run(eng, sc, frames, ts):
    for t in ts:
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
    if eng.pipelined:
        while eng.flush() is not None:
            pass


@pytest.mark.parametrize("pipelined", [False, True])
def test_resumed_run_equals_uninterrupted_run(tracking_scene, tmp_path,
                                             pipelined):
    sc, frames = tracking_scene

    def engine():
        return TrackingEngine(_tracking_cfg(), sc.cameras,
                              pipelined=pipelined, device="cpu")
    straight = engine()
    _run(straight, sc, frames, range(NUM_FRAMES))

    first = engine()
    _run(first, sc, frames, range(3))
    path = str(tmp_path / "snap.pkl")
    save_snapshot(first, path)
    resumed = engine()
    assert load_snapshot(resumed, path) == 2
    _run(resumed, sc, frames, range(3, NUM_FRAMES))

    assert len(resumed.results) == len(straight.results) == NUM_FRAMES
    for a, b in zip(straight.results, resumed.results):
        assert a.frame_idx == b.frame_idx
        assert a.ids == b.ids
        np.testing.assert_array_equal(a.points, b.points)
    for td in range(NUM_FRAMES):
        a, b = straight.deferred_result(td), resumed.deferred_result(td)
        assert a.ids == b.ids
        np.testing.assert_array_equal(a.points, b.points)
    assert resumed.assoc.best_solution == straight.assoc.best_solution
    assert any(len(r.ids) for r in straight.results[3:])
    # both drew the same solver fields: their generators end in one state
    assert torch.equal(resumed.assoc.field_source.generator.get_state(),
                       straight.assoc.field_source.generator.get_state())


def test_snapshot_resume(scene, tmp_path):
    """Mirror of tests/test_aux.py::TestCheckpoint::test_snapshot_resume."""
    sc, frames = scene
    eng = TrackingEngine(_cfg(), sc.cameras, device="cpu")
    for t in range(3):
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
    path = str(tmp_path / "snap.pkl")
    save_snapshot(eng, path)
    n_tracks = len(eng.assoc.registry.tracks)

    eng2 = TrackingEngine(_cfg(), sc.cameras, device="cpu")
    saved_frame = load_snapshot(eng2, path)
    assert saved_frame == 2
    assert len(eng2.assoc.registry.tracks) == n_tracks
    assert eng2.assoc.best_solution == eng.assoc.best_solution
    for f in eng.state2d._fields:
        a, b = getattr(eng.state2d, f), getattr(eng2.state2d, f)
        for x, y in (zip(a, b) if f == "frames_lo" else [(a, b)]):
            assert y.device == eng2.device and torch.equal(x, y)
    r = eng2.process_frame(frames[3], sc.detections[3], frame_idx=3)
    assert r.frame_idx == 3


def test_snapshot_restores_results_for_deferred_eval(scene, tmp_path):
    """Mirror of tests/test_aux.py::TestCheckpoint::
    test_snapshot_restores_results_for_deferred_eval."""
    sc, frames = scene
    eng = TrackingEngine(_cfg(), sc.cameras, pipelined=True, device="cpu")
    for t in range(4):
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
    path = str(tmp_path / "snap.pkl")
    save_snapshot(eng, path)       # drains the pipeline first
    assert eng.assoc.completed_frame == 3
    assert len(eng.results) == 4

    eng2 = TrackingEngine(_cfg(), sc.cameras, pipelined=True, device="cpu")
    load_snapshot(eng2, path)
    assert eng2.assoc.completed_frame == 3
    assert len(eng2.results) == len(eng.results)
    for ra, rb in zip(eng.results, eng2.results):
        assert ra.frame_idx == rb.frame_idx
        assert ra.ids == rb.ids
    for td in range(4):
        a = eng.deferred_result(td)
        b = eng2.deferred_result(td)
        assert a.ids == b.ids
        np.testing.assert_array_equal(a.points, b.points)
