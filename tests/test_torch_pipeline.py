"""The port's whole main path against the JAX package on the
tests/test_pipeline_e2e.py scene (2 cameras, 256x192, 10 frames).

The JAX engine runs its LK on the Pallas kernel in interpret mode; the
port's solver draws the JAX package's exact random fields (threefry
splits per solved frame, injected as a field source).  Every frame's 2D
output must be equal, and every Track3DResult must carry the same ids
and the same points within 1 mm.  The port's own sequential and
pipelined modes must agree exactly."""

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu import config as jcfg
from mcmtt_opticalflow_tpu.data import make_scenario
from mcmtt_opticalflow_tpu.eval import ClearMotAccumulator
from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine as JaxEngine
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario as t_make_scenario
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from torch_parity import JaxFieldSource, pallas_interpret

torch.set_num_threads(2)

NUM_FRAMES = 10
ARENA = 5000.0
POINT_ATOL_MM = 1.0


def _cfg(mod):
    return mod.EngineConfig(
        num_cameras=2, image_width=256, image_height=192,
        tracker2d=mod.Tracker2DConfig(max_detections=16, max_trackers=32,
                                      max_features=16, lk_window=8,
                                      lk_pyramid_levels=2, lk_iterations=6),
        solver=mod.SolverConfig(num_replicas=4, max_vertices=64,
                                solutions_per_replica=8, max_iterations=200))


def _record_2d(eng):
    """Capture the (ids, boxes, mask) each frame hands the associator."""
    seen = []
    orig = eng.assoc.step

    def step(frame_idx, ids, boxes, mask, rgb):
        seen.append((np.array(ids), np.array(boxes), np.array(mask)))
        return orig(frame_idx, ids, boxes, mask, rgb)

    eng.assoc.step = step
    return seen


@pytest.fixture(scope="module")
def scene():
    sc = make_scenario(num_cameras=2, num_frames=NUM_FRAMES, num_people=3,
                       image_size=(256, 192), arena=ARENA, seed=11)
    frames = [np.stack(sc.frames(t)) for t in range(NUM_FRAMES)]
    return sc, frames


@pytest.fixture(scope="module")
def runs(scene):
    sc, frames = scene
    cfg = _cfg(jcfg)
    with pallas_interpret():
        jeng = JaxEngine(cfg, sc.cameras)
        jseen = _record_2d(jeng)
        jres = [jeng.process_frame(frames[t], sc.detections[t], frame_idx=t)
                for t in range(NUM_FRAMES)]

    tsc = t_make_scenario(num_cameras=2, num_frames=NUM_FRAMES,
                          num_people=3, image_size=(256, 192), arena=ARENA,
                          seed=11)
    teng = TrackingEngine(_cfg(tcfg), tsc.cameras, device="cpu")
    teng.assoc.field_source = JaxFieldSource(teng.cfg.solver.seed)
    tseen = _record_2d(teng)
    tres = [teng.process_frame(frames[t], tsc.detections[t], frame_idx=t)
            for t in range(NUM_FRAMES)]
    return jseen, jres, tseen, tres, teng


def test_2d_outputs_equal_every_frame(runs):
    jseen, _, tseen, _, _ = runs
    assert len(jseen) == len(tseen) == NUM_FRAMES
    for t, (j, g) in enumerate(zip(jseen, tseen)):
        np.testing.assert_array_equal(g[2], j[2], err_msg=f"mask, frame {t}")
        m = j[2]
        np.testing.assert_array_equal(g[0][m], j[0][m],
                                      err_msg=f"ids, frame {t}")
        np.testing.assert_allclose(g[1][m], j[1][m], rtol=0, atol=1e-3,
                                   err_msg=f"boxes, frame {t}")


def test_2d_outputs_come_from_the_2d_program(runs):
    """Without a mesh the 2D outputs compared above are the 2D program's
    (models/pipeline.py::Tracker2DProgram, run eagerly from its static
    buffers on the CPU): its buffers hold the last frame, and the
    engine's 2D state is those buffers."""
    teng = runs[4]
    prog = teng._progs2d[0]
    assert prog is not None and teng.state2d_groups == [prog.state]
    assert int(prog.frame_idx) == NUM_FRAMES - 1
    assert prog.graph.out.shape == (2, 32, 6)
    assert torch.equal(prog.state.frame_count, torch.full(
        (2,), teng.cfg.tracker2d.backtrack_interval, dtype=torch.int32))


def test_track3d_results_equal_every_frame(runs):
    _, jres, _, tres, _ = runs
    first_diff = None
    for t, (j, g) in enumerate(zip(jres, tres)):
        assert j.frame_idx == g.frame_idx == t
        same = (j.ids == g.ids and np.asarray(j.points).shape
                == np.asarray(g.points).shape
                and np.allclose(g.points, j.points, rtol=0,
                                atol=POINT_ATOL_MM))
        if not same and first_diff is None:
            first_diff = t
    assert first_diff is None, (
        f"first divergent frame {first_diff}: jax ids "
        f"{jres[first_diff].ids} port ids {tres[first_diff].ids}")
    assert any(len(r.ids) > 0 for r in tres[2:])


def test_clearmot_equal(runs, scene):
    sc, _ = scene
    _, jres, _, tres, _ = runs
    gx, gy = sc.gt_matrices()
    zone = (-ARENA * 2, -ARENA * 2, ARENA * 2, ARENA * 2)
    motas = []
    for res in (jres, tres):
        acc = ClearMotAccumulator(gx, gy, zone)
        for r in res:
            acc.set_result(r.frame_idx,
                           [(i, p[0], p[1]) for i, p in zip(r.ids, r.points)])
        motas.append(acc.evaluate().mota)
    assert motas[0] > 0.0
    assert motas[1] == pytest.approx(motas[0], abs=1e-9)


def test_pipelined_matches_sequential(scene):
    """Frame pipelining reorders work but must not change any result
    (mirrors tests/test_pipeline_e2e.py::test_pipelined_matches_sequential),
    on the same default solver stream in both engines."""
    _, frames = scene
    sc = t_make_scenario(num_cameras=2, num_frames=NUM_FRAMES, num_people=3,
                         image_size=(256, 192), arena=ARENA, seed=11)
    cfg = _cfg(tcfg)
    seq = TrackingEngine(cfg, sc.cameras, device="cpu")
    pipe = TrackingEngine(cfg, sc.cameras, pipelined=True, device="cpu")
    seq_results, pipe_results = [], []
    for t in range(6):
        seq_results.append(seq.process_frame(frames[t], sc.detections[t],
                                             frame_idx=t))
        r = pipe.process_frame(frames[t], sc.detections[t], frame_idx=t)
        if r is not None:
            pipe_results.append(r)
    while True:
        tail = pipe.flush()
        if tail is None:
            break
        pipe_results.append(tail)
    assert len(pipe_results) == len(seq_results)
    for rs, rp in zip(seq_results, pipe_results):
        assert rs.frame_idx == rp.frame_idx
        assert rs.ids == rp.ids
        np.testing.assert_array_equal(rs.points, rp.points)
