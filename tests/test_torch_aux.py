"""The port's tracing and carried host utilities: `profile_trace` and
`summarize_trace` on the CPU, and the checks of tests/test_aux.py for the
port's copies of viz/ and utils/ (overlay drawing, tiling, PPM and AVI
writing, colours, math helpers, state dumps read back by the port's own
readers and written from the port's own track registry)."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.special import erfc as scipy_erfc

from mcmtt_opticalflow_tpu_torch.config import (EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.utils import (FrameLog, StageTimer,
                                               generate_colors, get_logger,
                                               profile_trace)
from mcmtt_opticalflow_tpu_torch.utils.timing import summarize_trace
from mcmtt_opticalflow_tpu_torch.viz import (draw_overlay, draw_top_view,
                                             save_ppm, tile_frames)

torch.set_num_threads(2)


class TestProfileTrace:
    def test_trace_written_and_summarised(self, tmp_path):
        logdir = str(tmp_path / "prof")
        a = torch.rand(64, 64)
        with profile_trace(logdir):
            with torch.profiler.record_function("stage_under_test"):
                for _ in range(3):
                    a = a @ a / 64.0
        path = os.path.join(logdir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "stage_under_test" for e in events)
        assert any("mm" in str(e.get("name")) for e in events)
        for s in (summarize_trace(path), summarize_trace(logdir)):
            assert 0.0 <= s.busy_share <= 1.0
            assert s.device_ms >= 0.0
            assert isinstance(s.kernel_counts, dict)
            if not torch.cuda.is_available():
                assert s.busy_share == 0.0 and s.top_kernels == []

    def test_summary_of_device_events(self, tmp_path):
        """Busy share merges overlapping device events over the window
        from the first to the last event; kernels rank by time."""
        ev = [{"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0,
               "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50, "dur": 30},
              {"ph": "X", "cat": "gpu_memcpy", "name": "cp", "ts": 90,
               "dur": 10},
              {"ph": "i", "name": "marker", "ts": 500}]
        p = tmp_path / "trace.json"
        p.write_text(json.dumps({"traceEvents": ev}))
        s = summarize_trace(str(p), top=1)
        assert s.busy_share == pytest.approx(0.7)
        assert s.device_ms == pytest.approx(0.07)
        assert s.top_kernels == [("k1", pytest.approx(0.04), 2)]
        assert s.kernel_counts == {"k1": 2, "k2": 1}


class TestVizAndUtils:
    def test_overlay_and_tile(self):
        frame = np.zeros((32, 48, 3), np.float32)
        out = draw_overlay(frame, [[4, 4, 10, 12]], [3])
        assert out.sum() > 0
        tiled = tile_frames([frame, frame, frame, frame])
        assert tiled.shape == (64, 96, 3)

    def test_top_view_and_ppm(self, tmp_path):
        pts = [np.asarray([[100.0, 200.0, 0.0]]) for _ in range(5)]
        ids = [[1]] * 5
        img = draw_top_view(pts, ids, extent=1000.0, size=64)
        assert img.shape == (64, 64, 3)
        p = str(tmp_path / "x.ppm")
        save_ppm(p, img)
        assert os.path.getsize(p) > 64 * 64 * 3

    def test_flow_vectors(self):
        from mcmtt_opticalflow_tpu_torch.viz.overlay import draw_flow_vectors
        img = np.zeros((32, 48, 3), np.float32)
        feats = np.asarray([[20.0, 10.0], [30.0, 20.0], [5.0, 5.0]])
        valid = np.asarray([True, True, False])
        out = draw_flow_vectors(img, feats, valid, np.asarray([6.0, 3.0]))
        assert out.sum() > 0 and img.sum() == 0
        assert out[3:8, 0:8].sum() == 0
        assert out[8, 16].sum() > 0

    def test_avi_writer_clip(self, tmp_path):
        """A short overlay clip from a synthetic scene (MJPG when PIL is
        importable, else raw frames: both are valid AVIs)."""
        from mcmtt_opticalflow_tpu_torch.viz.video import (
            AviWriter, read_avi_frame_count)
        sc = make_scenario(num_cameras=2, num_frames=5, num_people=2,
                           image_size=(64, 48), seed=0)
        path = str(tmp_path / "clip.avi")
        with AviWriter(path, fps=7.0) as wr:
            for t in range(5):
                views = [draw_overlay(f, sc.detections[t][c],
                                      range(len(sc.detections[t][c])))
                         for c, f in enumerate(sc.frames(t))]
                wr.add(tile_frames(views))
        assert read_avi_frame_count(path) == 5
        data = open(path, "rb").read()
        assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
        assert b"movi" in data and b"idx1" in data

    def test_avi_writer_raw_mode(self, tmp_path):
        from mcmtt_opticalflow_tpu_torch.viz.video import (
            AviWriter, read_avi_frame_count)
        path = str(tmp_path / "raw.avi")
        with AviWriter(path, fps=10.0, force_raw=True) as wr:
            for _ in range(3):
                wr.add(np.random.rand(24, 30, 3).astype(np.float32))
        assert read_avi_frame_count(path) == 3
        assert b"DIB " in open(path, "rb").read()[:120]

    def test_colors_distinct(self):
        c = generate_colors(16)
        assert c.shape == (16, 3)
        assert len({tuple(np.round(x, 3)) for x in c}) == 16

    def test_stage_timer_and_logs(self, tmp_path):
        t = StageTimer()
        with t.stage("a"):
            pass
        assert "a" in t.summary()
        log = FrameLog(str(tmp_path / "m.jsonl"))
        log.write(3, fps=1.5)
        log.close()
        rec = json.loads((tmp_path / "m.jsonl").read_text())
        assert rec["frame"] == 3 and rec["fps"] == 1.5
        assert get_logger("mcmtt_torch_test").handlers


class TestMathUtils:
    def test_nchoosek(self):
        from mcmtt_opticalflow_tpu_torch.utils.math import nchoosek
        assert nchoosek(4, 2) == [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3],
                                  [2, 3]]
        assert nchoosek(2, 3) == []

    def test_erfc_matches_device_erfc(self):
        # the host erfc (scipy) against the float32 torch.special.erfc the
        # port's cost model uses on the device
        from mcmtt_opticalflow_tpu_torch.utils.math import erf, erfc
        for x in [-2.0, -0.5, 0.0, 0.3, 1.0, 2.5]:
            dev = float(torch.special.erfc(torch.tensor(x)))
            assert abs(dev - erfc(x)) < 1e-5
            assert erfc(x) == scipy_erfc(x)
            assert abs(erf(x) + erfc(x) - 1.0) < 1e-12

    def test_histogram_channel(self):
        from mcmtt_opticalflow_tpu_torch.utils.math import histogram_channel
        h = histogram_channel(np.asarray([0, 15, 16, 255]), 16)
        assert h[0] == 2 and h[1] == 1 and h[15] == 1


class TestDumps:
    def test_track2d_result_round_trip(self, tmp_path):
        from mcmtt_opticalflow_tpu_torch.data.pets import read_track2d_result
        from mcmtt_opticalflow_tpu_torch.utils.dumps import \
            dump_track2d_result
        p = str(tmp_path / "t2d.txt")
        dump_track2d_result(p, 2, 17, np.asarray([4, 9]),
                            np.asarray([[1.0, 2, 3, 4], [5.0, 6, 7, 8]]),
                            np.asarray([True, True]),
                            np.asarray([[1.0, 2, 3, 4]]),
                            np.asarray([True]))
        cam, frame, ids, boxes = read_track2d_result(p)
        assert cam == 2 and frame == 17
        assert list(ids) == [4, 9]
        np.testing.assert_allclose(boxes[1], [5.0, 6, 7, 8])

    def test_dumps_of_an_engine_registry(self, tmp_path):
        """dump_tracks / dump_hypotheses / dump_trees read the port's
        track registry (models/trees.py) and hypotheses."""
        from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
        from mcmtt_opticalflow_tpu_torch.utils.dumps import (dump_hypotheses,
                                                             dump_tracks,
                                                             dump_trees)
        sc = make_scenario(num_cameras=2, num_frames=5, num_people=3,
                           image_size=(256, 192), arena=3000.0, seed=5)
        cfg = EngineConfig(
            num_cameras=2, image_width=256, image_height=192,
            tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                                      max_features=16, lk_window=8,
                                      lk_pyramid_levels=2, lk_iterations=4),
            solver=SolverConfig(num_replicas=2, max_vertices=32,
                                solutions_per_replica=4, max_iterations=60))
        eng = TrackingEngine(cfg, sc.cameras, device="cpu")
        for t in range(5):
            eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                              frame_idx=t)
        a = eng.assoc
        ids = sorted(a.registry.tracks)
        assert ids, "the scene produced no tracks"
        dump_tracks(str(tmp_path / "tracks.txt"), a.registry, ids)
        dump_hypotheses(str(tmp_path / "hyp.txt"), a.prev_hypotheses, 4)
        dump_trees(str(tmp_path / "trees.txt"), a.registry)
        tracks = (tmp_path / "tracks.txt").read_text()
        assert tracks.startswith(f"numTracks:{len(ids)}\n")
        assert tracks.count("reconstructions:{") == len(ids)
        assert "frameIndex:4" in (tmp_path / "hyp.txt").read_text()
        trees = (tmp_path / "trees.txt").read_text()
        assert trees.startswith(f"numTrees:{len(a.registry.trees)}\n")
