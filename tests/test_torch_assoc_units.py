"""The associator's unit cases (tests/test_assoc_units.py) on the port:
each case of that file runs on the port's `Associator3D(...,
device="cpu")` and is held to the JAX package's `Associator3D` on the
same inputs (the scene of the same seed, the JAX scene's cameras carried
across with convert.py, the same ids, boxes, mask and RGB frames as the
JAX file's `feed_frame` builds them, the port drawing the JAX
associator's exact solver fields: `torch_parity.JaxFieldSource`).

The JAX file mutates one module-scoped associator across its tests.
Here the two associators run in lockstep in one module fixture that
records every frame's results, counters (`diag`) and registry state, and
each test asserts on the records, so no test depends on another's order.

Tolerances:
- ids, track ids, vis ids, `diag` counters, tracklet tables and their
  associability maps, combinations, bool matrices, dump files,
  `pool_dropped_total`: equal;
- points: within 1e-3 mm (reprojections within 1e-3 px); the
  reconstructions of `TestHeadMode` within the JAX file's own
  tolerances;
- probabilities (`gt_prob`, a hypothesis's probability): within 1e-6;
- costs and log-likelihoods: within 1e-6 relative.

TestExperimentRunner's `test_k_sweep_runs` is held to the JAX package
by tests/test_torch_dataset.py::test_k_sweep_matches_jax_on_reference_layout
and is not repeated here; its other two cases are.

CPU: `python -m pytest tests/test_torch_assoc_units.py -q`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu import config as jcfg
from mcmtt_opticalflow_tpu.data import make_scenario
from mcmtt_opticalflow_tpu.models.associator3d import \
    Associator3D as JaxAssociator3D
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch import convert
from mcmtt_opticalflow_tpu_torch.models.associator3d import (
    Associator3D, _compat_from, compat_matrix, incompat_rows)
from torch_parity import JaxFieldSource

torch.set_num_threads(2)

POINT_ATOL_MM = 1e-3
PROJ_ATOL_PX = 1e-3
PROB_ATOL = 1e-6
COST_RTOL = 1e-6
CAP = 16


def small_cfg(mod, num_cams=2, w=256, h=192, assoc=None, solver=None):
    """tests/test_assoc_units.py::small_cfg from either package's config
    module, with fields of assoc3d / solver replaced."""
    cfg = mod.EngineConfig(
        num_cameras=num_cams, image_width=w, image_height=h,
        tracker2d=mod.Tracker2DConfig(max_detections=8, max_trackers=16,
                                      max_features=16),
        solver=mod.SolverConfig(num_replicas=2, max_vertices=32,
                                solutions_per_replica=4, max_iterations=100,
                                solve_batch=4))
    if assoc:
        cfg = dataclasses.replace(
            cfg, assoc3d=dataclasses.replace(cfg.assoc3d, **assoc))
    if solver:
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, **solver))
    return cfg


def port_cameras(sc):
    return convert.cameras_from_numpy(
        [{f: np.asarray(getattr(c, f)) for f in c._fields}
         for c in sc.cameras])


class Pair:
    """The JAX associator and the port's on one scene, stepped together."""

    def __init__(self, sc, size=(256, 192), **kw):
        self.sc = sc
        c = len(sc.cameras)
        self.j = JaxAssociator3D(small_cfg(jcfg, c, *size, **kw), sc.cameras)
        self.t = Associator3D(small_cfg(tcfg, c, *size, **kw),
                              port_cameras(sc), device="cpu")
        self.t.field_source = JaxFieldSource(self.t.cfg.solver.seed)

    def step(self, t, ids, boxes, mask):
        rgb = np.stack(self.sc.frames(t))
        jr = self.j.step(t, ids.copy(), boxes.copy(), mask.copy(),
                         jnp.asarray(rgb))
        tr = self.t.step(t, ids, boxes, mask, rgb)
        return jr, tr

    def feed(self, t, next_id=None, cams=None):
        """tests/test_assoc_units.py::feed_frame, to both; `cams` the
        cameras that report (default all)."""
        return self.step(t, *frame_inputs(self.sc, t, next_id, cams))


def frame_inputs(sc, t, next_id=None, cams=None, ids_fn=None):
    c = len(sc.cameras)
    ids = np.zeros((c, CAP), np.int64)
    boxes = np.zeros((c, CAP, 4), np.float32)
    mask = np.zeros((c, CAP), bool)
    for ci in range(c) if cams is None else cams:
        for j, b in enumerate(sc.detections[t][ci][:CAP]):
            ids[ci, j] = (1000 * t + j if next_id == "rotate" else
                          ids_fn(t, j) if ids_fn else j)
            boxes[ci, j] = b
            mask[ci, j] = True
    return ids, boxes, mask


def snapshot(a):
    """What the cases read of an associator after a frame."""
    reg = a.registry.tracks
    return {
        "tracklets": [list(x) for x in a.active_tracklets],
        "assoc": [{k: dict(tk.assoc) for k, tk in a.tracklets[c].items()}
                  for c in range(a.num_cams)],
        "tracks": {tid: (tuple(tr.combination), tr.tree_id, bool(tr.valid))
                   for tid, tr in reg.items()},
        "gt_prob": {tid: tr.gt_prob for tid, tr in reg.items()},
        "cost": {tid: tr.total_cost() for tid, tr in reg.items()},
        "hyps": [(list(h.selected), list(h.related), h.log_likelihood,
                  h.probability, h.valid) for h in a.prev_hypotheses],
        "diag": dict(a.diag),
        "active_tracks": list(a.active_tracks),
        "dropped": a.pool_dropped_total,
        "vis_id_map": dict(a.vis_id_map)}


def assert_same_result(jr, tr):
    assert (tr is None) == (jr is None)
    if jr is None:
        return
    assert tr.frame_idx == jr.frame_idx
    assert tr.ids == jr.ids and tr.track_ids == jr.track_ids
    assert tr.vis_ids == jr.vis_ids
    np.testing.assert_allclose(np.asarray(tr.points), np.asarray(jr.points),
                               rtol=0, atol=POINT_ATOL_MM)


def assert_same_state(js, ts, probs=True):
    for k in ("tracklets", "assoc", "tracks", "diag", "active_tracks",
              "dropped", "vis_id_map"):
        assert ts[k] == js[k], k
    assert ts["gt_prob"].keys() == js["gt_prob"].keys()
    if probs:
        for tid, p in js["gt_prob"].items():
            assert abs(ts["gt_prob"][tid] - p) <= PROB_ATOL, tid
        for tid, c in js["cost"].items():
            assert ts["cost"][tid] == pytest.approx(c, rel=COST_RTOL), tid
        assert len(ts["hyps"]) == len(js["hyps"])
        for (ts_, tr_, tl, tp, tv), (js_, jr_, jl, jp, jv) in zip(
                ts["hyps"], js["hyps"]):
            assert (ts_, tr_, tv) == (js_, jr_, jv)
            assert tl == pytest.approx(jl, rel=COST_RTOL)
            assert abs(tp - jp) <= PROB_ATOL


@pytest.fixture(scope="module")
def lockstep():
    """tests/test_assoc_units.py's module scenario (2 cameras, 256x192,
    3 people, seed 11) through both associators for its 6 frames: per
    frame (JAX result, port result, JAX snapshot, port snapshot), and
    the pair."""
    sc = make_scenario(num_cameras=2, num_frames=6, num_people=3,
                       image_size=(256, 192), arena=2000.0, seed=11)
    pair = Pair(sc)
    records = []
    for t in range(6):
        jr, tr = pair.feed(t)
        records.append((jr, tr, snapshot(pair.j), snapshot(pair.t)))
    return pair, records


@pytest.mark.smoke
class TestAssociator:
    def test_first_frame_builds_tracklets_and_seeds(self, lockstep):
        pair, records = lockstep
        jr, tr, js, ts = records[0]
        assert_same_result(jr, tr)
        assert_same_state(js, ts)
        n0, n1 = len(ts["tracklets"][0]), len(ts["tracklets"][1])
        assert n0 >= 1 and n1 >= 1 and n0 + n1 >= 3
        assert len(ts["tracks"]) >= 2
        first = ts["tracklets"][0][0]
        assert 1 in ts["assoc"][0][first]

    def test_cross_camera_combination_found(self, lockstep):
        _, records = lockstep
        for jr, tr, js, ts in records[1:3]:
            assert_same_result(jr, tr)
            assert_same_state(js, ts)
        multi = [c for c, _, _ in records[2][3]["tracks"].values()
                 if sum(x >= 0 for x in c) >= 2]
        assert multi, "no multi-camera track hypothesis was formed"

    def test_best_solution_positions_near_gt(self, lockstep):
        pair, records = lockstep
        jr, tr, js, ts = records[3]
        assert_same_result(jr, tr)
        assert_same_state(js, ts)
        gt = pair.sc.gt_xy[3]
        gt = gt[~np.isnan(gt[:, 0])]
        assert len(tr.ids) >= 1
        for p in tr.points:
            assert np.linalg.norm(gt - p[:2], axis=-1).min() < 600.0

    def test_gtprob_accumulated(self, lockstep):
        _, records = lockstep
        jr, tr, js, ts = records[4]
        assert_same_result(jr, tr)
        assert_same_state(js, ts)
        assert any(p > 0 for p in ts["gt_prob"].values())

    def test_hypotheses_sorted_and_probabilities_normalised(self, lockstep):
        _, records = lockstep
        jr, tr, js, ts = records[5]
        assert_same_result(jr, tr)
        assert_same_state(js, ts)
        assert ts["hyps"]
        lls = [h[2] for h in ts["hyps"]]
        assert lls == sorted(lls, reverse=True)


class TestCompatibility:
    """The full-history tracklet-share relation and the device
    compatibility gates (ref CheckIncompatibility,
    Associator3D.cpp:2411-2503): the port's `_shared_matrix`,
    `compat_matrix` and its row-split `incompat_rows` against the JAX
    associator's `_shared_matrix` and `_compat_matrix`."""

    @staticmethod
    def _track_with_hist(assoc, trees, tid, tree_id, hists):
        c = assoc.num_cams
        tr = trees.Track(
            id=tid, tree_id=tree_id, parent=None, num_cams=c,
            combination=tuple([-1] * c), time_start=0, time_end=0,
            time_generation=0, tid_hist=[list(h) for h in hists],
            points=np.zeros((1, 3)), smoothed=np.zeros((1, 3)),
            velocity=np.zeros((1, 3)), raw_points=np.zeros((1, c, 3)),
            raw_mask=np.zeros((1, c), bool), max_error=np.zeros(1),
            is_meas=np.ones(1, bool), cost_recon_pos=np.zeros(1),
            cost_link_pos=np.zeros(1), last_t_end=np.zeros(c, np.int64),
            last_t_loc=np.zeros((c, 3)), last_sens=np.zeros(c),
            last_rgb=np.zeros((c, 48)))
        assoc.registry.tracks[tid] = tr
        return tr

    @pytest.fixture(scope="class")
    def pair(self):
        sc = make_scenario(num_cameras=2, num_frames=2, num_people=1,
                           image_size=(128, 96), arena=2000.0, seed=0)
        return Pair(sc, size=(128, 96))

    def test_shared_id_beyond_16_slot_window_detected(self, pair):
        """A tracklet id shared only at the START of a >16-entry history
        still marks the pair incompatible, in both packages alike."""
        from mcmtt_opticalflow_tpu.models import trees as jtrees
        from mcmtt_opticalflow_tpu_torch.models import trees as ttrees
        got = []
        for assoc, trees in ((pair.j, jtrees), (pair.t, ttrees)):
            self._track_with_hist(assoc, trees, 1, 10,
                                  [list(range(20)), []])
            self._track_with_hist(assoc, trees, 2, 11,
                                  [[0] + list(range(100, 119)), []])
            self._track_with_hist(assoc, trees, 3, 12,
                                  [list(range(200, 220)), []])
            got.append(assoc._shared_matrix([1, 2, 3], 4))
        jshared, shared = got
        assert shared.dtype == jshared.dtype
        np.testing.assert_array_equal(shared, jshared)
        assert shared[0, 1] and shared[1, 0]
        assert not shared[0, 2] and not shared[1, 2]
        assert not shared[3].any() and not shared[:, 3].any()

    @staticmethod
    def _both(pair, tree_ids, shared, pos, have, valid):
        """The JAX `_compat_matrix`, the port's `compat_matrix`, and the
        port's matrix from `incompat_rows` of two row chunks (the mesh
        rule), as bool arrays; the chunks' rows equal the whole's."""
        want = np.asarray(pair.j._compat_matrix(
            jnp.asarray(tree_ids), jnp.asarray(shared), jnp.asarray(pos),
            jnp.asarray(have), jnp.asarray(valid)))
        t = [torch.from_numpy(np.asarray(x)) for x in
             (tree_ids, shared, pos, have, valid)]
        acfg = pair.t.acfg
        got = compat_matrix(*t, acfg).numpy()
        cols = (t[0], t[2], t[3])
        n = len(tree_ids)
        whole = incompat_rows(*cols, cols, acfg)
        chunks = [incompat_rows(*[x[lo:hi] for x in cols], cols, acfg)
                  for lo, hi in ((0, n // 2), (n // 2, n))]
        assert torch.equal(torch.cat(chunks), whole)
        split = _compat_from(t[1] | torch.cat(chunks), t[4]).numpy()
        return want, got, split

    def test_device_compat_gates(self, pair):
        w = pair.t.win
        assert w == pair.j.win
        n = 4
        tree_ids = np.asarray([0, 1, 2, 3], np.int32)
        shared = np.zeros((n, n), bool)
        shared[0, 1] = shared[1, 0] = True
        pos = np.zeros((n, w, 3), np.float32)
        pos[0, :, 0] = 0.0
        pos[1, :, 0] = 10000.0
        pos[2, :, 0] = 20000.0
        pos[2, :, 1] = np.arange(w) * 10.0
        pos[3, :, 0] = np.linspace(19900.0, 20100.0, w)
        pos[3, :, 1] = np.arange(w) * 10.0 + 5.0
        have = np.ones((n, w), bool)
        valid = np.ones((n,), bool)
        want, got, split = self._both(pair, tree_ids, shared, pos, have,
                                      valid)
        assert got.dtype == want.dtype == split.dtype == bool
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(split, want)
        assert not got[0, 1], "shared-history pair must be incompatible"
        assert got[0, 2], "distant parallel tracks are compatible"
        assert not got[2, 3], "crossing nearby tracks are incompatible"

    def test_crossing_ignored_when_far_apart(self, pair):
        w = pair.t.win
        n = 2
        tree_ids = np.asarray([0, 1], np.int32)
        shared = np.zeros((n, n), bool)
        pos = np.zeros((n, w, 3), np.float32)
        pos[0, 0] = [-5000.0, -5000.0, 0.0]
        pos[0, 1] = [5000.0, 5000.0, 0.0]
        pos[1, 0] = [-5000.0, 5000.0, 0.0]
        pos[1, 1] = [5000.0, -5000.0, 0.0]
        have = np.zeros((n, w), bool)
        have[:, :2] = True
        valid = np.ones((n,), bool)
        want, got, split = self._both(pair, tree_ids, shared, pos, have,
                                      valid)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(split, want)
        assert got[0, 1], \
            "far-apart crossing must be skipped like the reference"


class TestDumps:
    def test_dump_files(self, lockstep, tmp_path):
        """The four dump files of the lockstep run's last state, written
        by each package's utils/dumps.py: equal byte for byte."""
        from mcmtt_opticalflow_tpu.utils import dumps as jdumps
        from mcmtt_opticalflow_tpu_torch.utils import dumps as tdumps
        pair, _ = lockstep
        texts = []
        for name, assoc, dumps in (("jax", pair.j, jdumps),
                                   ("port", pair.t, tdumps)):
            d = tmp_path / name
            d.mkdir()
            dumps.dump_tracks(str(d / "tracks.txt"), assoc.registry,
                              list(assoc.registry.tracks)[:5])
            dumps.dump_hypotheses(str(d / "hyp.txt"), assoc.prev_hypotheses,
                                  5)
            dumps.dump_trees(str(d / "trees.txt"), assoc.registry)
            dumps.dump_track2d_result(
                str(d / "t2d.txt"), 0, 5, np.asarray([1]),
                np.asarray([[1.0, 2, 3, 4]]), np.asarray([True]),
                np.asarray([[1.0, 2, 3, 4]]), np.asarray([True]))
            texts.append({f: (d / f).read_bytes() for f in
                          ("tracks.txt", "hyp.txt", "trees.txt", "t2d.txt")})
        jax_t, port_t = texts
        assert port_t == jax_t
        assert b"costTotal" in port_t["tracks.txt"]
        assert b"logLikelihood" in port_t["hyp.txt"]
        assert b"bConfirmed" in port_t["trees.txt"]
        assert b"camIdx:0" in port_t["t2d.txt"]
        assert b"trackerRects:1" in port_t["t2d.txt"]


class TestExperimentRunner:
    def test_finalize_backfill_scores_every_frame(self):
        """A perfect fake engine scores zero misses at every deferred
        window (ref Associator3D.cpp:364-372) through both packages'
        run_sequence, with equal results window by window."""
        from mcmtt_opticalflow_tpu.eval import experiment as jexp
        from mcmtt_opticalflow_tpu.models import associator3d as jassoc
        from mcmtt_opticalflow_tpu_torch.eval import experiment as texp
        from mcmtt_opticalflow_tpu_torch.models import associator3d as tassoc

        t_total, n_people = 8, 2
        gx = np.arange(1, t_total + 1)[:, None] * np.ones((1, n_people)) * 100
        gy = gx + np.arange(n_people)[None, :] * 500

        def fake_engine(result_cls):
            class FakeEngine:
                class _A:
                    frame_idx = -1
                assoc = _A()

                def process_frame(self, frames, dets, frame_idx):
                    self.assoc.frame_idx = frame_idx

                def deferred_result(self, td):
                    pts = np.stack([gx[td], gy[td], np.zeros(n_people)], -1)
                    return result_cls(frame_idx=td,
                                      ids=list(range(n_people)),
                                      track_ids=list(range(n_people)),
                                      points=pts)
            return FakeEngine()

        zone = (-1e5, -1e5, 1e5, 1e5)
        runs = [exp.run_sequence(fake_engine(mod.Track3DResult),
                                 lambda t: None, lambda t: None, t_total,
                                 (gx, gy), zone, deferred_windows=4)
                for exp, mod in ((jexp, jassoc), (texp, tassoc))]
        jax_w, port_w = runs
        assert sorted(port_w) == sorted(jax_w)
        for w, res in port_w.items():
            assert dataclasses.asdict(res) == dataclasses.asdict(jax_w[w])
            assert res.missed == 0, (w, res.missed)
            assert res.mota == 1.0, (w, res.mota)

    def test_result_file_format(self, tmp_path):
        """EvaluationResult.save writes the reference's result-file text
        (ref PrintResultToFile, Evaluator.cpp:1107-1137), the same text
        in both packages."""
        from mcmtt_opticalflow_tpu.eval.clearmot import \
            EvaluationResult as JaxResult
        from mcmtt_opticalflow_tpu_torch.eval.clearmot import \
            EvaluationResult

        kw = dict(mota=0.855, motp=0.912, motal=0.86, recall=0.95,
                  precision=0.97, missed=12, false_positives=7,
                  id_switches=2, most_tracked=5, partially_tracked=1,
                  most_lost=0, fragments=3, far=0.23, miss_per_gt=0.05,
                  fa_per_gt=0.03)
        texts = []
        for name, cls in (("jax", JaxResult), ("port", EvaluationResult)):
            p = tmp_path / name / "K003" / "run_evaluation_K003_W000.txt"
            cls(**kw).save(str(p))
            texts.append(p.read_text())
        assert texts[1] == texts[0]
        lines = texts[1].splitlines()
        assert lines[0] == "Evaluating PETS on ground plane..."
        assert lines[1].startswith("| Recl Prcn  FAR|")
        assert "%4i%4i%4i" % (7, 12, 2) in lines[2]
        assert "%5i" % 21 in lines[2]
        assert lines[2].startswith("| 95.0 97.0 0.23|  5  1  0|")


class TestHeadMode:
    """Head detection mode: batched LS line-meet reconstruction
    (ref Associator3D.cpp:857-884 + NViewPointReconstruction :930-982)."""

    def test_batch_matches_scalar_reconstruction(self):
        """The port's _reconstruct_batch agrees with its _reconstruct on
        every combination, in both modes and both sensitivity settings
        (the JAX file's tolerances), and with the JAX associator's
        _reconstruct_batch on the same tracklets."""
        sc = make_scenario(num_cameras=2, num_frames=3, num_people=3,
                           image_size=(256, 192), arena=2000.0, seed=7)
        for mode, sensit in (("head", False), ("head", True),
                             ("full_body", False), ("full_body", True)):
            pair = Pair(sc, assoc=dict(detection_mode=mode,
                                       consider_sensitivity=sensit))
            pair.feed(0)
            assoc = pair.t
            assert assoc.active_tracklets == pair.j.active_tracklets
            combos = []
            for t0 in assoc.active_tracklets[0]:
                combos.append((t0, -1))
                for t1 in assoc.active_tracklets[1]:
                    combos.append((t0, t1))
            for t1 in assoc.active_tracklets[1]:
                combos.append((-1, t1))
            batch = assoc._reconstruct_batch(combos)
            jbatch = pair.j._reconstruct_batch(combos)
            for combo, got, jgot in zip(combos, batch, jbatch):
                for want in (assoc._reconstruct(combo), jgot):
                    if want is None:
                        assert got is None, (mode, combo)
                        continue
                    assert got is not None, (mode, combo)
                    np.testing.assert_allclose(got[0], want[0], rtol=1e-9,
                                               atol=1e-6)
                    np.testing.assert_allclose(got[1], want[1], rtol=1e-9,
                                               atol=1e-6)
                    np.testing.assert_array_equal(got[2], want[2])
                    np.testing.assert_allclose(got[3], want[3], rtol=1e-9)
                    np.testing.assert_allclose(got[4], want[4], rtol=1e-7,
                                               atol=1e-9)

    def test_head_mode_end_to_end(self):
        """A head-mode run: every frame's result and state equal the JAX
        associator's, and the last frame's tracks lie near GT."""
        sc = make_scenario(num_cameras=2, num_frames=5, num_people=3,
                           image_size=(256, 192), arena=2000.0, seed=11)
        pair = Pair(sc, assoc=dict(detection_mode="head",
                                   consider_sensitivity=False))
        for t in range(5):
            jr, tr = pair.feed(t)
            assert_same_result(jr, tr)
            assert_same_state(snapshot(pair.j), snapshot(pair.t))
        assert len(tr.ids) >= 1
        gt = sc.gt_xy[4]
        gt = gt[~np.isnan(gt[:, 0])]
        for p in tr.points:
            assert np.linalg.norm(gt - p[:2], axis=-1).min() < 800.0


class TestMinTrackletLength:
    def test_short_deactivated_tracklet_kills_branch(self):
        """A track whose tracklet deactivates with duration <
        min_tracklet_length loses its whole branch (ref
        Associator3D.cpp:1399-1404); at the default (1) nothing dies.
        The same tracks survive in both packages."""
        sc = make_scenario(num_cameras=2, num_frames=3, num_people=2,
                           image_size=(256, 192), arena=2000.0, seed=3)
        for min_len, expect_kill in ((2, True), (1, False)):
            pair = Pair(sc, assoc=dict(min_tracklet_length=min_len))
            assert_same_result(*pair.feed(0))
            tracked = [t.id for t in pair.t.registry.tracks.values()
                       if t.combination[0] >= 0]
            assert tracked
            # frame 1: camera 0 sees nothing -> its tracklets deactivate
            # at duration 1
            assert_same_result(*pair.feed(1, cams=[1]))
            assert_same_state(snapshot(pair.j), snapshot(pair.t))
            survivors = []
            for a in (pair.j, pair.t):
                survivors.append([tid for tid in tracked
                                  if tid in a.registry.tracks
                                  and a.registry.tracks[tid].valid])
            assert survivors[1] == survivors[0]
            assert bool(survivors[1]) != expect_kill, survivors


@pytest.mark.smoke
class TestEmptyCamera:
    def test_camera_with_zero_tracklets_while_tracks_live(self):
        """Camera 0 reports nothing for frames 2..6 while 3D tracks live
        on the single-view branch, then comes back: every frame's result
        and state equal the JAX associator's."""
        sc = make_scenario(num_cameras=2, num_frames=8, num_people=3,
                           image_size=(256, 192), arena=2000.0, seed=11)
        pair = Pair(sc)
        for t in range(8):
            jr, tr = pair.feed(t, cams=[1] if 2 <= t <= 6 else None)
            assert tr is not None
            assert_same_result(jr, tr)
            assert_same_state(snapshot(pair.j), snapshot(pair.t))
            if t == 1:
                assert pair.t.active_tracks
            if t == 6:
                assert not pair.t.active_tracklets[0]


@pytest.mark.smoke
class TestBatchedComboEnumeration:
    def test_matches_recursive_enumerator(self):
        """The port's level-BFS enumerator reproduces its recursive DFS
        and the JAX associator's enumerator (same combinations, order and
        cap-prefix) for the seed root and every active track's root
        (ref GenerateTrackletCombinations, Associator3D.cpp:1283-1336)."""
        sc = make_scenario(num_cameras=3, num_frames=5, num_people=4,
                           image_size=(256, 192), arena=2500.0, seed=5)
        pair = Pair(sc)
        rng = np.random.RandomState(0)
        for t in range(5):
            # rotate ids some frames so assoc maps stay non-trivial (one
            # draw a detection, in the JAX file's order)
            rot = {(ci, j): rng.rand() < 0.4 for ci in range(3)
                   for j in range(len(sc.detections[t][ci][:CAP]))}
            ids, boxes, mask = frame_inputs(sc, t)
            for (ci, j), r in rot.items():
                ids[ci, j] = 100 * t + j if r else j
            assert_same_result(*pair.step(t, ids, boxes, mask))
            assoc = pair.t
            nc = assoc.num_cams
            full = [(1 << len(assoc.new_measurements[ci])) - 1
                    for ci in range(nc)]
            roots = [([-1] * nc, list(full))]
            for tid in assoc.active_tracks:
                tr = assoc.registry.tracks.get(tid)
                if tr is None:
                    continue
                maps = list(full)
                for ci in range(nc):
                    if tr.combination[ci] < 0:
                        continue
                    a = assoc.tracklets[ci][tr.combination[ci]].assoc
                    for c2 in range(nc):
                        m = a.get(c2)
                        if m is not None:
                            maps[c2] &= m
                roots.append((list(tr.combination), maps))
            bases = np.asarray([b for b, _ in roots], np.int64)
            masks = np.asarray([m for _, m in roots], np.uint64)
            for cap in (3, 16, 8192):
                expect = []
                for base, maps in roots:
                    out = []
                    assoc._generate_combinations(list(maps), list(base), 0,
                                                 out, cap=cap)
                    expect.append(out)
                batches = [a._generate_combinations_batch(bases, masks, cap)
                           for a in (pair.t, pair.j)]
                got = []
                for batch in batches:
                    assert batch is not None
                    root_idx, combos = batch
                    rows = [[] for _ in roots]
                    for r, row in zip(root_idx.tolist(), combos.tolist()):
                        rows[r].append(tuple(row))
                    got.append(rows)
                assert got[0] == expect, (t, cap)
                assert got[1] == got[0], (t, cap)


@pytest.mark.smoke
class TestCostMemo:
    def test_incremental_cost_matches_array_sums(self):
        """Every live track's incremental total_cost() equals the re-sum
        of its cost arrays (ref GetCost, Associator3D.cpp:2567-2578), and
        the JAX associator's within 1e-6 relative."""
        sc = make_scenario(num_cameras=2, num_frames=6, num_people=3,
                           image_size=(256, 192), arena=2000.0, seed=7)
        pair = Pair(sc)
        for t in range(6):
            assert_same_result(*pair.feed(t))
        assert_same_state(snapshot(pair.j), snapshot(pair.t))
        checked = 0
        for tid, tr in pair.t.registry.tracks.items():
            if tr._cost_cache is None:
                continue
            truth = (tr.cost_enter + tr.cost_trimmed + tr.cost_rgb
                     + tr.cost_exit + float(tr.cost_recon_pos.sum())
                     + float(tr.cost_link_pos.sum()))
            assert abs(tr.total_cost() - truth) < 1e-6 * max(
                1.0, abs(truth)), (tr.id, tr.total_cost(), truth)
            assert pair.j.registry.tracks[tid]._cost_cache is not None
            checked += 1
        assert checked > 0


class TestPoolOverflow:
    def test_pool_overflow_is_rank_pruned_and_counted(self):
        """A solver graph smaller than the candidate pool: both packages
        rank-prune alike and count the same drops."""
        sc = make_scenario(num_cameras=2, num_frames=6, num_people=6,
                           image_size=(256, 192), arena=3000.0, seed=5)
        pair = Pair(sc, solver=dict(max_vertices=8))
        for t in range(6):
            jr, tr = pair.feed(t, next_id="rotate")
            assert_same_result(jr, tr)
            assert pair.t.pool_dropped_total == pair.j.pool_dropped_total
            assert pair.t.pool_dropped_last == pair.j.pool_dropped_last
        assert pair.t.pool_dropped_total > 0
        assert len(tr.ids) >= 1


class TestResultPayload:
    def test_vis_ids_and_recent_projections(self, lockstep):
        """Reusable display ids and per-camera recent-trajectory
        reprojections (ref ResultWithTracks, Associator3D.cpp:3058-3168),
        on the lockstep run (tests/test_assoc_units.py's scene for this
        case is the module's): equal to the JAX associator's, and the
        overlay the port's viz/overlay.py draws equal to the JAX one's."""
        from mcmtt_opticalflow_tpu.viz.overlay import \
            draw_result_trajectories as jax_draw
        from mcmtt_opticalflow_tpu_torch.viz.overlay import \
            draw_result_trajectories
        _, records = lockstep
        for jr, tr, _, _ in records:
            assert tr.vis_ids == jr.vis_ids
            assert len(tr.recent_proj) == len(jr.recent_proj)
            for a, b in zip(tr.recent_points, jr.recent_points):
                np.testing.assert_allclose(a, b, rtol=0, atol=POINT_ATOL_MM)
            for a, b in zip(tr.recent_proj, jr.recent_proj):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=0, atol=PROJ_ATOL_PX)
        r, prev = records[-1][1], records[-2][1]
        assert len(r.vis_ids) == len(r.ids) == len(r.recent_proj)
        assert len(set(r.vis_ids)) == len(r.vis_ids)
        assert all(0 <= v < 64 for v in r.vis_ids)
        for tree_id in set(prev.ids) & set(r.ids):
            assert (prev.vis_ids[prev.ids.index(tree_id)]
                    == r.vis_ids[r.ids.index(tree_id)])
        for obj3d, obj2d in zip(r.recent_points, r.recent_proj):
            assert obj2d.shape == (2, len(obj3d), 2)
        frame = np.zeros((192, 256, 3), np.float32)
        for cam in (0, 1):
            out = draw_result_trajectories(frame, r, cam_idx=cam)
            want = jax_draw(frame, records[-1][0], cam_idx=cam)
            assert out.shape == frame.shape and float(out.max()) > 0
            np.testing.assert_array_equal(out, want)
