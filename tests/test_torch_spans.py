"""The span tree (utils/spans.py): StageTimer's numbers unchanged, parent
links and self time, counters and device parts, the ring's bound, the
profiler's ranges, and the pipelined engine's roots, all on the CPU."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.utils import spans
from mcmtt_opticalflow_tpu_torch.utils.spans import SpanTimer
from mcmtt_opticalflow_tpu_torch.utils.timing import StageTimer


# ------------------------------------------------------------ scripted runs
def _lexical(t):
    with t.stage("a"):
        with t.stage("b"):
            pass
        with t.stage("c"):
            with t.stage("b"):
                pass
    with t.stage("a"):
        pass


def _pushed(t):
    t.push("a")
    t.push("b")
    t.pop()
    t.push("b")
    t.pop()
    t.pop()
    t.push("c")
    t.pop()


def _mixed(t):
    with t.stage("assoc.branch"):
        t.push("branch.enum")
        t.pop()
        t.push("branch.spawn")
        with t.stage("inner"):
            pass
        t.pop()
    t.push("hyp.prep")
    with t.stage("hyp.dispatch"):
        t.push("rescore.prep")
        t.pop()
    t.pop()


RUNS = {"lexical": _lexical, "pushed": _pushed, "mixed": _mixed}


def _clock(monkeypatch, values):
    it = iter(values)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def _ticks(n):
    """Clock readings with uneven steps."""
    return list(np.cumsum([0.5 + 0.37 * (i % 7) for i in range(n)]))


def _run(timer, name, root):
    if root:
        with timer.root(3):
            RUNS[name](timer)
    else:
        RUNS[name](timer)


@pytest.mark.parametrize("name", sorted(RUNS))
@pytest.mark.parametrize("root", [False, True])
def test_stage_sums_equal_stage_timers(name, root, monkeypatch):
    """On one scripted clock, SpanTimer's totals, counts, samples and
    summary equal StageTimer's; a root (two readings, first and last)
    enters neither."""
    ticks = _ticks(64)
    plain = StageTimer()
    _clock(monkeypatch, ticks)
    RUNS[name](plain)
    tree = SpanTimer()
    _clock(monkeypatch, [-1.0] + ticks if root else ticks)
    _run(tree, name, root)
    for key in ("totals", "counts", "samples"):
        assert dict(getattr(tree, key)) == dict(getattr(plain, key)), key
    assert tree.summary() == plain.summary()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_self_time_plus_children_is_the_total(name, monkeypatch):
    """Per path and per recorded span: the self time plus the children's
    totals is the total; every span's parent is open across it."""
    _clock(monkeypatch, _ticks(64))
    t = SpanTimer()
    _run(t, name, True)
    exp = t.export()
    paths = exp["paths"]
    for path, agg in paths.items():
        kids = sum(a["total_s"] for p, a in paths.items()
                   if p.rsplit("/", 1)[0] == path and p != path)
        assert agg["self_s"] + kids == pytest.approx(agg["total_s"])
    (rec,) = exp["frames"]
    sp = rec["spans"]
    assert sp[0]["name"] == spans.ROOT and sp[0]["parent"] is None
    assert rec["wall_s"] == sp[0]["dur_s"] and rec["frame"] == 3
    for i, s in enumerate(sp):
        kids = [c for c in sp if c["parent"] == i]
        assert s["self_s"] + sum(c["dur_s"] for c in kids) == \
            pytest.approx(s["dur_s"])
        if s["parent"] is not None:
            p = sp[s["parent"]]
            assert s["parent"] < i
            assert p["start_s"] <= s["start_s"]
            assert s["start_s"] + s["dur_s"] <= p["start_s"] + p["dur_s"]
        assert s["frame"] == 3


def test_outside_a_root_the_book_is_apart():
    t = SpanTimer()
    with t.stage("a"):
        t.count("n", 2)
        t.part("head", 0.25)
    with t.root(0):
        with t.stage("a"):
            t.count("n")
            t.part("head", 0.5)
            t.part("head", 0.25)
    exp = t.export()
    assert exp["roots"] == 1 and len(exp["frames"]) == 1
    assert set(exp["paths"]) == {"frame", "frame/a"}
    assert set(exp["outside"]["paths"]) == {"a"}
    assert exp["counters"] == {"n": 1}
    assert exp["outside"]["counters"] == {"n": 2}
    assert exp["parts"] == {"head": {"seconds": 0.75, "count": 2}}
    assert exp["outside"]["parts"] == {"head": {"seconds": 0.25,
                                                "count": 1}}
    assert t.counts["a"] == 2


def test_reset_clears_the_tree_and_makes_it_current():
    t = SpanTimer()
    with t.root(0):
        with t.stage("a"):
            t.count("n")
            t.part("head", 1.0)
    with t.stage("b"):
        t.count("m")
    t.reset()
    assert spans.current() is t
    exp = t.export()
    assert exp["roots"] == 0 and exp["frames"] == []
    for book in (exp, exp["outside"]):
        assert book["paths"] == {} and book["counters"] == {} \
            and book["parts"] == {}
    assert not t.totals and not t.counts and not t.samples
    other = SpanTimer()
    assert spans.current() is t
    other.reset()
    assert spans.current() is other


def test_the_ring_keeps_the_last_roots(monkeypatch):
    monkeypatch.setattr(spans, "RING_FRAMES", 4)
    t = SpanTimer()
    for i in range(10):
        with t.root(i):
            with t.stage("a"):
                pass
    exp = t.export()
    assert exp["roots"] == 10
    assert [f["frame"] for f in exp["frames"]] == [6, 7, 8, 9]
    assert exp["paths"]["frame/a"]["count"] == 10


def test_a_span_left_open_by_an_exception_closes_with_its_stage():
    t = SpanTimer()
    with pytest.raises(RuntimeError):
        with t.root(0):
            with t.stage("a"):
                t.push("b")
                raise RuntimeError
    assert not t.in_frame and t._stack == []
    assert set(t.export()["paths"]) == {"frame", "frame/a", "frame/a/b"}


def test_the_helpers_leave_another_timer_alone():
    plain = StageTimer()
    with spans.root(plain, 0):
        spans.count(plain, "n")
        spans.part(plain, "head", 1.0)
    assert not plain.totals
    t = SpanTimer()
    with spans.root(t, 0):
        spans.count(t, "n")
        spans.part(t, "head", 1.0)
        assert t.in_frame
    assert not t.in_frame
    exp = t.export()
    assert exp["counters"] == {"n": 1}
    assert exp["parts"] == {"head": {"seconds": 1.0, "count": 1}}


# ----------------------------------------------------------------- profiler
@pytest.mark.parametrize("recording", [False, True])
def test_ranges_open_only_while_the_profiler_records(recording,
                                                     monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(spans, "record_function", Range)
    monkeypatch.setattr(spans, "recording", lambda: recording)
    t = SpanTimer()
    _run(t, "mixed", True)
    want = ["frame", "assoc.branch", "branch.enum", "branch.spawn", "inner",
            "hyp.prep", "hyp.dispatch", "rescore.prep"]
    assert opened == (want if recording else [])


def test_the_trace_holds_the_spans_in_the_trees_order(tmp_path):
    """Under torch.profiler on the CPU each span is a user_annotation
    event under its name, nested as the tree nests them."""
    t = SpanTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.root(0):
            RUNS["mixed"](t)
            torch.ones(4).sum()
    assert not spans.recording()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (rec,) = t.export()["frames"]
    sp = rec["spans"]
    names = [s["name"] for s in sp]
    assert len(set(names)) == len(names)
    assert sorted(e["name"] for e in ev) == sorted(names)
    at = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for e in ev}
    starts = [at[n][0] for n in names]
    assert starts == sorted(starts)
    for s in sp:
        if s["parent"] is not None:
            (a, b), (pa, pb) = at[s["name"]], at[sp[s["parent"]]["name"]]
            assert pa <= a and b <= pb, s["name"]


# ---------------------------------------------------- the pipelined engine
FRAMES = 8


def _cfg():
    return tcfg.EngineConfig(
        num_cameras=2, image_width=256, image_height=192,
        tracker2d=tcfg.Tracker2DConfig(max_detections=16, max_trackers=32,
                                       max_features=16, lk_window=8,
                                       lk_pyramid_levels=2, lk_iterations=6),
        solver=tcfg.SolverConfig(num_replicas=4, max_vertices=64,
                                 solutions_per_replica=8, max_iterations=60))


def _drive(timer_class):
    sc = make_scenario(num_cameras=2, num_frames=FRAMES, num_people=3,
                       image_size=(256, 192), arena=5000.0, seed=11)
    eng = TrackingEngine(_cfg(), sc.cameras, pipelined=True, device="cpu")
    eng.assoc.timer = timer_class()
    eng.assoc.timer.reset()
    for t in range(FRAMES):
        eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                          frame_idx=t)
    in_window = eng.assoc.timer.export() if timer_class is SpanTimer \
        else None
    while eng.flush() is not None:
        pass
    return eng, in_window


@pytest.fixture(scope="module")
def engines():
    return _drive(SpanTimer), _drive(StageTimer)


def test_one_root_for_each_process_frame(engines):
    (eng, _), _ = engines
    exp = eng.assoc.timer.export()
    assert exp["roots"] == FRAMES
    assert [f["frame"] for f in exp["frames"]] == list(range(FRAMES))
    assert exp["paths"]["frame"]["count"] == FRAMES
    for f in exp["frames"]:
        sp = f["spans"]
        assert sp[0]["name"] == spans.ROOT
        assert [s["parent"] for s in sp].count(None) == 1


def test_each_span_names_the_frame_it_worked_on(engines):
    """A pipelined process_frame(t) works on frame t's 2D step and frame
    t-2's association."""
    (eng, _), _ = engines
    two_d = {"gray", "upload", "tracker2d", spans.ROOT}
    for f in eng.assoc.timer.export()["frames"]:
        t = f["frame"]
        for s in f["spans"]:
            assert s["frame"] == (t if s["name"] in two_d else t - 2), \
                (t, s["name"])


def test_flush_stays_outside_the_frames(engines):
    (eng, in_window), _ = engines
    exp = eng.assoc.timer.export()
    assert exp["roots"] == in_window["roots"]
    assert exp["paths"] == in_window["paths"]
    assert exp["counters"] == in_window["counters"]
    assert "assoc.hypotheses" in exp["outside"]["paths"]
    assert exp["outside"]["counters"]["solve.frames"] >= 1
    # StageTimer's sums count both books
    books = [exp["paths"], exp["outside"]["paths"]]
    for name, n in eng.assoc.timer.counts.items():
        assert n == sum(a["count"] for b in books for p, a in b.items()
                        if p.rsplit("/", 1)[-1] == name), name


def test_the_solve_counters_add_up(engines):
    (eng, in_window), _ = engines
    c = in_window["counters"]
    paths = in_window["paths"]
    solves = paths["frame/assoc.hypotheses/hyp.dispatch"]["count"]
    assert c["solve.frames"] == solves > 0
    assert c["solve.slots"] == solves * eng.cfg.solver.max_vertices
    assert 0 < c["solve.vertices"] <= c["solve.slots"]
    assert sum(v for k, v in c.items() if k.startswith("solve.bucket.")) \
        == solves
    assert c.get("solve.pool_dropped", 0) == 0
    # one 2D part a frame, and each solve's draw, head, blocks and tail
    prog = next(iter(eng.assoc._programs.values()))
    assert c["graph.replays"] == FRAMES + solves * (
        3 + prog.blocks + (prog.rest is not None))
    # the bucket's program was made inside a frame, with no device events
    assert c["graph.captures"] == len(eng.assoc._programs) == 1
    assert prog.marks is None and in_window["parts"] == {}


def test_the_results_equal_a_plain_stage_timers(engines):
    (eng, _), (plain, _) = engines
    assert type(plain.assoc.timer) is StageTimer
    assert len(eng.results) == len(plain.results) == FRAMES
    assert any(len(r.track_ids) for r in eng.results)
    for a, b in zip(eng.results, plain.results):
        assert a.frame_idx == b.frame_idx
        assert (a.ids, a.track_ids) == (b.ids, b.track_ids)
        np.testing.assert_array_equal(a.points, b.points)
    assert set(plain.assoc.timer.counts) == set(eng.assoc.timer.counts)
    assert dict(plain.assoc.timer.counts) == dict(eng.assoc.timer.counts)
