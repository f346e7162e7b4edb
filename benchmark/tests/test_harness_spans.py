"""The five span metrics read the program's span tree on the tiny cell,
traced, on the CPU: the host ones as numbers that agree with the stage
sums, the vertex fill as a share, the device head as nothing (no card),
and every reader as nothing where the program keeps no tree."""

import pytest

import cells
import run
from tiny import tiny_cell

SPAN_METRICS = ("seeds_host_ms", "branch_host_ms", "hyp_host_ms",
                "solve_vertex_fill", "score_device_ms")


@pytest.fixture(scope="module")
def traced():
    c, t, lim = tiny_cell()
    res = run.run(c, t, lim, 3456789012, 0.0, True, device="cpu",
                  frames=12, judge=False)
    bench = cells.benchmark()
    return res, run.metric_values(bench, "bench4cam_k30.dense22", res, True)


def test_the_span_metrics_are_entries_of_both_cells():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        names = [m["name"] for m in cells.metrics_of(bench, w["name"],
                                                     "per_layer")]
        assert set(SPAN_METRICS) <= set(names), w["name"]


def test_the_readers_on_the_tiny_cell(traced, capsys):
    res, metrics = traced
    for name in ("seeds_host_ms", "branch_host_ms", "hyp_host_ms"):
        assert metrics[name]["value"] > 0.0, name
    assert 0.0 < metrics["solve_vertex_fill"]["value"] <= 1.0
    assert "score_device_ms" not in metrics        # no card, no events


def test_the_tree_agrees_with_the_stage_sums(traced):
    """The association's self time by parent links equals assoc_host_ms's
    sums by name, within 1%."""
    import spantree
    res, metrics = traced
    exp = spantree.exported()
    assert exp["roots"] == res["frames"]
    tree = spantree.self_ms(exp, lambda n: n.startswith("assoc.")
                            or n in ("hyp.apply", "hyp.collect"))
    sums = cells.reader("assoc_host_ms")(dict(frames=res["frames"],
                                              stages=res["totals"]))
    assert tree == pytest.approx(sums, rel=0.01)


def test_the_idle_gaps_name_program_spans(traced):
    res, _ = traced
    labels = {name for name, _ in res["trace"]["idle_gaps"]}
    program = {"frame", "gray", "upload", "tracker2d", "get2d",
               "assoc.tracklets", "assoc.seed_enum", "assoc.ut_prep",
               "assoc.update_tracks", "assoc.seeds", "branch.enum",
               "branch.spawn", "branch.temporal", "hyp.inputs", "hyp.prep",
               "rescore.prep", "hyp.dispatch", "hyp.solve", "hyp.apply",
               "hyp.collect", "assoc.prune"}
    assert labels & program, labels


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_tree_reads_nothing(name, monkeypatch):
    from mcmtt_opticalflow_tpu_torch.utils import spans
    monkeypatch.setattr(spans, "_current", None)
    assert cells.reader(name)({"frames": 1, "stages": {}}) is None
