"""The yardstick's arithmetic on scripted inputs."""

import pytest

import devtrace
import endtoend
import roofline
import stages


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    walls = [0.1] * 100
    base_rate = endtoend.frames_per_s(walls, sum(walls))
    base_p95 = endtoend.frame_ms_p95(walls)
    assert base_rate == pytest.approx(10.0)
    assert base_p95 == pytest.approx(100.0)
    stalled = walls[:50] + [0.1 + 2.0 / 6] * 6 + walls[56:]
    rate = endtoend.frames_per_s(stalled, sum(stalled))
    assert rate < base_rate
    assert endtoend.frame_ms_p95(stalled) > base_p95
    # the rate counts all the time of the window, also between the calls
    assert endtoend.frames_per_s(walls, sum(walls) + 1.0) < base_rate


def test_p95_interpolates_between_ranks():
    assert endtoend.frame_ms_p95([i / 1e3 for i in range(101)]) == \
        pytest.approx(95.0)
    assert endtoend.frame_ms_p95([1e-3, 2e-3]) == pytest.approx(1.95)


def test_self_time_of_nested_stages():
    totals = {"assoc.branch": 3.0, "branch.enum": 1.0,
              "assoc.hypotheses": 2.0, "hyp.dispatch": 0.5,
              "hyp.apply": 0.2, "hyp.collect": 0.3, "gray": 9.0}
    outer = stages.with_prefix(totals, "assoc.") + ["hyp.apply",
                                                    "hyp.collect"]
    got = stages.self_ms(totals, 10, outer, ["hyp.dispatch"])
    assert got == pytest.approx(1e3 * (3.0 + 2.0 + 0.2 + 0.3 - 0.5) / 10)
    assert stages.stage_ms(totals, 10, ["missing"]) == 0.0


def test_bls_bytes_at_both_configurations():
    # bench4cam_k30: R = 8 + 30, V = 1024, S = 16, three launches of 50
    assert roofline.bls_launches(150) == [50, 50, 50]
    b = roofline.bls_bytes(38, 1024, 16, 50)
    state = 38 * 1024 * 7 + 38 * 16 * 1028 + 38 * 17
    assert b == 50 * 38 * 8200 + 1024 * 5 + 1024 ** 2 + 2 * state
    assert b == 18_429_804
    # pets09_ref_defaults: R = 8 + 50, V = 256, forty launches of 50
    assert roofline.bls_launches(2000) == [50] * 40
    assert roofline.bls_bytes(58, 256, 16, 50) == 6_721_620
    assert roofline.bls_launches(120) == [50, 50, 20]


def test_trace_busy_share_and_gap_labels():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "assoc.branch",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "engine.step2d",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 15, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 120, "dur": 20},
    ]
    s = devtrace.summarize(ev)
    assert s["window_s"] == pytest.approx(150e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["kernel_n"] == {"k1": 2}
    gaps = dict((n, v) for n, v in s["idle_gaps"])
    # idle time goes to the innermost range open over it
    assert gaps["assoc.branch"] == pytest.approx(10e-6 + 75e-6)
    assert gaps["engine.step2d"] == pytest.approx(20e-6 + 10e-6)
