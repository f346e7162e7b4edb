"""The JAX package's quality gates (tests/test_quality_regression.py) on
the port, and the port held equal to the JAX package on their fixtures.

Both fixtures are built as that file builds them (the same scenes,
configurations, loops, windows and zone; mcmtt_opticalflow_tpu_torch/
quality.py), once through the JAX package and once through the port on
the CPU with MCMTT_LK_BACKEND=xla (the gather LK, as the JAX engine's CPU
run):

- the sparse scene: the full pipeline, 3 cameras at 384x288, 4 people,
  22 frames, windows 0 and 5 (the LK at window 12, 128 solver vertices);
- the density scene: the associator alone on a 22-person synthesized
  tracklet stream, 30 frames, windows 0, 3 and 6 (512 solver vertices,
  K=30).

The port must pass the JAX file's gates at its thresholds, and equal the
JAX run: the 3D ids of every frame as each window scored it and after
the run, points within POINT_ATOL_MM, every CLEAR-MOT number per window,
tracks_peak and pool_dropped; and the port's CPU record
(quality_reference.json) is this run."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu_torch import quality

torch.set_num_threads(2)

POINT_ATOL_MM = 1.0


def _jax_kit():
    from mcmtt_opticalflow_tpu import config
    from mcmtt_opticalflow_tpu.data import make_scenario
    from mcmtt_opticalflow_tpu.data.synthetic import synth_tracklet_stream
    from mcmtt_opticalflow_tpu.eval import ClearMotAccumulator
    from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine
    return types.SimpleNamespace(
        config=config, make_scenario=make_scenario,
        synth_tracklet_stream=synth_tracklet_stream,
        ClearMotAccumulator=ClearMotAccumulator,
        TrackingEngine=TrackingEngine)


def _both(fixture):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MCMTT_LK_BACKEND", raising=False)
        jax_run = fixture(kit=_jax_kit())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        port_run = fixture(device="cpu")
    return jax_run, port_run


@pytest.fixture(scope="module")
def sparse():
    return _both(quality.sparse_fixture)


@pytest.fixture(scope="module")
def density():
    return _both(quality.density_fixture)


@pytest.fixture(params=["sparse", "density"])
def runs(request):
    """(fixture name, JAX run, port run)."""
    return (request.param, *request.getfixturevalue(request.param))


# ------------------------------------------- the JAX file's gates, port
class TestQualityRegression:
    def test_mota_floor(self, sparse):
        r5 = sparse[1].evals[5]
        assert r5.mota > 0.55, r5.summary()

    def test_recall_and_precision(self, sparse):
        r5 = sparse[1].evals[5]
        assert r5.recall > 0.7, r5.summary()
        assert r5.precision > 0.8, r5.summary()

    def test_deferred_window_improves(self, sparse):
        r = sparse[1].evals
        assert r[5].mota >= r[0].mota - 0.05, (r[0].summary(),
                                                r[5].summary())

    def test_mostly_tracked(self, sparse):
        r5 = sparse[1].evals[5]
        assert r5.most_tracked >= 2, r5.summary()
        assert r5.most_lost <= 1, r5.summary()


class TestDensityQuality:
    def test_mota_floor_at_density(self, density):
        r6 = density[1].evals[6]
        assert r6.mota > 0.6, r6.summary()

    def test_deferred_window_monotone_at_density(self, density):
        r = density[1].evals
        assert r[3].mota >= r[0].mota - 0.01, (r[0].summary(),
                                                r[3].summary())
        assert r[6].mota >= r[3].mota - 0.01, (r[3].summary(),
                                                r[6].summary())
        assert r[6].id_switches <= r[0].id_switches, (
            r[0].summary(), r[6].summary())

    def test_candidate_containment(self, density):
        assert density[1].tracks_peak <= 2000
        assert density[1].pool_dropped <= 100


def test_gate_tables_hold(sparse, density):
    """The gates as chip_smoke holds them on the card (quality.py) read
    the same thresholds and hold on the port's CPU runs."""
    for gates in (quality.sparse_gates(sparse[1]),
                  quality.density_gates(density[1])):
        assert all(ok and margin >= 0 for ok, _, _, margin
                   in gates.values()), gates
    assert len(quality.sparse_gates(sparse[1])) == 6
    assert len(quality.density_gates(density[1])) == 6


# ------------------------------------------------ the port == JAX package
def test_3d_results_equal(runs):
    _, jax_run, port_run = runs
    assert sorted(port_run.scored) == sorted(jax_run.scored)
    pairs = [(f"window {w}, frame {t}", jax_run.scored[w, t],
              port_run.scored[w, t]) for w, t in sorted(jax_run.scored)]
    pairs += [(f"frame {t} after the run", j, p) for t, (j, p) in
              enumerate(zip(jax_run.results, port_run.results))]
    for label, (jids, jpts), (pids, ppts) in pairs:
        assert pids == jids, f"ids part at {label}"
        np.testing.assert_allclose(ppts, jpts, rtol=0, atol=POINT_ATOL_MM,
                                   err_msg=label)
    assert sum(len(ids) for ids, _ in port_run.results) > 0


def test_clear_mot_equal(runs):
    _, jax_run, port_run = runs
    assert sorted(port_run.evals) == sorted(jax_run.evals)
    for w in jax_run.evals:
        assert (dataclasses.asdict(port_run.evals[w])
                == dataclasses.asdict(jax_run.evals[w])), w


def test_containment_equal(runs):
    _, jax_run, port_run = runs
    assert port_run.tracks_peak == jax_run.tracks_peak
    assert port_run.pool_dropped == jax_run.pool_dropped


def test_cpu_record_is_the_port_run(runs):
    """quality_reference.json, the CPU numbers chip_smoke prints beside
    the card's and the ids it finds the card's first parting frame
    against, is this run's record."""
    name, _, port_run = runs
    with open(quality.REFERENCE) as f:
        ref = json.load(f)
    assert quality.record(port_run) == ref[name]


def test_density_reaches_the_pool_limit(density):
    """The density scene overflows the 512-vertex pool, as the JAX run
    does: its solves run at the full graph bucket."""
    assert density[0].pool_dropped > 0
    assert max(k[1] for k in density[1].engine.assoc._programs) == 512


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_record_is_written_from_the_cpu_gather_run_only(backend,
                                                        monkeypatch):
    """The module's command rebuilds the record on the CPU, and refuses
    to without the gather LK, before it runs anything."""
    if backend is None:
        monkeypatch.delenv("MCMTT_LK_BACKEND", raising=False)
    else:
        monkeypatch.setenv("MCMTT_LK_BACKEND", backend)
    with open(quality.REFERENCE) as f:
        before = f.read()
    with pytest.raises(SystemExit, match="MCMTT_LK_BACKEND=xla"):
        quality.main([])
    with open(quality.REFERENCE) as f:
        assert f.read() == before
