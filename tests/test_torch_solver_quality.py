"""The port's solver quality on RECORDED hypothesis graphs (the port's
counterpart of tests/test_solver_quality.py): the port's engine dumps
every frame's real compatibility instance (weights, adjacency, warm
starts) through `Associator3D.graph_dump`, and the port's replica BLS,
drawing from its default threefry stream (a PRNG key), is held against
brute force (small graphs, ratio >= 0.99 at 150 iterations) and the
native serial BLS (`native.bls_mwcp_solve`, ratio >= 0.99); with the
engine's own warm starts every K-best entry, from the host's
collect_k_best and from the device's device_k_best, is a clique over
valid vertices."""

import dataclasses

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu_torch import native
from mcmtt_opticalflow_tpu_torch.config import (EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models.mwcp import (NEG, collect_k_best,
                                                     device_k_best,
                                                     solve_mwcp)
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.utils import prng
from test_solver_quality import brute_force_mwc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def recorded_graphs():
    """tests/test_solver_quality.py's dense scene through the port."""
    sc = make_scenario(num_cameras=3, num_frames=14, num_people=6,
                       image_size=(192, 144), arena=5000.0,
                       fp_rate=0.1, fn_rate=0.05, seed=11)
    cfg = EngineConfig(
        num_cameras=3, image_width=192, image_height=144,
        tracker2d=Tracker2DConfig(max_detections=16, max_trackers=32,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=4),
        solver=SolverConfig(num_replicas=4, max_vertices=128,
                            solutions_per_replica=8, max_iterations=150))
    eng = TrackingEngine(cfg, sc.cameras, device="cpu")
    eng.assoc.graph_dump = []
    for t in range(14):
        frames = (np.clip(np.stack(sc.frames(t)), 0, 1) * 255).astype(
            np.uint8)
        eng.process_frame(frames, sc.detections[t], frame_idx=t)
    graphs = [g for g in eng.assoc.graph_dump if g["valid"].sum() >= 3]
    assert graphs, "engine recorded no non-trivial hypothesis graphs"
    return graphs, cfg.solver


def _solve(g, cfg, seed, init=None):
    valid = torch.tensor(g["valid"])
    return solve_mwcp(torch.tensor(g["weights"]), torch.tensor(g["adj"]),
                      valid, torch.zeros_like(valid) if init is None
                      else torch.tensor(init), prng.prng_key(seed), cfg, 150)


def test_device_matches_brute_force(recorded_graphs):
    graphs, scfg = recorded_graphs
    checked = 0
    for g in graphs:
        if int(g["valid"].sum()) > 18:
            continue
        _, exact = brute_force_mwc(g["weights"], g["adj"], g["valid"])
        if exact <= 0:
            continue
        got = float(_solve(g, scfg, 0).best_score.max())
        assert got >= 0.99 * exact - 1e-4, (g["frame"], got, exact)
        checked += 1
    assert checked > 0, "no recorded graph was brute-forceable"


def test_device_k_best_matches_native(recorded_graphs):
    if not native.available():
        pytest.skip("native library not built")
    graphs, scfg = recorded_graphs
    ratios = []
    for g in graphs:
        dev = float(_solve(g, scfg, 1).best_score.max())
        w = np.where(g["valid"], g["weights"], 0.0)
        _, nat, _, _ = native.bls_mwcp_solve(
            w, g["adj"] & g["valid"][:, None] & g["valid"][None, :],
            max_iterations=800, seed=3)
        if max(dev, nat) <= 0:
            continue
        ratios.append(min(dev, nat) / max(dev, nat))
        assert dev >= 0.99 * nat - 1e-4, (g["frame"], dev, nat)
    assert ratios, "no scoreable graphs"


def test_warm_started_k_best_cliques_valid(recorded_graphs):
    graphs, scfg = recorded_graphs
    g = max(graphs, key=lambda g: g["valid"].sum())
    k = len(g["init_masks"])
    cfg = dataclasses.replace(scfg, num_replicas=scfg.num_replicas + k)
    init = np.zeros((cfg.num_replicas, len(g["weights"])), bool)
    init[:k] = g["init_masks"]
    res = _solve(g, cfg, 2, init)
    masks, _ = collect_k_best(res, 10)
    dmasks, dscores = device_k_best(res, 10)
    masks = masks + [m for m, s in zip(dmasks.numpy(), dscores.numpy())
                     if s > NEG / 2]
    adj = np.asarray(g["adj"])
    found = 0
    for m in masks:
        members = np.where(m)[0]
        if not len(members):
            continue
        found += 1
        assert g["valid"][members].all()
        sub = adj[np.ix_(members, members)]
        assert sub.sum() == len(members) * (len(members) - 1)
    assert found > 0
