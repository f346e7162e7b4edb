"""The port's columnar branching held to the JAX package's definitions.

The port builds a frame's branch candidates as columns and makes Tracks
of the history gate's survivors only (`Associator3D._branch_tracks`,
`_spawn_spatial_batch`, `_spawn_temporal_batch`, `_apply_history_batch`,
`_Candidates`); the JAX package builds, patches and gates each candidate
as a Track of its own (`_branch_tracks`, `_spawn_spatial_batch`,
`_make_temporal_branch`, `_clone_track`, `_apply_history_batch` of
`mcmtt_opticalflow_tpu/models/associator3d.py`).

Each case steps the port's `Associator3D(device="cpu")` over an
associator-only stream (`synth_tracklet_stream` on the density lab's
4-camera scene, as `density_lab --assoc-only` drives it).  At every
frame's branching, a `copy.deepcopy` of the associator taken just before
it runs the JAX package's `_branch_tracks` as an unbound function, with
the JAX package's four helpers bound in place of the port's; then the
port branches.  The two must agree exactly, in the same order: the next
track id, every registry track field by field (`np.array_equal` and the
dtype on every per-position array; `last_*`, `tid_hist`, `cost_rgb`,
`_cost_cache` equal to the bit), the trees, `tracks_in_window`, `diag`
and the frame's candidates.

CPU: `python -m pytest tests/test_torch_branching.py -q` (~40 s).
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.models.associator3d import \
    Associator3D as JaxAssociator3D
from mcmtt_opticalflow_tpu_torch.data.synthetic import synth_tracklet_stream
from mcmtt_opticalflow_tpu_torch.density_lab import (IMAGE_SIZE, lab_config,
                                                     lab_scene)
from mcmtt_opticalflow_tpu_torch.models.associator3d import (Associator3D,
                                                             _round_robin)

torch.set_num_threads(2)

# the JAX package's per-candidate helpers of `_branch_tracks`
JAX_HELPERS = ("_spawn_spatial_batch", "_make_temporal_branch",
               "_clone_track", "_apply_history_batch")
COUNTERS = ("branch.spatial", "branch.temporal", "branch.gate_dropped",
            "branch.rowwise")


def same(x, y) -> bool:
    """Equal to the bit: arrays in dtype, shape and value (NaN equal to
    NaN), containers element by element, floats exactly."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                and x.dtype == y.dtype and x.shape == y.shape
                and np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"))
    if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
        return (type(x) is type(y) and len(x) == len(y)
                and all(same(a, b) for a, b in zip(x, y)))
    if isinstance(x, dict) and isinstance(y, dict):
        return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
    if isinstance(x, float) and isinstance(y, float):
        return x == y or (x != x and y != y)
    return type(x) is type(y) and x == y


def assert_same_branching(ref, port, frame_idx):
    rr, pr = ref.registry, port.registry
    assert rr.next_track_id == pr.next_track_id, frame_idx
    assert list(rr.tracks) == list(pr.tracks), frame_idx
    for tid, p in pr.tracks.items():
        r = rr.tracks[tid]
        names = set(vars(r)) | set(vars(p))
        bad = [k for k in sorted(names)
               if not same(getattr(r, k), getattr(p, k))]
        assert not bad, (frame_idx, tid, bad)
    assert ({k: t.track_ids for k, t in rr.trees.items()}
            == {k: t.track_ids for k, t in pr.trees.items()}), frame_idx
    assert ref.tracks_in_window == port.tracks_in_window, frame_idx
    assert ref.diag == port.diag, frame_idx
    assert ([t.id for t in ref._rescore_candidates]
            == [t.id for t in port._rescore_candidates]), frame_idx
    assert ([t.id for t in ref._rescore_updated]
            == [t.id for t in port._rescore_updated]), frame_idx


def run_lockstep(people, frames, staggered=True, rowwise=False, assoc=None):
    """Steps the port over `frames` frames of the lab's scene, holding
    each frame's branching to the JAX definitions; returns each frame's
    branch counters.  `rowwise` gives every frame's branching the state
    a camera with more than 64 new measurements leaves (no combination
    tables: the exact recursive enumeration)."""
    sc = lab_scene(frames, people, 0)
    cfg = lab_config(512)
    if assoc:
        cfg = dataclasses.replace(
            cfg, assoc3d=dataclasses.replace(cfg.assoc3d, **assoc))
    port = Associator3D(cfg, sc.cameras, device="cpu")
    stream = synth_tracklet_stream(sc, cfg.tracker2d.max_trackers,
                                   cfg.tracker2d.max_tracklet_length,
                                   seed=1, staggered=staggered)
    gray = np.full((4, IMAGE_SIZE[1], IMAGE_SIZE[0], 3), 128, np.uint8)
    branch = port._branch_tracks
    counts = []

    def counters():
        got = port.timer.export()["outside"]["counters"]
        return {k: got.get(k, 0.0) for k in COUNTERS}

    def lockstep(frame_idx, seeds):
        if rowwise:
            port._combo_tabs = None
        ref = copy.deepcopy(port)
        for name in JAX_HELPERS:
            setattr(ref, name,
                    types.MethodType(getattr(JaxAssociator3D, name), ref))
        JaxAssociator3D._branch_tracks(ref, frame_idx, list(seeds))
        before = counters()
        branch(frame_idx, seeds)
        after = counters()
        counts.append({k: after[k] - before[k] for k in COUNTERS})
        assert_same_branching(ref, port, frame_idx)

    port._branch_tracks = lockstep
    for t in range(frames):
        port.step(t, *stream[t], gray)
    return counts, cfg.assoc3d.max_branches_per_frame


def _dense(counts, budget):
    # a frame with both budgets saturated
    assert any(c["branch.spatial"] == budget
               and c["branch.temporal"] == budget for c in counts), counts


def _sparse(counts, budget):
    assert any(c["branch.spatial"] + c["branch.temporal"] > 0
               for c in counts), counts
    assert all(c["branch.spatial"] < budget for c in counts), counts


def _gate_drops(counts, budget):
    assert any(c["branch.gate_dropped"] > 0 for c in counts), counts


def _rowwise(counts, budget):
    assert all(c["branch.rowwise"] == 1 for c in counts), counts
    assert any(c["branch.spatial"] == budget for c in counts), counts


def _head(counts, budget):
    assert any(c["branch.spatial"] > 0 and c["branch.temporal"] > 0
               and c["branch.gate_dropped"] > 0 for c in counts), counts


CASES = {
    # 22 people, staggered tracklet rotations: spatial and temporal
    # branches every frame, both budgets full by frame 3
    "dense22_both_budgets": (dict(people=22, frames=4), _dense),
    "sparse6": (dict(people=6, frames=6), _sparse),
    # synchronized rotations: frame 3's resumptions meet the gate
    "gate_drops": (dict(people=22, frames=4, staggered=False), _gate_drops),
    "rowwise_fallback": (dict(people=22, frames=3, rowwise=True), _rowwise),
    "head_mode": (dict(people=12, frames=4,
                       assoc=dict(detection_mode="head")), _head),
}


@pytest.mark.parametrize("case", list(CASES))
def test_branching_equals_the_jax_definitions(case):
    kw, check = CASES[case]
    counts, budget = run_lockstep(**kw)
    check(counts, budget)
    for c in counts:
        assert c["branch.gate_dropped"] <= (c["branch.spatial"]
                                            + c["branch.temporal"])


def round_robin_loop(row_group, n_groups, per_group, quota):
    """The selection `_round_robin` replaced: pass after pass over the
    groups in order, each taking its next row while it has fewer than
    `per_group`, until `quota` rows are taken or no group has one."""
    groups = {}
    for i, g in enumerate(row_group):
        groups.setdefault(g, []).append(i)
    chosen = []
    ptr = {g: 0 for g in groups}
    progress = True
    while len(chosen) < quota and progress:
        progress = False
        for g in range(n_groups):
            lst = groups.get(g)
            if lst is None:
                continue
            k = ptr[g]
            if k >= min(len(lst), per_group):
                continue
            ptr[g] = k + 1
            progress = True
            chosen.append(lst[k])
            if len(chosen) >= quota:
                break
    return chosen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_round_robin_equals_the_loop(seed):
    """Random groups (rows in any order, groups without rows, equal group
    sizes), every per-group cap and quotas that cut a pass short."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        n_groups = int(rng.integers(1, 40))
        n = int(rng.integers(0, 300))
        row_group = rng.integers(0, n_groups, n)
        if rng.random() < 0.3:       # equal sizes: every pass ties
            row_group = np.repeat(np.arange(n_groups),
                                  int(rng.integers(1, 6)))
            rng.shuffle(row_group)
        per_group = int(rng.choice([0, 1, 2, 3, 8]))
        quota = int(rng.choice([0, 1, 7, n // 3 + 1, n, 10 * n + 5]))
        want = round_robin_loop(row_group.tolist(), n_groups, per_group,
                                quota)
        got = _round_robin(row_group.astype(np.int64), per_group, quota)
        assert got.tolist() == want, (n_groups, n, per_group, quota)
