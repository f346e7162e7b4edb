"""Checkpoint / resume of the full engine state.

The reference serialises its complete tracker state to text and replays it
on load (2D tracker: psn_where/PSNWhere_Tracker2D.cpp:1390-1600; 3D
associator incl. tracklets, tracks, trees, hypotheses and id maps:
PSNWhere_Associator3D.cpp:3434-4845, with pointer graphs re-linked by id on
load :4372-4438).

Here all host-side state is already id-indexed (no pointer re-linking
needed) and device state is a pytree of arrays, so a snapshot is:
  * the 2D tracker SoA state, pulled to numpy,
  * the associator's registries / hypothesis lists (plain dataclasses),
pickled together with the frame counters.  Resume restores both and
continues from the next frame.

Port of mcmtt_opticalflow_tpu/checkpoint/snapshot.py with the same payload
layout, except that the 2D state goes through convert.tracker2d_state_to_numpy
and comes back onto the engine's device.  The solver key is saved as the
JAX package saves it (two uint32 words), so a resumed run draws the same
random fields as an uninterrupted one.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

from mcmtt_opticalflow_tpu_torch.convert import (tracker2d_state_from_numpy,
                                                 tracker2d_state_to_numpy)


_SNAPSHOT_VERSION = 2   # v2: Tracker2DState gained frames_lo pyramid rings


def save_snapshot(engine, path: str) -> None:
    """Snapshot a TrackingEngine to one file.

    A pipelined engine is drained first (its in-flight 2D frame and
    deferred hypothesis solve are completed), so the snapshot is always a
    clean frame boundary — the reference likewise snapshots between Run
    calls (ref PSNWhere_Associator3D.cpp:437-445)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if hasattr(engine, "flush"):
        while engine.flush() is not None:
            pass
    a = engine.assoc
    payload: Dict[str, Any] = {
        "version": _SNAPSHOT_VERSION,
        "frame_idx": engine.frame_idx,
        # the result history + deferred-evaluation inputs (the reference
        # saves and replays these on load, ref Associator3D.cpp:3948-4845)
        "results": engine.results,
        "timing": engine.timing,
        "state2d": tracker2d_state_to_numpy(engine.state2d),
        "assoc": {
            "tracks": a.registry.tracks,
            "trees": a.registry.trees,
            "next_track_id": a.registry.next_track_id,
            "next_tree_id": a.registry.next_tree_id,
            "tracklets": a.tracklets,
            "active_tracklets": a.active_tracklets,
            "new_measurements": a.new_measurements,
            "active_tracks": a.active_tracks,
            "paused_tracks": a.paused_tracks,
            "tracks_in_window": a.tracks_in_window,
            "prev_hypotheses": a.prev_hypotheses,
            "best_solution": a.best_solution,
            "frame_idx": a.frame_idx,
            "num_frames_proc": a.num_frames_proc,
            "completed_frame": a.completed_frame,
            "solver_key": a.solver_key.cpu().numpy().astype(np.uint32),
            # visualization id map (ref saves it too, :3735-3744)
            "vis_id_map": a.vis_id_map,
            "vis_free": a.vis_free,
        },
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_snapshot(engine, path: str) -> int:
    """Restore a TrackingEngine in place; returns the saved frame index."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["version"] == _SNAPSHOT_VERSION
    engine.frame_idx = payload["frame_idx"]
    engine.results = payload.get("results", [])
    engine.timing = payload.get("timing", [])
    state_np = payload["state2d"]
    engine.state2d = tracker2d_state_from_numpy(state_np, engine.device)
    a = engine.assoc
    s = payload["assoc"]
    a.registry.tracks = s["tracks"]
    a.registry.trees = s["trees"]
    a.registry.next_track_id = s["next_track_id"]
    a.registry.next_tree_id = s["next_tree_id"]
    a.tracklets = s["tracklets"]
    a.active_tracklets = s["active_tracklets"]
    a.new_measurements = s["new_measurements"]
    a.active_tracks = s["active_tracks"]
    a.paused_tracks = s["paused_tracks"]
    a.tracks_in_window = s["tracks_in_window"]
    a.prev_hypotheses = s["prev_hypotheses"]
    a.best_solution = s["best_solution"]
    a.frame_idx = s["frame_idx"]
    a.num_frames_proc = s["num_frames_proc"]
    a.completed_frame = s.get("completed_frame", s["frame_idx"])
    a.solver_key = torch.from_numpy(
        np.asarray(s["solver_key"]).astype(np.int64))
    a.vis_id_map = s.get("vis_id_map", {})
    a.vis_free = s.get("vis_free", [])
    # rebuild the GTProb reset list (transient; not serialised)
    a._gt_prob_touched = [tid for tid, t in a.registry.tracks.items()
                          if t.gt_prob != 0.0 or t.current_best]
    return engine.frame_idx
