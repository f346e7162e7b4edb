"""Inspectable text dumps of tracker state.

The reference's correctness workflow leans on state dumps: per-frame 2D
tracklet files (ref FilePrintResult, psn_where/PSNWhere_Tracker2D.cpp:1268-1342)
and track/hypothesis/tree printers (ref PrintTracks/PrintHypotheses/
PrintCurrentTrackTrees, PSNWhere_Associator3D.cpp:3181-3423).  These
functions reproduce those formats so existing tooling / diffing workflows
keep working.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def dump_track2d_result(path: str, cam_id: int, frame_idx: int,
                        ids: np.ndarray, boxes: np.ndarray,
                        mask: np.ndarray, det_boxes: np.ndarray,
                        det_mask: np.ndarray) -> None:
    """Write the reference's track2D_result_cam%d_frame%04d.txt format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"camIdx:{cam_id}\nframeIdx:{frame_idx}\n")
        live = np.where(np.asarray(mask))[0]
        f.write("numObjectInfos:%d{\n" % len(live))
        for i in live:
            b = boxes[i]
            f.write("\t{\n")
            f.write(f"\t\tid:{int(ids[i])}\n")
            f.write("\t\tbox:(%f,%f,%f,%f)\n" % tuple(float(v) for v in b))
            f.write("\t\thead:(%f,%f,%f,%f)\n"
                    % (float(b[0]) + 0.3 * float(b[2]), float(b[1]),
                       0.4 * float(b[2]), 0.2 * float(b[3])))
            f.write("\t\tscore:0.000000\n")
            f.write("\t\tfeaturePointsPrev:0,{}\n")
            f.write("\t\tfeaturePointsCurr:0,{}\n")
            f.write("\t}\n")
        f.write("}\n")
        dets = np.asarray(det_boxes)[np.asarray(det_mask)]
        f.write("detectionRects:%d,{" % len(dets))
        f.write(",".join("(%f,%f,%f,%f)" % tuple(float(v) for v in b)
                         for b in dets))
        f.write("}\n")
        trks = np.asarray(boxes)[np.asarray(mask)]
        f.write("trackerRects:%d,{" % len(trks))
        f.write(",".join("(%f,%f,%f,%f)" % tuple(float(v) for v in b)
                         for b in trks))
        f.write("}\n")


def dump_tracks(path: str, registry, track_ids: Sequence[int]) -> None:
    """Track table dump (ref PrintTracks, Associator3D.cpp:3181-3267)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"numTracks:{len(track_ids)}\n")
        for tid in track_ids:
            tr = registry.tracks.get(tid)
            if tr is None:
                continue
            f.write("{\n")
            f.write(f"\tid:{tr.id}\n\ttreeID:{tr.tree_id}\n")
            f.write(f"\tparent:{-1 if tr.parent is None else tr.parent}\n")
            f.write(f"\ttimeStart:{tr.time_start}\n"
                    f"\ttimeEnd:{tr.time_end}\n"
                    f"\ttimeGeneration:{tr.time_generation}\n"
                    f"\tduration:{tr.duration}\n")
            f.write(f"\tbActive:{int(tr.active)}\n\tbValid:{int(tr.valid)}\n")
            f.write("\ttrackleIDs:{%s}\n" % ";".join(
                ",".join(str(x) for x in h) for h in tr.tid_hist))
            f.write(f"\tcostTotal:{tr.total_cost():.6f}\n")
            f.write(f"\tcostEnter:{tr.cost_enter:.6f}\n")
            f.write(f"\tcostRecon:{float(tr.cost_recon_pos.sum()):.6f}\n")
            f.write(f"\tcostLink:{float(tr.cost_link_pos.sum()):.6f}\n")
            f.write(f"\tcostRGB:{tr.cost_rgb:.6f}\n")
            f.write(f"\tcostExit:{tr.cost_exit:.6f}\n")
            f.write(f"\tGTProb:{tr.gt_prob:.6f}\n")
            f.write("\treconstructions:{%s}\n" % ",".join(
                "(%.1f,%.1f,%.1f)" % tuple(p) for p in tr.smoothed))
            f.write("}\n")


def dump_hypotheses(path: str, hypotheses, frame_idx: int) -> None:
    """Hypothesis dump (ref PrintHypotheses, Associator3D.cpp:3290-3330)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"frameIndex:{frame_idx}\n")
        f.write(f"numHypotheses:{len(hypotheses)}\n")
        for rank, h in enumerate(hypotheses):
            f.write("{\n")
            f.write(f"\trank:{rank}\n")
            f.write(f"\tlogLikelihood:{h.log_likelihood:.6f}\n")
            f.write(f"\tprobability:{h.probability:.6f}\n")
            f.write("\tselectedTracks:{%s}\n"
                    % ",".join(str(t) for t in h.selected))
            f.write("\tnumRelatedTracks:%d\n" % len(h.related))
            f.write("}\n")


def dump_trees(path: str, registry) -> None:
    """Track-tree dump (ref PrintCurrentTrackTrees, :3333-3380)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"numTrees:{len(registry.trees)}\n")
        for tree in registry.trees.values():
            f.write("{\n")
            f.write(f"\tid:{tree.id}\n")
            f.write(f"\ttimeGeneration:{tree.time_generation}\n")
            f.write(f"\tbValid:{int(tree.valid)}\n")
            f.write(f"\tbConfirmed:{int(tree.confirmed)}\n")
            f.write("\ttracks:{%s}\n" % ",".join(
                f"{t}->{registry.tracks[t].parent}"
                for t in tree.track_ids if t in registry.tracks))
            f.write("}\n")
