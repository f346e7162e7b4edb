# Frozen copy of mcmtt_opticalflow_tpu_torch/models/tracker2d.py at commit 052b569610a6, for the benchmark's
# plain reference; imports point at the copies beside it.
"""Per-camera 2D tracklet generation (port of
mcmtt_opticalflow_tpu/models/tracker2d.py).

The JAX package writes the step for one camera and vmaps it; here every
tensor carries the camera axis explicitly ([C, ...]).  Stage structure
mirrors the reference's Run (ref Tracker2D.cpp:251-373):

  1. detection validation by reconstructed height    (ref :705-715)
  2. grid corner extraction inside boxes             (ref :735-757)
  3. backward LK chain through the frame buffer with
     disparity-voting box estimation                 (ref :763-811, 455-554)
  4. forward LK of live trackers + box-chain cost    (ref :851-1025)
  5. assignment + gate validation + lifecycle        (ref :1038-1182)

The assignment (step 5) runs where the cost matrix lies
(ops/hungarian.py): the JV kernel on the card, its plain version on the
CPU.  The step reads no device value on the host (no .item(), no
boolean indexing, no host branch on a tensor, no host-to-device copy), so
on the card it is captured whole as one CUDA graph
(models/pipeline.py::Tracker2DProgram), as the JAX package jits it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from reference.config import Tracker2DConfig
from reference.tsai import (TsaiCamera,
                                                       image_to_world)
from reference.triangulation import \
    triangulate_two_lines
from reference.features import detect_grid_features
from reference.hungarian import solve_assignment_batch
from reference.lk import lk_track_prebuilt
from reference.pyramid import build_pyramid
from reference.tree import tree_map


class Tracker2DState(NamedTuple):
    """Fixed-capacity tracker state; every leaf has a leading camera axis
    (`tracker2d_step`), or none for one camera (`make_tracker2d_step`)."""

    frames: torch.Tensor        # [C, B, H, W] gray ring buffer, -1 = newest
    frames_lo: Tuple[torch.Tensor, ...]   # per level >= 1: [C, B, H/2^l, W/2^l]
    frame_count: torch.Tensor   # [C] int32
    trk_active: torch.Tensor    # [C, T] bool
    trk_id: torch.Tensor        # [C, T] int32
    trk_boxes: torch.Tensor     # [C, T, B, 4] recent boxes, index 0 = current
    trk_time_start: torch.Tensor  # [C, T] int32
    trk_time_end: torch.Tensor  # [C, T] int32
    trk_feats: torch.Tensor     # [C, T, F, 2]
    trk_feat_valid: torch.Tensor  # [C, T, F] bool
    trk_location: torch.Tensor  # [C, T, 3] last 3D ground location
    trk_height: torch.Tensor    # [C, T] estimated person height (mm)
    next_id: torch.Tensor       # [C] int32


class Track2DOutput(NamedTuple):
    """Per-frame tracklet output (ref stTrack2DResult,
    psn_where/PSNWhere_Types.h:200-209) as masked [C, ...] tensors."""

    ids: torch.Tensor           # [C, T] int32 tracklet ids
    boxes: torch.Tensor         # [C, T, 4]
    mask: torch.Tensor          # [C, T] bool emitted this frame
    locations: torch.Tensor     # [C, T, 3]
    heights: torch.Tensor       # [C, T]
    det_boxes: torch.Tensor     # [C, D, 4] validated detections
    det_mask: torch.Tensor      # [C, D]
    cost_matrix: torch.Tensor   # [C, D, T]


def init_tracker2d_state(cfg: Tracker2DConfig, height: int, width: int,
                         num_cameras: int | None = None,
                         device=None) -> Tracker2DState:
    """Zeroed 2D tracker state on `device` (default: the CUDA card; None
    raises without one).  num_cameras=None leaves out the camera axis: the
    state of one camera, for `make_tracker2d_step(cfg)`."""
    device = torch.device(device)
    lead = () if num_cameras is None else (num_cameras,)

    def z(shape, dtype=torch.float32):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    t, f, b = cfg.max_trackers, cfg.max_features, cfg.backtrack_interval
    return Tracker2DState(
        frames=z((b, height, width)),
        frames_lo=tuple(z((b, height // 2 ** l, width // 2 ** l))
                        for l in range(1, cfg.lk_pyramid_levels)),
        frame_count=z((), torch.int32),
        trk_active=z((t,), torch.bool),
        trk_id=z((t,), torch.int32),
        trk_boxes=z((t, b, 4)),
        trk_time_start=z((t,), torch.int32),
        trk_time_end=z((t,), torch.int32),
        trk_feats=z((t, f, 2)),
        trk_feat_valid=z((t, f), torch.bool),
        trk_location=z((t, 3)),
        trk_height=z((t,)),
        next_id=z((), torch.int32),
    )


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as jnp.linalg.norm computes it."""
    return torch.sqrt(torch.sum(x * x, -1))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-camera row gather: x [C, N, ...], idx [C, M] -> [C, M, ...]."""
    cam = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[cam, idx.long()]


def _scatter_drop(size: int, idx: torch.Tensor, values: torch.Tensor,
                  fill) -> torch.Tensor:
    """Per-camera `full(size, fill).at[idx].set(values, mode="drop")`:
    indices outside [0, size) write to a spare column that is cut off
    (the callers' kept indices are distinct per camera)."""
    c = idx.shape[0]
    out = torch.full((c, size + 1), fill, dtype=values.dtype,
                     device=idx.device)
    keep = (idx >= 0) & (idx < size)
    out.scatter_(1, torch.where(keep, idx, size).long(), values)
    return out[:, :size]


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def estimate_detection_height(cam: TsaiCamera, boxes: torch.Tensor):
    """Height + ground location per box via two-line triangulation
    (ref EstimateDetectionHeight, Tracker2D.cpp:1195-1220).  cam: stacked
    [C] camera; boxes: [C, D, 4]."""
    cam = cam.expand(1)
    bottom = torch.stack([boxes[..., 0] + torch.ceil(boxes[..., 2] / 2.0),
                          boxes[..., 1] + boxes[..., 3]], -1)
    top = bottom - torch.stack([torch.zeros_like(boxes[..., 3]),
                                boxes[..., 3]], -1)
    p11 = image_to_world(cam, top, 0.0)
    p12 = image_to_world(cam, top, 2000.0)
    p21 = image_to_world(cam, bottom, 0.0)
    p22 = torch.cat([p21[..., :2] + 0.0, p21[..., 2:] + 2000.0], -1)
    top_pt, _ = triangulate_two_lines(p11, p12, p21, p22)
    height = _norm(top_pt - p21)
    return height, p21


# ---------------------------------------------------------------------------
# disparity voting (LocalSearchKLT)
# ---------------------------------------------------------------------------

def local_search_klt(pre_boxes, pre_feats, cur_feats, feat_valid, cfg):
    """Mode-seeking disparity vote, batched over cameras and boxes
    (ref LocalSearchKLT, Tracker2D.cpp:455-554).

    Args:
      pre_boxes:  [C, N, 4]
      pre_feats, cur_feats: [C, N, F, 2]
      feat_valid: [C, N, F]

    Returns (new_boxes [C, N, 4], inlier [C, N, F], moved [C, N]).
    `moved` False means the static-majority early-out fired (ref :493-496).
    """
    mv = cur_feats - pre_feats
    disp = _norm(mv)
    moving = feat_valid & (disp >= cfg.klt_min_movement)
    num_valid = torch.sum(feat_valid, -1)
    num_moving = torch.sum(moving, -1)
    moved = num_moving >= 0.5 * num_valid

    win = pre_boxes[..., 2] * cfg.klt_neighbor_window_ratio   # [C, N]

    def axis_mode(vals):
        diff = torch.abs(vals[..., :, None] - vals[..., None, :])
        near = (diff < win[..., None, None]) & moving[..., None, :]
        cnt = torch.sum(near, -1)
        cnt = torch.where(moving, cnt, -1)
        best = torch.argmax(cnt, -1)                 # ties: first index
        return torch.gather(vals, -1, best[..., None])[..., 0]

    est = torch.stack([axis_mode(mv[..., 0]), axis_mode(mv[..., 1])], -1)
    inlier = moving & (_norm(mv - est[..., None, :]) < win[..., None])
    new_boxes = torch.cat([pre_boxes[..., 0:2] + est, pre_boxes[..., 2:]], -1)
    new_boxes = torch.where(moved[..., None], new_boxes, pre_boxes)
    inlier = torch.where(moved[..., None], inlier, False)
    return new_boxes, inlier, moved


def _box_center(b):
    return torch.stack([b[..., 0] + torch.ceil(b[..., 2] / 2.0),
                        b[..., 1] + torch.ceil(b[..., 3] / 2.0)], -1)


def _box_overlap(b1, b2):
    """bool overlap test (ref PSN_Rect::overlap, PSNWhere_Types.h:161-164)."""
    ox = (torch.maximum(b1[..., 0] + b1[..., 2], b2[..., 0] + b2[..., 2])
          - torch.minimum(b1[..., 0], b2[..., 0])) < b1[..., 2] + b2[..., 2]
    oy = (torch.maximum(b1[..., 1] + b1[..., 3], b2[..., 1] + b2[..., 3])
          - torch.minimum(b1[..., 1], b2[..., 1])) < b1[..., 3] + b2[..., 3]
    return ox & oy


def _box_distance(b1, b2):
    """descriptor distance (ref PSN_Rect::distance, PSNWhere_Types.h:165-170)."""
    b1, b2 = torch.broadcast_tensors(b1, b2)
    d1 = torch.stack([b1[..., 0] + b1[..., 2] / 2, b1[..., 1] + b1[..., 3] / 2,
                      b1[..., 2]], -1)
    d2 = torch.stack([b2[..., 0] + b2[..., 2] / 2, b2[..., 1] + b2[..., 3] / 2,
                      b2[..., 2]], -1)
    return _norm(d1 - d2) / torch.minimum(b1[..., 2], b2[..., 2])


def _overlap_area(b1, b2):
    ow = (torch.minimum(b1[..., 0] + b1[..., 2], b2[..., 0] + b2[..., 2])
          - torch.maximum(b1[..., 0], b2[..., 0]))
    oh = (torch.minimum(b1[..., 1] + b1[..., 3], b2[..., 1] + b2[..., 3])
          - torch.maximum(b1[..., 1], b2[..., 1]))
    return torch.clamp(ow, min=0.0) * torch.clamp(oh, min=0.0)


def _box_matching_cost(b1, b2):
    """(ref BoxMatchingCost, Tracker2D.cpp:615-630)"""
    nom = torch.sum((_box_center(b1) - _box_center(b2)) ** 2, -1)
    den = ((b1[..., 2] + b2[..., 2]) / 2.0) ** 2
    return nom / torch.clamp(den, min=1e-6)


# ---------------------------------------------------------------------------
# the per-frame step
# ---------------------------------------------------------------------------

def tracker2d_step(state: Tracker2DState,
                   gray: torch.Tensor,
                   det_boxes: torch.Tensor,
                   det_mask: torch.Tensor,
                   cam: TsaiCamera,
                   frame_idx,
                   cfg: Tracker2DConfig):
    """One frame for every camera.

    Args:
      state:     Tracker2DState ([C, ...] leaves).
      gray:      [C, H, W] float gray frames in [0, 1].
      det_boxes: [C, D, 4] padded detections (x, y, w, h).
      det_mask:  [C, D] bool.
      cam:       stacked TsaiCamera ([C] fields).
      frame_idx: frame number: an int, or a 0-dim int32 tensor on the
                 frames' device (as the JAX package's jnp.int32).

    Returns (new_state, Track2DOutput).
    """
    dev = gray.device
    bql = cfg.backtrack_interval
    n_cam = gray.shape[0]
    n_trk = cfg.max_trackers
    n_det = det_boxes.shape[1]
    n_feat = cfg.max_features

    # ---- frame buffer push ------------------------------------------------
    frames = torch.cat([state.frames[:, 1:], gray[:, None]], dim=1)
    g_pyr = build_pyramid(gray, cfg.lk_pyramid_levels)
    frames_lo = tuple(torch.cat([old[:, 1:], g_pyr[l + 1][:, None]], dim=1)
                      for l, old in enumerate(state.frames_lo))
    frame_count = torch.clamp(state.frame_count + 1, max=bql)

    def pyr_at(i):
        return [frames[:, i]] + [lo[:, i] for lo in frames_lo]

    # ---- 1. detection validation by height (ref :705-715) ------------------
    heights, locations = estimate_detection_height(cam, det_boxes)
    det_valid = (det_mask & (heights >= cfg.min_height_mm)
                 & (heights <= cfg.max_height_mm))

    # ---- 2. feature extraction (ref :735-757) ------------------------------
    grid = int(n_feat ** 0.5)
    det_feats, det_feat_valid = detect_grid_features(
        gray, det_boxes, det_valid, grid=grid, sub=2,
        quality=cfg.feature_quality_level)
    enough = torch.sum(det_feat_valid, -1) >= cfg.min_features
    det_valid = det_valid & enough

    # ---- 3. backward LK chain (ref :763-811) -------------------------------
    det_hist = torch.zeros((n_cam, n_det, bql, 4), dtype=det_boxes.dtype,
                           device=dev)
    det_hist[:, :, 0] = det_boxes
    chain_len = torch.ones((n_cam, n_det), dtype=torch.int32, device=dev)
    cur_feats = det_feats
    cur_valid = det_feat_valid
    cur_box = det_boxes
    alive = det_valid
    first_inliers = det_feats
    first_valid = det_feat_valid
    for j in range(1, bql):
        have_frame = (frame_count > j)[:, None]
        pts = cur_feats.reshape(n_cam, -1, 2)
        act = (cur_valid & alive[..., None]).reshape(n_cam, -1)
        tracked, status, _ = lk_track_prebuilt(
            pyr_at(bql - j), pyr_at(bql - 1 - j), pts,
            window=cfg.lk_window, iterations=cfg.lk_iterations, active=act)
        back_feats = tracked.reshape(n_cam, n_det, n_feat, 2)
        back_ok = status.reshape(n_cam, n_det, n_feat) & cur_valid
        new_box, inlier, moved = local_search_klt(
            cur_box, cur_feats, back_feats, back_ok, cfg)
        step_ok = (alive & have_frame & moved
                   & (torch.sum(inlier, -1) >= cfg.min_features))
        if j == 1:
            # keep the current-frame inlier features (ref :792-800)
            first_inliers = cur_feats
            first_valid = torch.where(step_ok[..., None], inlier,
                                      det_feat_valid)
        det_hist[:, :, j] = torch.where(step_ok[..., None], new_box, 0.0)
        chain_len = torch.where(step_ok, chain_len + 1, chain_len)
        cur_feats = torch.where(step_ok[..., None, None], back_feats,
                                cur_feats)
        cur_valid = torch.where(step_ok[..., None], inlier, cur_valid)
        cur_box = torch.where(step_ok[..., None], new_box, cur_box)
        alive = step_ok  # chain breaks stay broken (ref `break`, :788)

    # ---- 4. forward LK of live trackers (ref :851-1025) --------------------
    t_pts = state.trk_feats.reshape(n_cam, -1, 2)
    t_act = (state.trk_feat_valid & state.trk_active[..., None]).reshape(
        n_cam, -1)
    t_tracked, t_status, _ = lk_track_prebuilt(
        pyr_at(bql - 2), pyr_at(bql - 1), t_pts,
        window=cfg.lk_window, iterations=cfg.lk_iterations, active=t_act)
    trk_curr_feats = t_tracked.reshape(n_cam, n_trk, n_feat, 2)
    trk_track_ok = t_status.reshape(n_cam, n_trk, n_feat) \
        & state.trk_feat_valid
    trk_enough = torch.sum(trk_track_ok, -1) >= cfg.min_features
    trk_prev_box = state.trk_boxes[:, :, 0]
    trk_new_box, trk_inlier, _ = local_search_klt(
        trk_prev_box, state.trk_feats, trk_curr_feats, trk_track_ok, cfg)
    trk_predict_ok = state.trk_active & trk_enough

    # shift tracker box history and place predicted current box at index 0
    trk_boxes = torch.cat([trk_new_box[:, :, None], state.trk_boxes[:, :, :-1]],
                          dim=2)

    # ---- cost matrix (ref :928-1025) ---------------------------------------
    trk_len = torch.where(state.trk_active,
                          state.trk_time_end - state.trk_time_start + 2, 0)
    compare_len = torch.clamp(
        torch.minimum(chain_len[:, :, None], trk_len[:, None, :]),
        max=bql)                                     # [C, D, T]

    d_hist = det_hist[:, :, None, :, :]             # [C, D, 1, B, 4]
    t_hist = trk_boxes[:, None, :, :, :]            # [C, 1, T, B, 4]
    j_idx = torch.arange(bql, device=dev)
    in_window = j_idx < compare_len[..., None]      # [C, D, T, B]
    pair_cost = _box_matching_cost(t_hist, d_hist)
    gate = (_box_overlap(d_hist, t_hist)
            & (_box_distance(d_hist, t_hist) <= cfg.max_box_distance)
            & (_overlap_area(d_hist, t_hist)
               / torch.clamp(torch.minimum(d_hist[..., 2] * d_hist[..., 3],
                                           t_hist[..., 2] * t_hist[..., 3]),
                             min=1e-6) >= cfg.min_overlap_ratio)
            & (_norm(_box_center(d_hist) - _box_center(t_hist))
               <= cfg.max_box_center_diff_ratio
               * torch.maximum(d_hist[..., 2], t_hist[..., 2])))
    ok_window = torch.all(gate | ~in_window, dim=-1)
    mean_cost = (torch.sum(torch.where(in_window, pair_cost, 0.0), -1)
                 / torch.clamp(compare_len, min=1))

    overlap_now = _box_overlap(det_boxes[:, :, None], trk_new_box[:, None, :])
    # hard gates folded in before assignment (ref :937, :1071-1077)
    gate3d = (_norm(locations[:, :, None] - state.trk_location[:, None])
              <= cfg.max_detection_distance_mm)
    gate_h = (torch.abs(heights[:, :, None] - state.trk_height[:, None])
              <= cfg.max_height_difference_mm)
    gate_len = (trk_len[:, None, :] - 1) <= cfg.max_tracklet_length
    feasible = (det_valid[:, :, None] & trk_predict_ok[:, None, :]
                & overlap_now & ok_window & gate3d & gate_h & gate_len)
    cost = torch.where(feasible, mean_cost, torch.inf)

    # optical-flow majority veto (ref :981-1022): per detection, count the
    # tracked features of each overlapping tracker inside the det box
    fx = trk_curr_feats[:, None, :, :, 0]
    fy = trk_curr_feats[:, None, :, :, 1]
    db = det_boxes[:, :, None, None, :]
    inside = ((fx >= db[..., 0]) & (fx < db[..., 0] + db[..., 2])
              & (fy >= db[..., 1]) & (fy < db[..., 1] + db[..., 3])
              & trk_track_ok[:, None] & overlap_now[..., None]
              & trk_predict_ok[:, None, :, None])
    counts = torch.sum(inside, dim=-1)                # [C, D, T]
    total = torch.sum(counts, dim=-1)                 # [C, D]
    major = torch.max(counts, dim=-1).values
    veto = (total > 0) & (major <= cfg.min_flow_majority_ratio * total)
    cost = torch.where(veto[..., None], torch.inf, cost)

    # ---- 5. assignment (ref :1038-1107) ------------------------------------
    match_col, _ = solve_assignment_batch(cost, det_valid, trk_predict_ok)
    matched_det = match_col >= 0                                   # [C, D]
    det_ar = torch.arange(n_det, dtype=torch.int32, device=dev).expand(
        n_cam, n_det)
    trk_ar = torch.arange(n_trk, dtype=torch.int32, device=dev).expand(
        n_cam, n_trk)
    # tracker -> detection inverse map (dead writes routed out of bounds)
    det_of_trk = _scatter_drop(n_trk, torch.where(matched_det, match_col,
                                                  n_trk), det_ar, -1)
    trk_matched = det_of_trk >= 0
    safe_det = torch.where(trk_matched, det_of_trk, 0)

    # ---- tracker update (ref :1082-1106) -----------------------------------
    upd_box = _take(det_boxes, safe_det)
    trk_boxes[:, :, 0] = torch.where(trk_matched[..., None], upd_box,
                                     trk_boxes[:, :, 0])
    trk_time_end = torch.where(trk_matched, frame_idx, state.trk_time_end)
    trk_feats_new = torch.where(trk_matched[..., None, None],
                                _take(first_inliers, safe_det), trk_curr_feats)
    trk_feat_valid_new = torch.where(trk_matched[..., None],
                                     _take(first_valid, safe_det),
                                     trk_inlier & trk_track_ok)
    trk_location = torch.where(trk_matched[..., None],
                               _take(locations, safe_det), state.trk_location)
    trk_height = torch.where(trk_matched, _take(heights, safe_det),
                             state.trk_height)

    # unmatched trackers terminate (ref :1152-1164)
    trk_active = trk_matched

    # ---- tracker generation for unmatched detections (ref :1112-1147) ------
    new_det = det_valid & ~matched_det                   # [C, D]
    free = ~trk_active                                   # [C, T]
    # rank new detections and free slots; k-th new det takes k-th free slot
    det_rank = torch.cumsum(new_det.to(torch.int32), -1) - 1
    free_rank = torch.cumsum(free.to(torch.int32), -1) - 1
    slot_of_rank = _scatter_drop(n_trk, torch.where(free, free_rank, n_trk),
                                 trk_ar, -1)
    num_free = torch.sum(free, -1, keepdim=True)
    placed = new_det & (det_rank < num_free)
    target_slot = torch.where(
        placed, _take(slot_of_rank, torch.clamp(det_rank, 0, n_trk - 1)), -1)

    drop_idx = torch.where(placed, target_slot, n_trk)
    is_new = _scatter_drop(n_trk, drop_idx, torch.ones_like(placed), False)
    src_det = _scatter_drop(n_trk, drop_idx, det_ar, 0)

    new_ids = (state.next_id[:, None]
               + torch.cumsum(is_new.to(torch.int32), -1) - 1)
    trk_id = torch.where(is_new, new_ids, state.trk_id).to(torch.int32)
    next_id = (state.next_id + torch.sum(is_new, -1)).to(torch.int32)

    trk_boxes = torch.where(is_new[..., None, None], 0.0, trk_boxes)
    trk_boxes[:, :, 0] = torch.where(is_new[..., None],
                                     _take(det_boxes, src_det),
                                     trk_boxes[:, :, 0])
    trk_time_start = torch.where(is_new, frame_idx,
                                 state.trk_time_start).to(torch.int32)
    trk_time_end = torch.where(is_new, frame_idx, trk_time_end).to(
        torch.int32)
    trk_feats_new = torch.where(is_new[..., None, None],
                                _take(first_inliers, src_det), trk_feats_new)
    trk_feat_valid_new = torch.where(is_new[..., None],
                                     _take(first_valid, src_det),
                                     trk_feat_valid_new)
    trk_location = torch.where(is_new[..., None], _take(locations, src_det),
                               trk_location)
    trk_height = torch.where(is_new, _take(heights, src_det), trk_height)
    trk_active = trk_active | is_new

    new_state = Tracker2DState(
        frames=frames, frames_lo=frames_lo,
        frame_count=frame_count.to(torch.int32),
        trk_active=trk_active, trk_id=trk_id, trk_boxes=trk_boxes,
        trk_time_start=trk_time_start, trk_time_end=trk_time_end,
        trk_feats=trk_feats_new, trk_feat_valid=trk_feat_valid_new,
        trk_location=trk_location, trk_height=trk_height, next_id=next_id)

    out = Track2DOutput(
        ids=trk_id, boxes=trk_boxes[:, :, 0], mask=trk_active,
        locations=trk_location, heights=trk_height,
        det_boxes=det_boxes, det_mask=det_valid, cost_matrix=cost)
    return new_state, out


def make_tracker2d_step(cfg: Tracker2DConfig, multi_camera: bool = False):
    """The per-frame step with the JAX package's argument order,
    (state, gray, det_boxes, det_mask, cam, frame_idx) -> (state, out).

    multi_camera=True: leaves carry a leading camera axis and cam is a
    stacked TsaiCamera (this is `tracker2d_step`).  multi_camera=False:
    one camera — gray [H, W], det_boxes [D, 4], det_mask [D], a single
    camera and a state without the camera axis, which the step lifts to a
    one-camera batch and drops again.
    """
    def step(state, gray, det_boxes, det_mask, cam, frame_idx):
        return tracker2d_step(state, gray, det_boxes, det_mask, cam,
                              frame_idx, cfg)

    if multi_camera:
        return step

    def single(state, gray, det_boxes, det_mask, cam, frame_idx):
        new_state, out = step(tree_map(lambda x: x[None], state), gray[None],
                              det_boxes[None], det_mask[None],
                              tree_map(lambda x: x[None], cam), frame_idx)
        return tree_map(lambda x: x[0], (new_state, out))

    return single
