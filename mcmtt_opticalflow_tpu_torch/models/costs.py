"""Device-batched track cost model (port of
mcmtt_opticalflow_tpu/models/costs.py).

cost = enter + reconstruction + link + RGB + exit (ref GetCost,
psn_where/PSNWhere_Associator3D.cpp:2567-2578); the window terms
(reconstruction and link) are scored here for a batch of padded track
windows, and the enter / exit / connectivity terms are batched functions
beside them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmtt_opticalflow_tpu_torch.config import Associator3DConfig
from mcmtt_opticalflow_tpu_torch.geometry.tsai import (TsaiCamera,
                                                       check_visibility)
from mcmtt_opticalflow_tpu_torch.ops.sgsmooth import sg_smooth_masked


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as jnp.linalg.norm computes it."""
    return torch.sqrt(torch.sum(x * x, -1))


def link_probability(p1, p2, time_gap, max_speed: float = 900.0):
    """Motion link probability 0.5*erfc(4d/maxDist - 2)
    (ref ComputeLinkProbability, Associator3D.cpp:2314-2319)."""
    d = _norm(p1 - p2)
    max_dist = max_speed * max(float(time_gap), 1.0)
    return 0.5 * torch.special.erfc(4.0 * d / max_dist - 2.0)


def reconstruction_probability(point, raw_points, raw_mask, max_error,
                               visible, cfg: Associator3DConfig):
    """Scatter + detection-likelihood probability ratio of a
    reconstruction (ref ComputeReconstructionProbability,
    Associator3D.cpp:2346-2383); 0 encodes invalidation."""
    num = torch.sum(raw_mask, -1)
    d = _norm(point[..., None, :] - raw_points)
    mean_d = (torch.sum(torch.where(raw_mask, d, 0.0), -1)
              / torch.clamp(num, min=1))
    fallback = (cfg.max_sensitivity_error if cfg.consider_sensitivity
                else cfg.max_body_width / 2.0)
    max_err = torch.where(max_error == 0.0, fallback, max_error)
    p = torch.where(num > 1,
                    0.5 * torch.special.erfc(4.0 * mean_d / max_err - 2.0),
                    0.5)
    valid = ~((num > 1) & (mean_d > max_err))

    fp, fn = cfg.fp_rate, cfg.fn_rate
    pos = (1.0 - fp) / fp
    neg = fn / (1.0 - fn)
    per_cam = torch.where(visible, torch.where(raw_mask, pos, neg), 1.0)
    ratio = torch.prod(per_cam, dim=-1)
    p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    return torch.where(valid, ratio * p / (1.0 - p), 0.0)


def _tensor(x, like=None) -> torch.Tensor:
    """x as a float32 tensor (Python numbers too), on `like`'s device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32,
                           device=None if like is None else like.device)


def enter_probability(distance_from_boundary, penalty_free, cfg):
    """(ref ComputeEnterProbability, Associator3D.cpp:2267-2277);
    distance < 0 means outside every view."""
    d = _tensor(distance_from_boundary)
    p = torch.where(
        d < 0, 1.0,
        torch.where(d <= cfg.boundary_distance, 1.0,
                    cfg.p_en_max * torch.exp(
                        -cfg.p_en_decay * torch.clamp(
                            d - cfg.boundary_distance, min=0.0))))
    cost = torch.clamp(-torch.log(p), max=cfg.cost_enter_max)
    return torch.where(torch.as_tensor(penalty_free, device=d.device), 0.0,
                       cost)


def exit_cost(distance_from_boundary, track_length, cfg):
    """(ref ComputeExitProbability, Associator3D.cpp:2288-2303)."""
    d = _tensor(distance_from_boundary)
    length = _tensor(track_length, d)
    p_far = (cfg.p_ex_max
             * torch.exp(-cfg.p_ex_decay_dist
                         * torch.clamp(d - cfg.boundary_distance, min=0.0))
             * torch.exp(-cfg.p_ex_decay_length
                         * torch.clamp(length
                                       - cfg.num_frames_for_confirmation,
                                       min=0.0)))
    p = torch.where(d < 0, 1.0,
                    torch.where(d < cfg.boundary_distance, cfg.p_ex_max,
                                p_far))
    return torch.clamp(-torch.log(p), max=cfg.cost_exit_max)


def tracklet_connectivity(end_point, start_point, sens1, sens2, time_gap,
                          cfg):
    """Gate linking consecutive tracklets of one camera within a track
    (ref CheckTrackletConnectivity, Associator3D.cpp:791-796)."""
    d = _norm(_tensor(end_point) - _tensor(start_point))
    sens = _tensor(sens1, d) + _tensor(sens2, d)
    thresh = torch.clamp(cfg.e_cal + cfg.e_det * sens,
                         min=cfg.cost_tracklet_link_min_dist)
    return (_tensor(time_gap, d) > 1) | (d <= thresh)


class WindowScore(NamedTuple):
    smoothed: torch.Tensor        # [N, W, 3]
    velocity: torch.Tensor        # [N, W, 3]
    cost_recon: torch.Tensor      # [N, W] per-position -log p_recon
    cost_link: torch.Tensor       # [N, W] per-position -log p_link
    window_cost: torch.Tensor     # [N] sum of the above over valid positions
    valid: torch.Tensor           # [N] no zero-probability position


def score_track_windows(points, raw_points, raw_mask, max_error, lengths,
                        cams: TsaiCamera, cfg: Associator3DConfig):
    """Smooth + cost a batch of track windows in one pass (the reference's
    per-track "insert, re-smooth tail, re-cost" loop, ref
    Associator3D.cpp:1468-1516, as a batch).

    Args:
      points:     [N, W, 3] raw reconstruction points (window tail).
      raw_points: [N, W, C, 3] per-camera raw points.
      raw_mask:   [N, W, C] bool.
      max_error:  [N, W].
      lengths:    [N] valid positions per window.
      cams:       stacked TsaiCamera ([C] fields).
    """
    n, w, _ = points.shape
    short = lengths < (cfg.sg_span // 2)        # MIN_SMOOTHING_LENGTH gate
    smoothed = sg_smooth_masked(points, lengths, cfg.sg_span, cfg.sg_degree)
    smoothed = torch.where(short[:, None, None], points, smoothed)

    pos_idx = torch.arange(w, device=points.device)[None, :]
    pos_valid = pos_idx < lengths[:, None]

    vis = check_visibility(cams.expand(2), smoothed).permute(1, 2, 0)
    p_recon = reconstruction_probability(
        smoothed, raw_points, raw_mask, max_error, vis, cfg)
    # the 1e-300 floor is 0 in float32 (as in the JAX version): p=0 -> inf
    cost_recon = -torch.log(torch.clamp(p_recon, min=1e-300))

    p_link = link_probability(smoothed[:, :-1], smoothed[:, 1:], 1.0,
                              cfg.max_moving_speed)
    p_link = torch.cat([torch.ones((n, 1), dtype=points.dtype,
                                   device=points.device), p_link], dim=1)
    link_valid = pos_valid & (pos_idx > 0)
    cost_link = -torch.log(torch.clamp(p_link, min=1e-300))

    velocity = torch.diff(smoothed, dim=1, prepend=smoothed[:, :1])
    speed = _norm(velocity)
    velocity = torch.where((speed > cfg.min_moving_speed)[..., None],
                           velocity, 0.0)

    long_ = ~short[:, None]
    bad = ((pos_valid & long_ & (p_recon == 0.0))
           | (link_valid & long_ & (p_link == 0.0)))
    valid = ~torch.any(bad, dim=1)

    # positions below the smoothing-length gate keep zero incremental cost
    # contribution until the track is long enough (ref :1475, :1507-1511)
    use = pos_valid & long_
    cost_recon = torch.where(use, cost_recon, 0.0)
    cost_link = torch.where(link_valid & long_, cost_link, 0.0)
    window_cost = torch.sum(cost_recon, 1) + torch.sum(cost_link, 1)
    return WindowScore(smoothed=smoothed, velocity=velocity,
                       cost_recon=cost_recon, cost_link=cost_link,
                       window_cost=window_cost, valid=valid)
