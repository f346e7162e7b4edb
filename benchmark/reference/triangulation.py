# Frozen copy of mcmtt_opticalflow_tpu_torch/geometry/triangulation.py at commit 052b569610a6, for the benchmark's
# plain reference; imports point at the copies beside it.
"""Batched 3D reconstruction primitives (port of
mcmtt_opticalflow_tpu/geometry/triangulation.py).  Everything broadcasts
over leading batch axes."""

from __future__ import annotations

import torch


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, as jnp.linalg.norm computes it."""
    return torch.sqrt(torch.sum(x * x, -1, keepdim=keepdim))


def triangulate_two_lines(p1a, p1b, p2a, p2b):
    """Closest-point midpoint of two 3D lines (batched), solving the 2x2
    normal equations in closed form (ref PSNWhere_Utils.cpp:499-525).

    Returns (midpoint [..., 3], gap distance [...])."""
    d1 = p1a - p1b
    d2 = p2a - p2b
    off = p2b - p1b
    a11 = torch.sum(d1 * d1, -1)
    a12 = torch.sum(d1 * -d2, -1)
    a21 = torch.sum(d2 * d1, -1)
    a22 = torch.sum(d2 * -d2, -1)
    b1 = torch.sum(d1 * off, -1)
    b2 = torch.sum(d2 * off, -1)
    det = a11 * a22 - a12 * a21
    degenerate = torch.abs(det) < 1e-12
    safe_det = torch.where(degenerate, 1.0, det)
    t1 = (b1 * a22 - a12 * b2) / safe_det
    t2 = (a11 * b2 - b1 * a21) / safe_det
    c1 = p1b + d1 * t1[..., None]
    c2 = p2b + d2 * t2[..., None]
    mid = 0.5 * (c1 + c2)
    gap = torch.linalg.norm(c1 - c2, dim=-1)
    gap = torch.where(degenerate, torch.inf, gap)
    return mid, gap


def nview_point_reconstruction(points_a, points_b, mask):
    """Least-squares intersection of N back-projection lines (batched):
    A x = b with A = sum_i P_i^T P_i, P_i = v_i v_i^T - I, over the masked
    lines, then the mean point-to-line distance (ref
    PSNWhere_Associator3D.cpp:930-982).

    Args:
      points_a: [..., N, 3] line first points (e.g. z=2000 ends).
      points_b: [..., N, 3] line second points (e.g. ground ends).
      mask:     [..., N] bool, which lines participate.

    Returns (point [..., 3], mean_distance [...], num_lines [...]).  With
    fewer than 2 valid lines the point is the first valid line's second
    point and the distance 0 (the caller applies its fallback).
    """
    m = mask[..., None].to(points_a.dtype)
    d = points_b - points_a
    d = d / torch.clamp(_norm(d, keepdim=True), min=1e-12)
    eye = torch.eye(3, dtype=points_a.dtype, device=points_a.device)
    p = d[..., :, None] * d[..., None, :] - eye        # [..., N, 3, 3]
    pp = (p @ p) * m[..., None]                         # P^T P (P symmetric)
    a_mat = torch.sum(pp, dim=-3)                       # [..., 3, 3]
    b_vec = torch.sum(pp @ (points_a * m)[..., None], dim=(-3, -1))
    # regularise masked-out / degenerate batches with the identity
    num = torch.sum(mask, dim=-1)
    degenerate = (num < 2)[..., None, None]
    a_mat = torch.where(degenerate, eye, a_mat)
    # torch.linalg.solve without its error check (which raises on a
    # singular system and syncs the card): like jnp.linalg.solve, a
    # singular system (parallel lines) yields non-finite values
    x = torch.linalg.solve_ex(a_mat, b_vec[..., None])[0][..., 0]

    # fallback for < 2 lines: the first valid line's second point
    first_idx = torch.argmax(mask.to(torch.uint8), dim=-1)
    fallback = torch.take_along_dim(
        points_b, first_idx[..., None, None].expand(
            first_idx.shape + (1, 3)), dim=-2)[..., 0, :]
    point = torch.where(degenerate[..., 0], fallback, x)

    # mean distance from the point to each masked line (ref :965-979)
    lam = torch.sum(d * (point[..., None, :] - points_a), -1)
    foot = points_a + lam[..., None] * d
    dist = _norm(foot - point[..., None, :])
    mean_dist = torch.sum(dist * mask, -1) / torch.clamp(num, min=1)
    mean_dist = torch.where(num < 2, 0.0, mean_dist)
    return point, mean_dist, num


def nview_ground_reconstruction(ground_points, mask):
    """Mean of per-camera ground-plane points + mean scatter distance
    (full-body PETS mode, ref PSNWhere_Associator3D.cpp:995-1046 with
    CONSIDER_SENSITIVITY=false).

    Args:
      ground_points: [..., N, 3] per-camera ground points (z==0).
      mask:          [..., N] bool.

    Returns (point [..., 3], mean_distance [...], num_points [...]);
    mean_distance is 0 below 2 points (ref :1030-1036 is the caller's).
    """
    m = mask[..., None].to(ground_points.dtype)
    num = torch.sum(mask, dim=-1)
    denom = torch.clamp(num, min=1)[..., None]
    point = torch.sum(ground_points * m, dim=-2) / denom
    dist = _norm(point[..., None, :] - ground_points)
    mean_dist = torch.sum(dist * mask, dim=-1) / torch.clamp(num, min=1)
    mean_dist = torch.where(num < 2, 0.0, mean_dist)
    return point, mean_dist, num


def segments_intersect(a1, a2, b1, b2):
    """2D (x, y) segment intersection test, batched
    (ref psn_where/PSNWhere_Utils.cpp:472-487)."""
    s1x = a2[..., 0] - a1[..., 0]
    s1y = a2[..., 1] - a1[..., 1]
    s2x = b2[..., 0] - b1[..., 0]
    s2y = b2[..., 1] - b1[..., 1]
    den = -s2x * s1y + s1x * s2y
    safe = torch.where(torch.abs(den) < 1e-12, 1.0, den)
    s = (-s1y * (a1[..., 0] - b1[..., 0])
         + s1x * (a1[..., 1] - b1[..., 1])) / safe
    t = (s2x * (a1[..., 1] - b1[..., 1])
         - s2y * (a1[..., 0] - b1[..., 0])) / safe
    hit = (s >= 0) & (s <= 1) & (t >= 0) & (t <= 1)
    return hit & (torch.abs(den) >= 1e-12)
