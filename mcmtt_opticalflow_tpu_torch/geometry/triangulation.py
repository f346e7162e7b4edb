"""Batched 3D reconstruction primitives (port of
mcmtt_opticalflow_tpu/geometry/triangulation.py; the two the main path
uses).  Everything broadcasts over leading batch axes."""

from __future__ import annotations

import torch


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
