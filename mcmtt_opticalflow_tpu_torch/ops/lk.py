"""Batched pyramidal Lucas-Kanade optical flow (port of
mcmtt_opticalflow_tpu/ops/lk.py).

Two single-level paths, chosen per level from the shapes exactly as the
JAX package chooses between its Pallas kernel and its XLA gather path
(lk.py:154-159): levels at least 40 rows high, 128 columns wide, with a
row count divisible by 8 and a per-camera feature count divisible by 8
go to the LK level kernel (ops/lk_kernel.py: CUDA on the card, its plain
version on the CPU) over all cameras' features flattened to [C*N];
smaller levels use the gather path `lk_track_points`, one camera at a
time.  Inputs are gray float images in [0, 1].

MCMTT_LK_BACKEND=pallas|xla, read on every call (`use_kernel`), is the
JAX package's switch (lk.py:112-123), honoured for CPU tensors only:
there `xla` takes the gather path at every level, as the JAX `xla_impl`
does, and unset, `pallas` or any other value keeps the rule above.
Unset differs from the JAX default off a TPU (its gather path): here the
card plays the TPU's part, so unset means the kernel.  CUDA tensors
always take the rule above, whatever the switch says: on the card every
kernel-sized level launches the kernel.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch

from mcmtt_opticalflow_tpu_torch.ops.lk_kernel import lk_level
from mcmtt_opticalflow_tpu_torch.ops.pyramid import (build_pyramid,
                                                     edge_pad_to,
                                                     image_gradients)


def _bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample, clamped to the image. img: [H, W]; xy: [..., 2]."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def _window_offsets(window: int, dtype, device):
    half = (window - 1) / 2.0
    r = torch.arange(window, dtype=dtype, device=device) - half
    ox, oy = torch.meshgrid(r, r, indexing="xy")
    return torch.stack([ox, oy], -1).reshape(-1, 2)       # [window^2, 2]


def lk_track_points(prev_img, next_img, prev_ix, prev_iy, points, guess,
                    window: int = 16, iterations: int = 10,
                    eps: float = 0.03):
    """Single-level iterative LK for a batch of points (gather path).

    Args:
      prev_img, next_img: [H, W] gray.
      prev_ix, prev_iy:   [H, W] gradients of prev_img.
      points: [N, 2] source (x, y) in prev_img.
      guess:  [N, 2] initial target positions in next_img.

    Returns (tracked [N, 2], valid [N], residual [N]).
    """
    offs = _window_offsets(window, points.dtype, points.device)
    pw = points[:, None, :] + offs[None, :, :]
    t_patch = _bilinear(prev_img, pw)
    gx = _bilinear(prev_ix, pw)
    gy = _bilinear(prev_iy, pw)
    gxx = torch.sum(gx * gx, -1)
    gxy = torch.sum(gx * gy, -1)
    gyy = torch.sum(gy * gy, -1)
    det = gxx * gyy - gxy * gxy
    ok_g = det > 1e-7
    inv_det = torch.where(ok_g, 1.0 / torch.where(ok_g, det, 1.0), 0.0)

    cur = guess
    go = torch.ones(points.shape[:1], dtype=torch.bool, device=points.device)
    for _ in range(iterations):
        nw = cur[:, None, :] + offs[None, :, :]
        di = _bilinear(next_img, nw) - t_patch
        bx = torch.sum(di * gx, -1)
        by = torch.sum(di * gy, -1)
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(-gxy * bx + gxx * by) * inv_det
        step = torch.stack([dx, dy], -1)
        cur = cur + torch.where((ok_g & go)[:, None], step, 0.0)
        # per-feature convergence: apply the sub-eps step, then stop
        go = go & ((torch.abs(dx) + torch.abs(dy)) > eps)

    h, w = next_img.shape
    half = (window - 1) / 2.0
    inb = ((cur[:, 0] >= half) & (cur[:, 0] < w - half)
           & (cur[:, 1] >= half) & (cur[:, 1] < h - half))
    nw = cur[:, None, :] + offs[None, :, :]
    resid = torch.mean(torch.abs(_bilinear(next_img, nw) - t_patch), dim=-1)
    valid = ok_g & inb
    return cur, valid, resid


def kernel_ok(h: int, w: int, n: int) -> bool:
    """The JAX package's pallas_ok shape rule (lk.py:154-159): the patch
    kernel needs room for its tile-aligned margins and a feature count
    divisible by its batch of 8."""
    return h >= 40 and w >= 128 and h % 8 == 0 and n % 8 == 0


def use_kernel() -> bool:
    """False when MCMTT_LK_BACKEND is `xla` (any case): every level of a
    CPU run then takes the gather path.  Read on every call, never at
    import."""
    return os.environ.get("MCMTT_LK_BACKEND", "").lower() != "xla"


_CAM_INDEX = {}


def _cam_index(c: int, n: int, device) -> torch.Tensor:
    """[C*N] int32 camera of each flattened slot, built once per
    (C, N, device) and reused by every later call."""
    key = (c, n, str(device))
    if key not in _CAM_INDEX:
        _CAM_INDEX[key] = torch.arange(
            c, dtype=torch.int32, device=device).repeat_interleave(n)
    return _CAM_INDEX[key]


def lk_level_cams(prev, nxt, src, cur, act, window: int, iterations: int):
    """One level over all cameras. prev, nxt: [C, H, W]; src, cur:
    [C, N, 2]; act: [C, N] bool.  Returns ([C, N, 2], [C, N], [C, N])."""
    c, h, w = prev.shape
    n = src.shape[1]
    if kernel_ok(h, w, n) and (prev.is_cuda or use_kernel()):
        # the patch kernel reads 8-row / 128-column aligned patches:
        # edge-pad the level images (lk.py:142-150)
        prev_p = edge_pad_to(prev, 8, 128)
        nxt_p = edge_pad_to(nxt, 8, 128)
        tracked, valid, resid = lk_level(
            prev_p, nxt_p, _cam_index(c, n, prev.device),
            src.reshape(c * n, 2), cur.reshape(c * n, 2), act.reshape(c * n),
            window=window, iters=iterations)
        return (tracked.reshape(c, n, 2), valid.reshape(c, n),
                resid.reshape(c, n))
    outs = []
    for ci in range(c):
        ix, iy = image_gradients(prev[ci])
        outs.append(lk_track_points(prev[ci], nxt[ci], ix, iy, src[ci],
                                    cur[ci], window=window,
                                    iterations=iterations))
    return tuple(torch.stack(o) for o in zip(*outs))


def lk_track_prebuilt(prev_pyr: Sequence[torch.Tensor],
                      next_pyr: Sequence[torch.Tensor],
                      points: torch.Tensor,
                      window: int = 16,
                      iterations: int = 10,
                      max_residual: float = 0.08,
                      active: torch.Tensor | None = None):
    """Pyramidal LK over prebuilt pyramids (finest first) of all cameras.

    prev_pyr/next_pyr: per level [C, H_l, W_l]; points: [C, N, 2];
    active: [C, N] bool.  Returns (tracked [C, N, 2], status [C, N],
    residual [C, N])."""
    levels = len(prev_pyr)
    scale = 2.0 ** (levels - 1)
    cur = points / scale
    if active is None:
        active = torch.ones(points.shape[:2], dtype=torch.bool,
                            device=points.device)
    valid = active
    resid = torch.zeros(points.shape[:2], dtype=points.dtype,
                        device=points.device)
    for lvl in range(levels - 1, -1, -1):
        src = points / (2.0 ** lvl)
        cur, v, resid = lk_level_cams(prev_pyr[lvl], next_pyr[lvl], src, cur,
                                      active, window, iterations)
        valid = valid & v
        if lvl > 0:
            cur = cur * 2.0
    status = valid & (resid < max_residual)
    return cur, status, resid


def lk_track_pyramid(prev_img: torch.Tensor,
                     next_img: torch.Tensor,
                     points: torch.Tensor,
                     levels: int = 3,
                     window: int = 16,
                     iterations: int = 10,
                     max_residual: float = 0.08,
                     active: torch.Tensor | None = None):
    """Pyramidal LK: track [N, 2] points from prev_img to next_img.

    Images are [H, W] float gray in [0, 1]; H, W divisible by
    2**(levels-1).  Builds both pyramids and tracks as one camera, so each
    level takes the route `lk_level_cams` picks from its shape: the LK
    level kernel (launched for CUDA tensors) or the gather path.
    `active` marks real (non-padding) features; inactive ones return
    status False.  Returns (tracked [N, 2], status [N] bool, residual
    [N]).
    """
    prev_pyr = build_pyramid(prev_img[None], levels)
    next_pyr = build_pyramid(next_img[None], levels)
    tracked, status, resid = lk_track_prebuilt(
        prev_pyr, next_pyr, points[None], window=window,
        iterations=iterations, max_residual=max_residual,
        active=None if active is None else active[None])
    return tracked[0], status[0], resid[0]
