# Plain copy of mcmtt_opticalflow_tpu_torch/ops/lk.py (lk_track_prebuilt) at commit 052b569610a6.
"""Batched pyramidal Lucas-Kanade optical flow, in plain PyTorch.

Each level takes one of two single-level paths, chosen from its shape as
the program chooses: a level at least 40 rows high and 128 columns wide,
with a row count divisible by 8 and a per-camera feature count divisible
by 8, runs `lk_level_reference` (lk_kernel.py) over every camera's
features at once, on images edge-padded to 8 rows and 128 columns;
smaller levels take the gather path `lk_track_points`, one camera at a
time.  Inputs are gray float images in [0, 1].
"""

from __future__ import annotations

from typing import Sequence

import torch

from reference.lk_kernel import lk_level_reference
from reference.pyramid import edge_pad_to, image_gradients


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
    """Whether a level takes `lk_level_reference` (room for the aligned
    patch, features in batches of 8)."""
    return h >= 40 and w >= 128 and h % 8 == 0 and n % 8 == 0


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
    if kernel_ok(h, w, n):
        # aligned patches: edge-pad the level images
        prev_p = edge_pad_to(prev, 8, 128)
        nxt_p = edge_pad_to(nxt, 8, 128)
        tracked, valid, resid = lk_level_reference(
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
