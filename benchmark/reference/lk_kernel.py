# Plain copy of mcmtt_opticalflow_tpu_torch/ops/lk_kernel.py (lk_level_reference) at commit 052b569610a6.
"""One pyramid level of iterative LK for a flat feature batch, in plain
PyTorch: per feature a bilinear (w+2)^2 template with central-difference
gradients, a det > 1e-7 gated 2x2 structure tensor, up to `iters` Newton
steps with a freeze once |ux|+|uy| <= 0.03, and the mean absolute
residual, inside a [PH, PW] patch whose corner is aligned to 8 rows and
128 columns (the corner decides where the estimate is clamped: to
[1, PH-w-2] x [1, PW-w-2] of the patch).  Inactive slots return the
patch corner with valid False and residual 0.
"""

from __future__ import annotations


import torch


PH = 40                  # patch rows
PW = 256                 # patch columns
MAX_WINDOW = 16          # largest window


def _corner(v: torch.Tensor, half_extent: int, add: int, align: int,
            hi: int) -> torch.Tensor:
    """Aligned patch corner with the point inside."""
    c = (torch.floor(v).to(torch.int32) - half_extent + add) & ~(align - 1)
    return torch.clamp(c, 0, hi)


def _window_idx(base: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                wh: int, width: int) -> torch.Tensor:
    """[N, wh, wh] flat indices of the windows whose top-left pixels are
    (iy, ix) [N] of the patches at flat index `base` (row pitch
    `width`)."""
    r = torch.arange(wh, device=base.device)
    return (base[:, None, None]
            + (iy.long()[:, None, None] + r[None, :, None]) * width
            + ix.long()[:, None, None] + r[None, None, :])


def _sample(flat: torch.Tensor, base: torch.Tensor, y: torch.Tensor,
            x: torch.Tensor, wh: int, width: int) -> torch.Tensor:
    """Bilinear [N, wh, wh] windows at float origins (y, x) [N] of the
    patches whose top-left pixel is flat[base] (row pitch `width`): rows
    interpolate first, then columns."""
    iy = torch.floor(y)
    ix = torch.floor(x)
    fy = (y - iy)[:, None, None]
    fx = (x - ix)[:, None, None]
    idx = _window_idx(base, iy, ix, wh, width)
    a = (1.0 - fy) * flat[idx] + fy * flat[idx + width]
    b = (1.0 - fy) * flat[idx + 1] + fy * flat[idx + width + 1]
    return a * (1.0 - fx) + b * fx


def _check(prev, next_img, cam_idx, points, guess, active, window):
    if prev.dim() != 3 or prev.shape != next_img.shape:
        raise ValueError(f"prev/next must be equal [C, H, W]: "
                         f"{tuple(prev.shape)} {tuple(next_img.shape)}")
    n = points.shape[0]
    if (points.shape != (n, 2) or guess.shape != (n, 2)
            or cam_idx.shape != (n,) or active.shape != (n,)):
        raise ValueError("points/guess must be [N, 2], cam_idx/active [N]")
    _, h, w = prev.shape
    ph, pw = min(PH, h), min(PW, w)
    if not 1 <= window <= MAX_WINDOW or ph - window - 2 < 1 \
            or pw - window - 2 < 1:
        raise ValueError(f"window {window} does not fit a {ph}x{pw} patch "
                         f"(largest window {MAX_WINDOW})")
    return ph, pw


def _corners(points, guess, ph: int, pw: int, h: int, wid: int):
    """Patch corners (y0p, x0p) of the points and (y0n, x0n) of the
    guesses."""
    hy, hx = max(h - ph, 0), max(wid - pw, 0)
    return (_corner(points[:, 1], ph // 2, 4, 8, hy),
            _corner(points[:, 0], pw // 2, 64, 128, hx),
            _corner(guess[:, 1], ph // 2, 4, 8, hy),
            _corner(guess[:, 0], pw // 2, 64, 128, hx))


def _newton(ext, w: int, warp, dy, dx, go, iters: int):
    """Template, gradients and structure tensor from the (w+2)^2 window
    `ext` [N, w+2, w+2], then up to `iters` Newton steps from (dy, dx);
    `warp(dy, dx, mask)` -> (window [N, w, w], dy_c, dx_c) samples the
    next image at the clamped estimate.  A feature freezes after the
    step whose |ux|+|uy| <= 0.03.  Returns (dy, dx, ok_g, resid, dy_c, dx_c)."""
    t = ext[:, 1:w + 1, 1:w + 1]
    gx = 0.5 * (ext[:, 1:w + 1, 2:w + 2] - ext[:, 1:w + 1, 0:w])
    gy = 0.5 * (ext[:, 2:w + 2, 1:w + 1] - ext[:, 0:w, 1:w + 1])
    gxx = (gx * gx).sum((1, 2))
    gxy = (gx * gy).sum((1, 2))
    gyy = (gy * gy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    ok_g = det > 1e-7
    inv_det = torch.where(ok_g, 1.0 / torch.where(ok_g, det, 1.0), 0.0)
    active = go
    for _ in range(iters):
        warped, dy_c, dx_c = warp(dy, dx, go)
        diff = warped - t
        bx = (diff * gx).sum((1, 2))
        by = (diff * gy).sum((1, 2))
        ux = -(gyy * bx - gxy * by) * inv_det
        uy = -(-gxy * bx + gxx * by) * inv_det
        dy = torch.where(go, dy_c + uy, dy)
        dx = torch.where(go, dx_c + ux, dx)
        go = go & ((torch.abs(ux) + torch.abs(uy)) > 0.03)
    warped, dy_c, dx_c = warp(dy, dx, active)
    resid = torch.abs(warped - t).sum((1, 2)) * (1.0 / (w * w))
    return dy, dx, ok_g, resid, dy_c, dx_c


def lk_level_reference(prev, next_img, cam_idx, points, guess, active,
                       window: int = 16, iters: int = 10):
    """One LK level (see the module docstring).

    Args:
      prev, next_img: [C, H, W] float32.
      cam_idx: [N] int camera of each feature.
      points:  [N, 2] (x, y) source positions.
      guess:   [N, 2] (x, y) initial target positions.
      active:  [N] bool.

    Returns (tracked [N, 2] f32, valid [N] bool, resid [N] f32).
    """
    ph, pw = _check(prev, next_img, cam_idx, points, guess, active, window)
    c, h, wid = prev.shape
    w = window
    half = (w - 1) / 2.0
    lo, hi_y, hi_x = 1.0, float(ph - w - 2), float(pw - w - 2)
    active = active.bool()
    y0p, x0p, y0n, x0n = _corners(points, guess, ph, pw, h, wid)
    sy = (points[:, 1] - y0p.float()) - half
    sx = (points[:, 0] - x0p.float()) - half
    gy0 = (guess[:, 1] - y0n.float()) - half
    gx0 = (guess[:, 0] - x0n.float()) - half

    plane = cam_idx.long() * (h * wid)
    base_p = plane + y0p.long() * wid + x0p.long()
    base_n = plane + y0n.long() * wid + x0n.long()
    fp = prev.reshape(-1).float()
    fn = next_img.reshape(-1).float()

    src_ok = (sy >= lo) & (sy <= hi_y) & (sx >= lo) & (sx <= hi_x)
    sy_c = torch.clamp(sy, lo, hi_y)
    sx_c = torch.clamp(sx, lo, hi_x)
    # inactive slots sample a safe in-patch origin; their outputs are
    # overwritten below
    one = torch.ones_like(sy_c)
    ty = torch.where(active, sy_c - 1.0, one)
    tx = torch.where(active, sx_c - 1.0, one)
    ext = _sample(fp, base_p, ty, tx, w + 2, wid)

    def warp(dy, dx, mask):
        dy_c = torch.clamp(dy, lo, hi_y)
        dx_c = torch.clamp(dx, lo, hi_x)
        oy = torch.where(active, dy_c, one)
        ox = torch.where(active, dx_c, one)
        return _sample(fn, base_n, oy, ox, w, wid), dy_c, dx_c

    dy, dx, ok_g, resid, dy_c, dx_c = _newton(ext, w, warp, gy0, gx0,
                                              active, iters)
    in_range = (dy >= lo) & (dy <= hi_y) & (dx >= lo) & (dx <= hi_x)
    valid = ok_g & src_ok & in_range & active
    zero = torch.zeros_like(dx_c)
    tracked = torch.stack(
        [torch.where(active, dx_c + half, zero) + x0n.float(),
         torch.where(active, dy_c + half, zero) + y0n.float()], -1)
    return tracked, valid, torch.where(active, resid, zero)
