"""One pyramid level of iterative LK for a flat feature batch: the
hand-written CUDA kernels (csrc/lk_level.cu) and their plain PyTorch
versions, in the two variants of the JAX package's lk_level_pallas.

Both variants compute, per feature, a bilinear (w+2)^2 template with
central-difference gradients, a det > 1e-7 gated 2x2 structure tensor,
up to `iters` Newton steps with a freeze once |ux|+|uy| <= 0.03, and the
mean absolute residual, inside a [PH, PW] patch whose corner is
tile-aligned (the TPU's DMA patch; the corner decides where the estimate
is clamped, so it stays).  Inactive slots return the patch corner with
valid False and residual 0.  They differ in where the estimate may go
and in how a tap is blended:

- "batched" (the default; lk_pallas.py::_make_kernel_batched): the
  estimate is clamped to the whole patch, [1, PH-w-2] x [1, PW-w-2];
  taps blend rows first, then columns.
- "serial" (lk_pallas.py::_make_kernel): the Newton steps run in a
  32x128 working subpatch placed around the initial guess, so the
  estimate is clamped to about -7..+6 rows and -55..+54 columns (w=16)
  of the guess's floor, intersected with the patch; a result outside
  that range is invalid.  Taps blend with the four-term formula
  a(1-fy)(1-fx) + b(1-fy)fx + c fy(1-fx) + d fy fx.

`lk_level` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  The kernels build with nvcc at
first use into ``_build/`` beside the package (see .gitignore;
ops/nvcc_build.py).
"""

from __future__ import annotations

import ctypes

import torch

from mcmtt_opticalflow_tpu_torch.ops.nvcc_build import build_library

PH = 40                  # patch rows of the TPU kernel (lk_pallas.PH)
PW = 256                 # patch columns
SUBH = 32                # working subpatch of the serial variant
SUBW = 128
MAX_WINDOW = 16          # per-lane register arrays in the CUDA kernel
VARIANTS = ("batched", "serial")


def build() -> ctypes.CDLL:
    """The library of csrc/lk_level.cu, built at first use (named by the
    source hash, so an edited source rebuilds) and loaded once."""
    lib, _, _ = build_library("lk_level.cu")
    if lib.lk_level_launch.argtypes is None:
        for fn in (lib.lk_level_launch, lib.lk_level_serial_launch):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
        lib.lk_level_max_window.restype = ctypes.c_int
        lib.lk_level_max_window.argtypes = []
        lib.lk_noop_launch.restype = ctypes.c_int
        lib.lk_noop_launch.argtypes = [ctypes.c_void_p]
        lib.lk_level_stage_margin.restype = ctypes.c_int
        lib.lk_level_stage_margin.argtypes = []
        if lib.lk_level_max_window() != MAX_WINDOW:
            raise RuntimeError("lk_level.cu and lk_kernel.py disagree on "
                               "the largest window")
    return lib


def _corner(v: torch.Tensor, half_extent: int, add: int, align: int,
            hi: int) -> torch.Tensor:
    """Tile-aligned patch corner with the point inside
    (lk_pallas.py:482-489)."""
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
    interpolate first, then columns, as the TPU kernel's one-hot
    products."""
    iy = torch.floor(y)
    ix = torch.floor(x)
    fy = (y - iy)[:, None, None]
    fx = (x - ix)[:, None, None]
    idx = _window_idx(base, iy, ix, wh, width)
    a = (1.0 - fy) * flat[idx] + fy * flat[idx + width]
    b = (1.0 - fy) * flat[idx + 1] + fy * flat[idx + width + 1]
    return a * (1.0 - fx) + b * fx


def _sample4(flat: torch.Tensor, base: torch.Tensor, iy: torch.Tensor,
             ix: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor, wh: int,
             width: int) -> torch.Tensor:
    """Bilinear [N, wh, wh] windows whose top-left taps are the integer
    pixels (iy, ix) [N] of the patches at flat[base], blended with the
    serial kernel's four-term formula (lk_pallas.py:123-131)."""
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    idx = _window_idx(base, iy, ix, wh, width)
    return (flat[idx] * (1 - fy) * (1 - fx)
            + flat[idx + 1] * (1 - fy) * fx
            + flat[idx + width] * fy * (1 - fx)
            + flat[idx + width + 1] * fy * fx)


def _check(prev, next_img, cam_idx, points, guess, active, window, variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown LK level variant {variant!r}: "
                         f"expected one of {VARIANTS}")
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
    `warp(dy, dx, reads)` -> (window [N, w, w], dy_c, dx_c) samples the
    next image at the clamped estimate, where `reads` [N] marks the
    features whose window the kernel reads at that point (the ones not
    yet frozen, then every active one for the residual).  A feature
    freezes after the step whose |ux|+|uy| <= 0.03 (the serial kernel's
    while_loop exit).  Returns (dy, dx, ok_g, resid, dy_c, dx_c)."""
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
                       window: int = 16, iters: int = 10,
                       variant: str = "batched", reads=None):
    """Plain PyTorch version of the LK level kernels.

    Args:
      prev, next_img: [C, H, W] float32.
      cam_idx: [N] int camera of each feature.
      points:  [N, 2] (x, y) source positions.
      guess:   [N, 2] (x, y) initial target positions.
      active:  [N] bool.
      variant: "batched" or "serial" (see the module docstring).
      reads:   None, or a list that receives one ("prev" | "next", mask
               [N], flat origin [N], side) per image window the kernel
               reads: the (w+3)^2 region of prev under each active
               template, and the (w+1)^2 region of next under each
               Newton step and residual window, for the features whose
               mask is set (`lk_level_work` counts them).

    Returns (tracked [N, 2] f32, valid [N] bool, resid [N] f32).
    """
    ph, pw = _check(prev, next_img, cam_idx, points, guess, active, window,
                    variant)
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
    fp = prev.reshape(-1).float()
    fn = next_img.reshape(-1).float()

    def note(kind, mask, base, iy, ix, side):
        if reads is not None:
            reads.append((kind, mask,
                          base + iy.long() * wid + ix.long(), side))

    src_ok = (sy >= lo) & (sy <= hi_y) & (sx >= lo) & (sx <= hi_x)
    sy_c = torch.clamp(sy, lo, hi_y)
    sx_c = torch.clamp(sx, lo, hi_x)
    # inactive slots sample a safe in-patch origin; their outputs are
    # overwritten below
    one = torch.ones_like(sy_c)
    if variant == "batched":
        ty = torch.where(active, sy_c - 1.0, one)
        tx = torch.where(active, sx_c - 1.0, one)
        ext = _sample(fp, base_p, ty, tx, w + 2, wid)
        note("prev", active, base_p, torch.floor(ty), torch.floor(tx), w + 3)
        base_n = plane + y0n.long() * wid + x0n.long()
        lo_y, lo_x = lo, lo
        hi_yd, hi_xd = hi_y, hi_x
        off_y = off_x = torch.zeros_like(gy0)
    else:
        # the serial kernel's template: four-term taps at the integer
        # origin floor(s_c) - 1 with the fractions of s_c (lk_pallas.py:
        # 160-172)
        sy_c = torch.where(active, sy_c, one)
        sx_c = torch.where(active, sx_c, one)
        isy, isx = torch.floor(sy_c), torch.floor(sx_c)
        ext = _sample4(fp, base_p, isy - 1, isx - 1, sy_c - isy, sx_c - isx,
                       w + 2, wid)
        note("prev", active, base_p, isy - 1, isx - 1, w + 3)
        # working subpatch: its top-left pixel sits (subm_y, subm_x) up
        # and left of the clamped guess's floor; the estimate lives in
        # subpatch coordinates, clamped to the subpatch intersected with
        # the patch (lk_pallas.py:103-108, 189-202)
        subh, subw = min(SUBH, ph), min(SUBW, pw)
        off_y = torch.floor(torch.where(
            active, torch.clamp(gy0, lo, hi_y), one)) - (subh - w) // 2
        off_x = torch.floor(torch.where(
            active, torch.clamp(gx0, lo, hi_x), one)) - (subw - w) // 2
        base_n = (plane + (y0n.long() + off_y.long()) * wid
                  + x0n.long() + off_x.long())
        lo_y = torch.clamp(lo - off_y, min=lo)
        lo_x = torch.clamp(lo - off_x, min=lo)
        hi_yd = torch.clamp(hi_y - off_y, max=float(subh - w - 2))
        hi_xd = torch.clamp(hi_x - off_x, max=float(subw - w - 2))

    def warp(dy, dx, mask):
        dy_c = torch.clamp(dy, lo_y, hi_yd)
        dx_c = torch.clamp(dx, lo_x, hi_xd)
        if variant == "batched":
            oy = torch.where(active, dy_c, one)
            ox = torch.where(active, dx_c, one)
            win = _sample(fn, base_n, oy, ox, w, wid)
        else:
            oy = torch.where(active, dy_c, lo_y)
            ox = torch.where(active, dx_c, lo_x)
            iy, ix = torch.floor(oy), torch.floor(ox)
            win = _sample4(fn, base_n, iy, ix, oy - iy, ox - ix, w, wid)
        note("next", mask, base_n, torch.floor(oy), torch.floor(ox), w + 1)
        return win, dy_c, dx_c

    dy, dx, ok_g, resid, dy_c, dx_c = _newton(
        ext, w, warp, gy0 - off_y, gx0 - off_x, active, iters)
    in_range = (dy >= lo_y) & (dy <= hi_yd) & (dx >= lo_x) & (dx <= hi_xd)
    valid = ok_g & src_ok & in_range & active
    zero = torch.zeros_like(dx_c)
    tracked = torch.stack(
        [torch.where(active, dx_c + off_x + half, zero) + x0n.float(),
         torch.where(active, dy_c + off_y + half, zero) + y0n.float()], -1)
    return tracked, valid, torch.where(active, resid, zero)


# Bytes one slot moves through the kernel: cam (int32), points and guess
# (2 x float32 each), active (bool) in; tracked (2 x float32), valid
# (bool), resid (float32) out.
SLOT_BYTES = 4 + 8 + 8 + 1 + 8 + 1 + 4


def lk_level_work(prev, next_img, cam_idx, points, guess, active,
                  window: int = 16, iters: int = 10,
                  variant: str = "batched") -> dict:
    """The bytes and float32 operations one LK level call needs on these
    inputs, for its bound on a device (plain PyTorch, on the inputs'
    device).

    - bytes: SLOT_BYTES per slot, plus 4 per image pixel in the union of
      the windows the active features read: the (w+3)^2 region of prev
      under each template, and the (w+1)^2 region of next under each
      Newton step a feature takes and under its residual window.  Two
      features reading one pixel count it once.
    - flops: per active feature, the (w+2)^2 template taps and w^2 x 10
      for its gradients and structure tensor; per Newton step it takes
      before it freezes (counted by running the plain version), w^2 x
      (tap + 5); for its residual, w^2 x (tap + 2).  A tap is 9 operations
      (batched: rows then columns) or 11 (serial: four terms).  The few
      scalar operations per step (the 2x2 solve) are not counted.

    Returns {"bytes", "flops", "image_bytes", "steps"} as Python ints.
    """
    reads = []
    lk_level_reference(prev, next_img, cam_idx, points, guess, active,
                       window, iters, variant, reads)
    touched = {k: torch.zeros(prev.numel(), dtype=torch.bool,
                              device=prev.device) for k in ("prev", "next")}
    zero = torch.zeros((), dtype=torch.long, device=prev.device)
    for kind, mask, origin, side in reads:
        o = origin[mask]
        idx = _window_idx(o, zero.expand_as(o), zero.expand_as(o), side,
                          prev.shape[2])
        touched[kind][idx.reshape(-1)] = True
    image_bytes = 4 * int(touched["prev"].sum() + touched["next"].sum())
    # the Newton steps taken: every read of next but the residual's
    steps = sum(int(m.sum()) for k, m, _, _ in reads if k == "next") \
        - int(active.bool().sum())
    w2, n_act = window * window, int(active.bool().sum())
    tap = 9 if variant == "batched" else 11
    flops = (n_act * ((window + 2) ** 2 * tap + w2 * 10)
             + steps * w2 * (tap + 5) + n_act * w2 * (tap + 2))
    return {"bytes": SLOT_BYTES * points.shape[0] + image_bytes,
            "flops": flops, "image_bytes": image_bytes, "steps": steps}


def _launch(variant, prev, next_img, cam_idx, points, guess, active,
            tracked, valid, resid, window: int, iters: int, ph: int,
            pw: int) -> None:
    """Launch the variant's kernel on prepared tensors (contiguous, of the
    kernel's types, outputs allocated) on the current stream: no checks,
    no count.  lk_level's launch path, and a timing loop's."""
    _, h, wid = prev.shape
    lib = build()
    launch = (lib.lk_level_launch if variant == "batched"
              else lib.lk_level_serial_launch)
    with torch.cuda.device(prev.device):     # the launch's device
        err = launch(
            prev.data_ptr(), next_img.data_ptr(), cam_idx.data_ptr(),
            points.data_ptr(), guess.data_ptr(), active.data_ptr(),
            tracked.data_ptr(), valid.data_ptr(), resid.data_ptr(),
            h, wid, points.shape[0], window, iters, ph, pw,
            torch.cuda.current_stream(prev.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lk_level ({variant}) kernel launch failed: "
                           f"CUDA error {err}")


def lk_level(prev, next_img, cam_idx, points, guess, active,
             window: int = 16, iters: int = 10, variant: str = "batched"):
    """The LK level on the tensors' device: the variant's CUDA kernel for
    CUDA tensors, its plain version for CPU tensors.  Same arguments and
    results as `lk_level_reference`.  `lk_level.launches` counts launches
    of the batched kernel, `lk_level.serial_launches` of the serial one."""
    if prev.device.type == "cpu":
        return lk_level_reference(prev, next_img, cam_idx, points, guess,
                                  active, window, iters, variant)
    if prev.device.type != "cuda":
        raise ValueError(f"lk_level: no kernel for device {prev.device}")
    ph, pw = _check(prev, next_img, cam_idx, points, guess, active, window,
                    variant)
    n = points.shape[0]
    args = [prev, next_img, cam_idx, points, guess, active]
    if any(a.device != prev.device for a in args):
        raise ValueError("lk_level: all inputs must be on one device")
    # no-ops for inputs already of the kernel's types (the tracker's);
    # bool and uint8 are both one byte 0/1, so `active` goes in and
    # `valid` comes out as bool
    tracked = torch.empty((n, 2), dtype=torch.float32, device=prev.device)
    valid = torch.empty((n,), dtype=torch.bool, device=prev.device)
    resid = torch.empty((n,), dtype=torch.float32, device=prev.device)
    _launch(variant, prev.contiguous().float(),
            next_img.contiguous().float(),
            cam_idx.contiguous().to(torch.int32), points.contiguous().float(),
            guess.contiguous().float(), active.contiguous().bool(),
            tracked, valid, resid, window, iters, ph, pw)
    if variant == "batched":
        lk_level.launches += 1
    else:
        lk_level.serial_launches += 1
    return tracked, valid, resid


lk_level.launches = 0
lk_level.serial_launches = 0
