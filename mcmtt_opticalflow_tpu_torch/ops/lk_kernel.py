"""One pyramid level of iterative LK for a flat feature batch: the
hand-written CUDA kernel (csrc/lk_level.cu) and its plain PyTorch version.

Both compute what the TPU kernel
mcmtt_opticalflow_tpu/ops/lk_pallas.py::_make_kernel_batched computes
together with the wrapping in lk_level_pallas: per feature a bilinear
(w+2)^2 template with central-difference gradients, a det > 1e-7 gated
2x2 structure tensor, `iters` Newton steps with the estimate clamped to a
[PH, PW] patch whose corner is tile-aligned (the TPU's DMA patch; the
corner decides where the estimate is clamped, so it stays), a freeze
once |ux|+|uy| <= 0.03, and the mean absolute residual.  Inactive slots
return the patch corner with valid False and residual 0.

`lk_level` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  The kernel builds with nvcc at
first use into ``_build/`` beside the package (see .gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

PH = 40                  # patch rows of the TPU kernel (lk_pallas.PH)
PW = 256                 # patch columns
MAX_WINDOW = 16          # per-lane register arrays in the CUDA kernel

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "lk_level.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]


class _Kernel:
    """The built library (one per process, loaded at first use)."""
    lib = None
    build_seconds = None
    build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the LK kernel cannot be built")


def build() -> ctypes.CDLL:
    """Compile csrc/lk_level.cu into a shared library (named by the source
    hash, so an edited source rebuilds) and load it."""
    if _Kernel.lib is not None:
        return _Kernel.lib
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so_path = os.path.join(_BUILD_DIR, f"lk_level_{digest[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        _Kernel.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("nvcc failed on lk_level.cu:\n"
                               + _Kernel.build_log)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.lk_level_launch.restype = ctypes.c_int
    lib.lk_level_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.lk_level_max_window.restype = ctypes.c_int
    lib.lk_level_max_window.argtypes = []
    if lib.lk_level_max_window() != MAX_WINDOW:
        raise RuntimeError("lk_level.cu and lk_kernel.py disagree on the "
                           "largest window")
    _Kernel.build_seconds = time.perf_counter() - t0
    _Kernel.lib = lib
    return lib


def _corner(v: torch.Tensor, half_extent: int, add: int, align: int,
            hi: int) -> torch.Tensor:
    """Tile-aligned patch corner with the point inside
    (lk_pallas.py:482-489)."""
    c = (torch.floor(v).to(torch.int32) - half_extent + add) & ~(align - 1)
    return torch.clamp(c, 0, hi)


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
    r = torch.arange(wh, device=flat.device)
    idx = (base[:, None, None]
           + (iy.long()[:, None, None] + r[None, :, None]) * width
           + ix.long()[:, None, None] + r[None, None, :])
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


def lk_level_reference(prev, next_img, cam_idx, points, guess, active,
                       window: int = 16, iters: int = 10):
    """Plain PyTorch version of the LK level kernel.

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
    y0p = _corner(points[:, 1], ph // 2, 4, 8, max(h - ph, 0))
    x0p = _corner(points[:, 0], pw // 2, 64, 128, max(wid - pw, 0))
    y0n = _corner(guess[:, 1], ph // 2, 4, 8, max(h - ph, 0))
    x0n = _corner(guess[:, 0], pw // 2, 64, 128, max(wid - pw, 0))
    sy = (points[:, 1] - y0p.float()) - half
    sx = (points[:, 0] - x0p.float()) - half
    dy = (guess[:, 1] - y0n.float()) - half
    dx = (guess[:, 0] - x0n.float()) - half

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
    ext = _sample(fp, base_p, torch.where(active, sy_c - 1.0, one),
                  torch.where(active, sx_c - 1.0, one), w + 2, wid)
    t = ext[:, 1:w + 1, 1:w + 1]
    gx = 0.5 * (ext[:, 1:w + 1, 2:w + 2] - ext[:, 1:w + 1, 0:w])
    gy = 0.5 * (ext[:, 2:w + 2, 1:w + 1] - ext[:, 0:w, 1:w + 1])
    gxx = (gx * gx).sum((1, 2))
    gxy = (gx * gy).sum((1, 2))
    gyy = (gy * gy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    ok_g = det > 1e-7
    inv_det = torch.where(ok_g, 1.0 / torch.where(ok_g, det, 1.0), 0.0)

    def warp(dy, dx):
        dy_c = torch.clamp(dy, lo, hi_y)
        dx_c = torch.clamp(dx, lo, hi_x)
        return (_sample(fn, base_n, torch.where(active, dy_c, one),
                        torch.where(active, dx_c, one), w, wid), dy_c, dx_c)

    go = active
    for _ in range(iters):
        warped, dy_c, dx_c = warp(dy, dx)
        diff = warped - t
        bx = (diff * gx).sum((1, 2))
        by = (diff * gy).sum((1, 2))
        ux = -(gyy * bx - gxy * by) * inv_det
        uy = -(-gxy * bx + gxx * by) * inv_det
        dy = torch.where(go, dy_c + uy, dy)
        dx = torch.where(go, dx_c + ux, dx)
        go = go & ((torch.abs(ux) + torch.abs(uy)) > 0.03)
    warped, dy_c, dx_c = warp(dy, dx)
    resid = torch.abs(warped - t).sum((1, 2)) * (1.0 / (w * w))

    in_range = (dy >= lo) & (dy <= hi_y) & (dx >= lo) & (dx <= hi_x)
    valid = ok_g & src_ok & in_range & active
    zero = torch.zeros_like(dx_c)
    tracked = torch.stack(
        [torch.where(active, dx_c + half, zero) + x0n.float(),
         torch.where(active, dy_c + half, zero) + y0n.float()], -1)
    return tracked, valid, torch.where(active, resid, zero)


def lk_level(prev, next_img, cam_idx, points, guess, active,
             window: int = 16, iters: int = 10):
    """The LK level on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Same arguments and
    results as `lk_level_reference`."""
    if prev.device.type == "cpu":
        return lk_level_reference(prev, next_img, cam_idx, points, guess,
                                  active, window, iters)
    if prev.device.type != "cuda":
        raise ValueError(f"lk_level: no kernel for device {prev.device}")
    ph, pw = _check(prev, next_img, cam_idx, points, guess, active, window)
    c, h, wid = prev.shape
    n = points.shape[0]
    args = [prev, next_img, cam_idx, points, guess, active]
    if any(a.device != prev.device for a in args):
        raise ValueError("lk_level: all inputs must be on one device")
    prev = prev.contiguous().float()
    next_img = next_img.contiguous().float()
    cam_idx = cam_idx.contiguous().to(torch.int32)
    points = points.contiguous().float()
    guess = guess.contiguous().float()
    active = active.contiguous().to(torch.uint8)
    tracked = torch.empty((n, 2), dtype=torch.float32, device=prev.device)
    valid = torch.empty((n,), dtype=torch.uint8, device=prev.device)
    resid = torch.empty((n,), dtype=torch.float32, device=prev.device)
    lib = build()
    err = lib.lk_level_launch(
        prev.data_ptr(), next_img.data_ptr(), cam_idx.data_ptr(),
        points.data_ptr(), guess.data_ptr(), active.data_ptr(),
        tracked.data_ptr(), valid.data_ptr(), resid.data_ptr(),
        h, wid, n, window, iters, ph, pw,
        torch.cuda.current_stream(prev.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lk_level kernel launch failed: CUDA error {err}")
    lk_level.launches += 1
    return tracked, valid.bool(), resid


lk_level.launches = 0
