"""Tsai calibrated camera model as batched torch functions.

Port of mcmtt_opticalflow_tpu/geometry/tsai.py: the same math over a
NamedTuple of tensor fields.  A single camera has 0-d fields; a stacked
camera has [C] fields, and `TsaiCamera.expand` views them as [C, 1, ...]
so one call projects every camera's points at once (the JAX package vmaps
over cameras instead).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class TsaiCamera(NamedTuple):
    """Tsai calibration parameters (+ precomputed rotation).  Mirrors the
    JAX package's TsaiCamera field for field (ref cameraModel.h:140-178)."""

    width: torch.Tensor
    height: torch.Tensor
    dpx: torch.Tensor
    dpy: torch.Tensor
    focal: torch.Tensor
    kappa1: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    sx: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    tz: torch.Tensor
    r11: torch.Tensor
    r12: torch.Tensor
    r13: torch.Tensor
    r21: torch.Tensor
    r22: torch.Tensor
    r23: torch.Tensor
    r31: torch.Tensor
    r32: torch.Tensor
    r33: torch.Tensor

    @staticmethod
    def create(width, height, dpx, dpy, focal, kappa1, cx, cy, sx,
               tx, ty, tz, rx, ry, rz, dtype=torch.float32,
               device="cpu") -> "TsaiCamera":
        """Build a camera, precomputing the Euler rotation matrix
        (ZYX convention of ref cameraModel.cpp:38-53) in float64 numpy."""
        sa, ca = np.sin(rx), np.cos(rx)
        sb, cb = np.sin(ry), np.cos(ry)
        sg, cg = np.sin(rz), np.cos(rz)
        vals = dict(
            width=width, height=height, dpx=dpx, dpy=dpy,
            focal=focal, kappa1=kappa1, cx=cx, cy=cy, sx=sx,
            tx=tx, ty=ty, tz=tz,
            r11=cb * cg,
            r12=cg * sa * sb - ca * sg,
            r13=sa * sg + ca * cg * sb,
            r21=cb * sg,
            r22=sa * sb * sg + ca * cg,
            r23=ca * sb * sg - cg * sa,
            r31=-sb,
            r32=cb * sa,
            r33=ca * cb,
        )
        return TsaiCamera(**{k: torch.tensor(float(v), dtype=dtype,
                                             device=device)
                             for k, v in vals.items()})

    def expand(self, ndim: int) -> "TsaiCamera":
        """View stacked [C] fields as [C, 1 x ndim] so they broadcast
        against per-camera [C, ...] point batches."""
        return TsaiCamera(*[f.reshape(f.shape + (1,) * ndim) for f in self])


def stack_cameras(cams: Sequence[TsaiCamera], device=None) -> TsaiCamera:
    """Stack single cameras into one TsaiCamera with [C] fields."""
    return TsaiCamera(*[torch.stack([getattr(c, f) for c in cams]).to(device)
                        for f in TsaiCamera._fields])


def camera_position(cam: TsaiCamera) -> torch.Tensor:
    """World-space camera centre, -R^T t (ref cameraModel.cpp:56-58)."""
    px = -(cam.tx * cam.r11 + cam.ty * cam.r21 + cam.tz * cam.r31)
    py = -(cam.tx * cam.r12 + cam.ty * cam.r22 + cam.tz * cam.r32)
    pz = -(cam.tx * cam.r13 + cam.ty * cam.r23 + cam.tz * cam.r33)
    return torch.stack([px, py, pz], dim=-1)


def _distorted_to_undistorted_sensor(cam: TsaiCamera, xd, yd):
    """(ref cameraModel.cpp:535-543)"""
    factor = 1.0 + cam.kappa1 * (xd * xd + yd * yd)
    return xd * factor, yd * factor


def _undistorted_to_distorted_sensor(cam: TsaiCamera, xu, yu):
    """Cardano cubic inverse of the radial distortion, the branch
    structure of ref cameraModel.cpp:579-663 written with torch.where."""
    ru_sq = xu * xu + yu * yu
    ru = torch.sqrt(ru_sq)
    safe_kappa = torch.where(cam.kappa1 == 0.0, 1.0, cam.kappa1)
    c = 1.0 / safe_kappa
    d = -c * ru
    q = c / 3.0
    r = -d / 2.0
    disc = q * q * q + r * r

    sq_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    s_val = _cbrt(r + sq_disc)
    t_val = _cbrt(r - sq_disc)
    rd_one = s_val + t_val
    rd_max = torch.sqrt(torch.clamp(-1.0 / (3.0 * safe_kappa), min=0.0))
    rd_one = torch.where(rd_one < 0.0, rd_max, rd_one)

    sq_ndisc = torch.sqrt(torch.clamp(-disc, min=0.0))
    s3 = _cbrt(torch.sqrt(r * r + torch.clamp(-disc, min=0.0)))
    theta = torch.atan2(sq_ndisc, r) / 3.0
    rd_three = (-s3 * torch.cos(theta)
                + float(np.sqrt(np.float32(3.0))) * s3 * torch.sin(theta))

    rd = torch.where(disc >= 0.0, rd_one, rd_three)
    lam = rd / torch.where(ru == 0.0, 1.0, ru)
    identity = (ru == 0.0) | (cam.kappa1 == 0.0)
    xd = torch.where(identity, xu, xu * lam)
    yd = torch.where(identity, yu, yu * lam)
    return xd, yd


def _cbrt(x):
    """Real cube root as float32 pow(|x|, 1/3) with the sign restored
    (torch has no cbrt; this agrees with XLA's cbrt to an ulp)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def world_to_image(cam: TsaiCamera, point3d: torch.Tensor) -> torch.Tensor:
    """Project world [..., 3] -> image [..., 2] (ref cameraModel.cpp:545-577)."""
    xw, yw, zw = point3d[..., 0], point3d[..., 1], point3d[..., 2]
    xc = cam.r11 * xw + cam.r12 * yw + cam.r13 * zw + cam.tx
    yc = cam.r21 * xw + cam.r22 * yw + cam.r23 * zw + cam.ty
    zc = cam.r31 * xw + cam.r32 * yw + cam.r33 * zw + cam.tz
    xu = cam.focal * xc / zc
    yu = cam.focal * yc / zc
    xd, yd = _undistorted_to_distorted_sensor(cam, xu, yu)
    xi = xd * cam.sx / cam.dpx + cam.cx
    yi = yd / cam.dpy + cam.cy
    return torch.stack([xi, yi], dim=-1)


def image_to_world(cam: TsaiCamera, point2d: torch.Tensor, zw) -> torch.Tensor:
    """Back-project image [..., 2] at world height zw -> world [..., 3]
    (closed-form inverse projection, ref cameraModel.cpp:494-533)."""
    xi, yi = point2d[..., 0], point2d[..., 1]
    # a Python zw stays a scalar operand: no host-to-device copy, so a
    # CUDA graph can capture the call
    if isinstance(zw, torch.Tensor):
        zw = zw.to(dtype=xi.dtype, device=xi.device)
    xd = cam.dpx * (xi - cam.cx) / cam.sx
    yd = cam.dpy * (yi - cam.cy)
    xu, yu = _distorted_to_undistorted_sensor(cam, xd, yd)

    den = ((cam.r11 * cam.r32 - cam.r12 * cam.r31) * yu
           + (cam.r22 * cam.r31 - cam.r21 * cam.r32) * xu
           - cam.focal * cam.r11 * cam.r22 + cam.focal * cam.r12 * cam.r21)
    xw = (((cam.r12 * cam.r33 - cam.r13 * cam.r32) * yu
           + (cam.r23 * cam.r32 - cam.r22 * cam.r33) * xu
           - cam.focal * cam.r12 * cam.r23 + cam.focal * cam.r13 * cam.r22) * zw
          + (cam.r12 * cam.tz - cam.r32 * cam.tx) * yu
          + (cam.r32 * cam.ty - cam.r22 * cam.tz) * xu
          - cam.focal * cam.r12 * cam.ty + cam.focal * cam.r22 * cam.tx) / den
    yw = -(((cam.r11 * cam.r33 - cam.r13 * cam.r31) * yu
            + (cam.r23 * cam.r31 - cam.r21 * cam.r33) * xu
            - cam.focal * cam.r11 * cam.r23 + cam.focal * cam.r13 * cam.r21) * zw
           + (cam.r11 * cam.tz - cam.r31 * cam.tx) * yu
           + (cam.r31 * cam.ty - cam.r21 * cam.tz) * xu
           - cam.focal * cam.r11 * cam.ty + cam.focal * cam.r21 * cam.tx) / den
    zs = (torch.broadcast_to(zw, xw.shape) if isinstance(zw, torch.Tensor)
          else torch.full_like(xw, zw))
    return torch.stack([xw, yw, zs], dim=-1)


def back_projection_line(cam: TsaiCamera, point2d: torch.Tensor,
                         z_top: float = 2000.0):
    """Back-projection line through a pixel as two world points at heights
    z_top and 0 (ref PSNWhere_Associator3D.cpp:1058-1064)."""
    top = image_to_world(cam, point2d, z_top)
    bottom = image_to_world(cam, point2d, 0.0)
    return top, bottom


def check_visibility(cam: TsaiCamera, point3d: torch.Tensor) -> torch.Tensor:
    """Whether a world point projects inside the camera frame
    (ref CheckVisibility usage, PSNWhere_Associator3D.cpp:901-912)."""
    uv = world_to_image(cam, point3d)
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
            & torch.isfinite(u) & torch.isfinite(v))
