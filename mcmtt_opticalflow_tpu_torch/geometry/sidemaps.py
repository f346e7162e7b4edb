"""Per-camera calibration side-maps (port of
mcmtt_opticalflow_tpu/geometry/sidemaps.py).

Projection sensitivity (mm of ground motion per image pixel) and distance
from the field-of-view boundary, computed from the Tsai model on the host
at a fixed stride, or loaded from the reference's precomputed text
matrices; consumed by the associator's cost model and its enter/exit
probabilities (ref Associator3D.cpp:843, 2267-2303).  The file functions
are carried copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmtt_opticalflow_tpu_torch.geometry.tsai import TsaiCamera
from mcmtt_opticalflow_tpu_torch.geometry.tsai_np import HostCamera


def _pixel_grid(width: int, height: int, stride: int):
    us = np.arange(0, width, stride, dtype=np.float64)
    vs = np.arange(0, height, stride, dtype=np.float64)
    uu, vv = np.meshgrid(us, vs)              # [H', W']
    return np.stack([uu, vv], -1)             # [H', W', 2]


def projection_sensitivity_map(cam: TsaiCamera, width: int, height: int,
                               stride: int = 4) -> np.ndarray:
    """[H/stride, W/stride] float32 map of mm-per-pixel at ground height."""
    hc = HostCamera(cam)
    uv = _pixel_grid(width, height, stride)
    g0 = hc.image_to_world(uv, 0.0)[..., :2]
    gu = hc.image_to_world(uv + np.asarray([1.0, 0.0]), 0.0)[..., :2]
    gv = hc.image_to_world(uv + np.asarray([0.0, 1.0]), 0.0)[..., :2]
    du = np.linalg.norm(gu - g0, axis=-1)
    dv = np.linalg.norm(gv - g0, axis=-1)
    sens = np.maximum(du, dv)
    return np.nan_to_num(sens, nan=1e6, posinf=1e6).astype(np.float32)


def distance_from_boundary_map(cam: TsaiCamera, width: int, height: int,
                               stride: int = 4) -> np.ndarray:
    """[H/stride, W/stride] float32 map: ground-plane mm from each pixel's
    ground point to the FOV boundary (pixel distance to the image border
    scaled by local sensitivity)."""
    uv = _pixel_grid(width, height, stride)
    u, v = uv[..., 0], uv[..., 1]
    pix_dist = np.minimum(np.minimum(u, width - 1 - u),
                          np.minimum(v, height - 1 - v))
    sens = projection_sensitivity_map(cam, width, height, stride)
    return (pix_dist * sens).astype(np.float32)


def read_sidemap_txt(path: str) -> np.ndarray:
    """Load a reference-format side-map text matrix: a `row:R,col:C` header
    followed by comma-separated floats, one row per line (the format both
    ReadProjectionSensitivity and ReadDistanceFromBoundary consume,
    ref psn_where/PSNWhere.cpp:489-573 / PSNWhere_Associator3D.cpp:622-706).
    Loaded maps are full-resolution (stride 1)."""
    with open(path) as f:
        header = f.readline().strip()
        parts = header.replace("row:", "").replace("col:", "").split(",")
        rows, cols = int(parts[0]), int(parts[1])
        body = f.read().replace(",", " ").split()
        vals = np.asarray(body, dtype=np.float64)
    vals = vals[:rows * cols]
    if vals.size != rows * cols:
        raise ValueError(
            f"{path}: expected {rows}x{cols}={rows * cols} values, "
            f"got {vals.size}")
    return vals.reshape(rows, cols).astype(np.float32)


def write_sidemap_txt(path: str, map2d: np.ndarray) -> None:
    """Write a matrix in the reference's side-map text format (exact
    inverse of read_sidemap_txt; used for fixtures and map export)."""
    m = np.asarray(map2d, np.float32)
    with open(path, "w") as f:
        f.write(f"row:{m.shape[0]},col:{m.shape[1]}\n")
        for r in m:
            f.write(",".join(f"{x:f}" for x in r) + ",\n")


def load_or_compute_sidemaps(cam: TsaiCamera, width: int, height: int,
                             stride: int, dataset_path=None, cam_id=None):
    """Per-camera (sensitivity_map, boundary_map, stride): load the
    reference's precomputed matrices from
    <dataset_path>/calibrationInfos/{ProjectionSensitivity,
    DistanceFromBoundary}_View%03d.txt when both exist (drop-in parity on
    reference datasets, ref PSNWhere.cpp:103-122), else compute from the
    Tsai model.  Loaded maps are full resolution, so stride 1."""
    import os

    if dataset_path is not None and cam_id is not None:
        base = os.path.join(dataset_path, "calibrationInfos")
        sp = os.path.join(base, f"ProjectionSensitivity_View{cam_id:03d}.txt")
        bp = os.path.join(base, f"DistanceFromBoundary_View{cam_id:03d}.txt")
        if os.path.isfile(sp) and os.path.isfile(bp):
            return read_sidemap_txt(sp), read_sidemap_txt(bp), 1
    return (projection_sensitivity_map(cam, width, height, stride),
            distance_from_boundary_map(cam, width, height, stride),
            stride)


def sample_map(map2d: torch.Tensor, uv: torch.Tensor, width: int,
               height: int, stride: int = 4) -> torch.Tensor:
    """Nearest-neighbour sample of a strided side-map at pixel coords
    uv [..., 2]; coordinates are clamped to the frame."""
    h, w = map2d.shape
    iu = torch.clamp((uv[..., 0] / stride).to(torch.int32), 0, w - 1)
    iv = torch.clamp((uv[..., 1] / stride).to(torch.int32), 0, h - 1)
    return map2d[iv.long(), iu.long()]
