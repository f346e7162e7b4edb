"""Per-camera calibration side-maps (port of
mcmtt_opticalflow_tpu/geometry/sidemaps.py).

Projection sensitivity (mm of ground motion per image pixel) and distance
from the field-of-view boundary, computed from the Tsai model on the host
at a fixed stride; consumed by the associator's cost model and its
enter/exit probabilities (ref Associator3D.cpp:843, 2267-2303).
"""

from __future__ import annotations

import numpy as np

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
