"""Carry cameras and 2D tracker state between the JAX package and the
port.  The JAX side is given and returned as numpy arrays (one per field,
e.g. ``{f: np.asarray(getattr(cam, f)) for f in cam._fields}``), so this
module needs no jax."""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from mcmtt_opticalflow_tpu_torch.geometry.tsai import TsaiCamera
from mcmtt_opticalflow_tpu_torch.models.tracker2d import Tracker2DState


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def camera_from_numpy(fields: Mapping[str, np.ndarray],
                      device="cpu") -> TsaiCamera:
    """One camera (0-d fields) or a stacked camera ([C] fields)."""
    return TsaiCamera(**{f: _t(fields[f], device) for f in TsaiCamera._fields})


def cameras_from_numpy(cams: Sequence[Mapping[str, np.ndarray]],
                       device="cpu") -> List[TsaiCamera]:
    return [camera_from_numpy(c, device) for c in cams]


def camera_to_numpy(cam: TsaiCamera) -> Dict[str, np.ndarray]:
    return {f: getattr(cam, f).cpu().numpy() for f in TsaiCamera._fields}


def tracker2d_state_from_numpy(fields: Mapping[str, object],
                               device="cpu") -> Tracker2DState:
    """`fields` maps every Tracker2DState field to a [C, ...] array;
    ``frames_lo`` to a sequence of them (one per coarse level)."""
    out = {}
    for f in Tracker2DState._fields:
        if f == "frames_lo":
            out[f] = tuple(_t(a, device) for a in fields[f])
        else:
            out[f] = _t(fields[f], device)
    return Tracker2DState(**out)


def tracker2d_state_to_numpy(state: Tracker2DState) -> Dict[str, object]:
    out = {}
    for f in Tracker2DState._fields:
        v = getattr(state, f)
        out[f] = (tuple(a.cpu().numpy() for a in v) if f == "frames_lo"
                  else v.cpu().numpy())
    return out
