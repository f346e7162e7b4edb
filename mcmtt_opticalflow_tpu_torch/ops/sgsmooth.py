"""Savitzky-Golay trajectory smoothing as batched matmuls (port of
mcmtt_opticalflow_tpu/ops/sgsmooth.py).

Smoothing a length-n sequence is a linear map: one [n, n] matrix per
valid length, built on the host in float64 from the same Q-projection
rows as the reference (ref PSNWhere_SGSmooth.cpp:109-260), then gathered
per track and applied in one batched product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _sg_projection(window: int, degree: int) -> np.ndarray:
    """Q Q^T for the orthonormalised Vandermonde basis on [-h, h]."""
    h = (window - 1) // 2
    t = np.arange(-h, h + 1, dtype=np.float64)
    v = np.stack([t ** k for k in range(degree + 1)], axis=1)  # [w, d+1]
    q, _ = np.linalg.qr(v)
    return q @ q.T


def smoothing_matrix_np(n: int, span: int, degree: int) -> np.ndarray:
    """[n, n] float64 smoothing matrix reproducing the reference's
    begin/mid/end row structure (ref PSNWhere_SGSmooth.cpp:198-260)."""
    w = min(span, n)
    w -= (w + 1) % 2           # force odd (ref :203)
    if w <= degree:            # bypass (ref :204-212)
        return np.eye(n)
    h = (w - 1) // 2
    b = _sg_projection(w, degree)
    s = np.zeros((n, n))
    for i in range(h):                      # begin rows
        s[i, :w] = b[i]
    for i in range(h, n - h):               # middle rows (uniform for deg<=1)
        s[i, i - h:i + h + 1] = b[h]
    for j in range(h):                      # end rows
        s[n - h + j, n - w:] = b[h + 1 + j]
    return s


@functools.lru_cache(maxsize=8)
def _sg_matrix_stack_np(capacity: int, span: int, degree: int) -> np.ndarray:
    out = np.zeros((capacity + 1, capacity, capacity), dtype=np.float32)
    for n in range(1, capacity + 1):
        out[n, :n, :n] = smoothing_matrix_np(n, span, degree)
    return out


@functools.lru_cache(maxsize=8)
def sg_smoothing_matrix(capacity: int, span: int, degree: int,
                        device: str) -> torch.Tensor:
    """[capacity+1, capacity, capacity] stack on `device`: entry L is the
    smoothing matrix for a length-L sequence, zero-padded."""
    return torch.from_numpy(
        _sg_matrix_stack_np(capacity, span, degree)).to(device)


def sg_smooth(data: torch.Tensor, span: int = 9,
              degree: int = 1) -> torch.Tensor:
    """Smooth [n] or [n, d] data directly with the length-n matrix."""
    n = data.shape[0]
    s = torch.as_tensor(smoothing_matrix_np(n, span, degree),
                        dtype=data.dtype, device=data.device)
    return s @ data


def sg_smooth_masked(data: torch.Tensor, lengths: torch.Tensor,
                     span: int = 9, degree: int = 1) -> torch.Tensor:
    """Batched smoothing of padded trajectories.

    Args:
      data:    [B, T, D] padded trajectories (valid prefix per row).
      lengths: [B] valid lengths.

    Returns [B, T, D]; positions >= length are passed through unchanged.
    """
    b, t, d = data.shape
    mats = sg_smoothing_matrix(t, span, degree, str(data.device))
    sel = mats[torch.clamp(lengths, 0, t).long()]             # [B, T, T]
    smoothed = torch.bmm(sel, data)
    idx = torch.arange(t, device=data.device)[None, :, None]
    return torch.where(idx < lengths[:, None, None], smoothed, data)
