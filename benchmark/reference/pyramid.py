# Frozen copy of mcmtt_opticalflow_tpu_torch/ops/pyramid.py at commit 052b569610a6, for the benchmark's
# plain reference; imports point at the copies beside it.
"""Gaussian image pyramids (port of mcmtt_opticalflow_tpu/ops/pyramid.py).

Feeds the pyramidal Lucas-Kanade tracker; replaces OpenCV's internal
pyramid construction inside cv::calcOpticalFlowPyrLK
(ref psn_where/PSNWhere_Tracker2D.cpp:776, 871).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

# 5-tap binomial kernel (OpenCV pyrDown's separable Gaussian) and 3-tap
_K5 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_K3 = np.asarray([1.0, 2.0, 1.0], np.float32) / 4.0


def _edge_pad(img: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Replicate `pad` edge rows (dim=-2) or columns (dim=-1)."""
    n = img.shape[dim]
    idx = torch.clamp(torch.arange(-pad, n + pad, device=img.device), 0, n - 1)
    return img.index_select(dim, idx)


def _sep_conv(img: torch.Tensor, k) -> torch.Tensor:
    """Separable 2D convolution with edge padding. img: [..., H, W].

    Shifted adds in the same order as the JAX version (rows, then
    columns), so the sums round the same way."""
    kk = [float(v) for v in np.asarray(k)]
    pad = (len(kk) - 1) // 2
    h, w = img.shape[-2:]
    x = _edge_pad(img, pad, -2)
    y = sum(kk[i] * x[..., i:i + h, :] for i in range(len(kk)))
    y = _edge_pad(y, pad, -1)
    return sum(kk[i] * y[..., :, i:i + w] for i in range(len(kk)))


def gaussian_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    """3-tap binomial blur with edge padding. img: [..., H, W]."""
    return _sep_conv(img, _K3)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Blur + 2x decimation. img: [..., H, W] with even H, W."""
    return _sep_conv(img, _K5)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """List of `levels` images, finest first. img: [..., H, W] float32.
    H and W must be divisible by 2**(levels-1)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def image_gradients(img: torch.Tensor):
    """Central-difference gradients with a circular wrap at the borders
    (as the JAX version's jnp.roll).  img: [..., H, W] -> (ix, iy)."""
    ix = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    iy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    return ix, iy


def edge_pad_to(img: torch.Tensor, h_mult: int, w_mult: int) -> torch.Tensor:
    """Edge-pad [..., H, W] at the bottom/right up to multiples of
    (h_mult, w_mult) — jnp.pad(mode="edge")."""
    h, w = img.shape[-2:]
    ph, pw = (-h) % h_mult, (-w) % w_mult
    if not (ph or pw):
        return img
    lead = img.shape[:-2]
    x = img.reshape((-1, 1, h, w))
    x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x.reshape(lead + (h + ph, w + pw))
