"""Grid-distributed corner features inside detection boxes (port of
mcmtt_opticalflow_tpu/ops/features.py).

One Shi-Tomasi (min-eigenvalue) response map per camera frame, then for
every box a fixed lattice of candidate positions whose responses are
gathered and reduced per grid cell: a static-shape
[C, num_boxes, max_features] feature set with a validity mask
(ref psn_where/PSNWhere_Tracker2D.cpp:142, 735-757).
"""

from __future__ import annotations

import torch

from mcmtt_opticalflow_tpu_torch.ops.pyramid import _K3, _sep_conv


def shi_tomasi_response(img: torch.Tensor) -> torch.Tensor:
    """Min-eigenvalue corner response. img: [..., H, W] -> [..., H, W]
    (circular roll at the borders, as the JAX version)."""
    ix = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    iy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    sxx = _sep_conv(ix * ix, _K3)
    syy = _sep_conv(iy * iy, _K3)
    sxy = _sep_conv(ix * iy, _K3)
    tr = sxx + syy
    dt = torch.sqrt(torch.clamp((sxx - syy) * (sxx - syy)
                                + 4.0 * (sxy * sxy), min=0.0))
    return 0.5 * (tr - dt)


def detect_grid_features(img: torch.Tensor,
                         boxes: torch.Tensor,
                         box_mask: torch.Tensor,
                         grid: int = 8,
                         sub: int = 2,
                         quality: float = 0.01):
    """Pick grid-spread corners inside each box, for every camera.

    Args:
      img:      [C, H, W] gray float frames.
      boxes:    [C, B, 4] (x, y, w, h) detection boxes.
      box_mask: [C, B] bool valid boxes.
      grid:     cells per side -> grid*grid features per box.
      sub:      candidate positions per cell side.
      quality:  min response relative to the box's best corner.

    Returns points [C, B, grid*grid, 2] and valid [C, B, grid*grid].
    """
    c, h, w = img.shape
    b = boxes.shape[1]
    resp = shi_tomasi_response(img)
    n = grid * sub
    lin = (torch.arange(n, dtype=img.dtype, device=img.device) + 0.5) / n
    gx, gy = torch.meshgrid(lin, lin, indexing="xy")
    lattice = torch.stack([gx, gy], -1).reshape(-1, 2)          # [n*n, 2]
    xy = boxes[:, :, None, 0:2] + lattice * boxes[:, :, None, 2:4]

    xi = torch.clamp(xy[..., 0].to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(xy[..., 1].to(torch.int32), 0, h - 1).long()
    # flat per-camera gather
    r = torch.gather(resp.reshape(c, -1), 1,
                     (yi * w + xi).reshape(c, -1)).reshape(yi.shape)
    inb = ((xy[..., 0] >= 1) & (xy[..., 0] < w - 1)
           & (xy[..., 1] >= 1) & (xy[..., 1] < h - 1))
    r = torch.where(inb, r, -torch.inf)

    # reduce each grid cell (sub*sub candidates) to its best candidate;
    # argmax ties go to the first index, as jnp.argmax
    r_cells = (r.reshape(c, b, grid, sub, grid, sub)
               .permute(0, 1, 2, 4, 3, 5).reshape(c, b, grid * grid, sub * sub))
    xy_cells = (xy.reshape(c, b, grid, sub, grid, sub, 2)
                .permute(0, 1, 2, 4, 3, 5, 6)
                .reshape(c, b, grid * grid, sub * sub, 2))
    best = torch.argmax(r_cells, dim=-1)
    best_r = torch.gather(r_cells, -1, best[..., None])[..., 0]
    points = torch.gather(
        xy_cells, -2, best[..., None, None].expand(-1, -1, -1, 1, 2))[..., 0, :]

    box_best = torch.max(best_r, dim=-1, keepdim=True).values
    valid = ((best_r > quality * torch.clamp(box_best, min=1e-12))
             & torch.isfinite(best_r) & box_mask[..., None])
    return points, valid
