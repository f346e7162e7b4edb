# Plain copy of mcmtt_opticalflow_tpu_torch/ops/hungarian.py (jv_assign_reference) at commit 052b569610a6.
"""Linear assignment (detection <-> tracker matching): Jonker-Volgenant
shortest augmenting paths, `jv_assign_reference`, a numpy transcription
run on the host in lockstep over the camera axis, in float32, with ties
to the first index; `solve_assignment_batch` takes a [C, R, T] stack.

Forbidden (inf / masked) entries are replaced by (finite max + 100) in
span-normalised units before solving, and a match that lands on such an
entry is reported unmatched (ref PSNWhere_Tracker2D.cpp:1040-1063).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


_INF = np.float32(1e18)


def solve_assignment_batch(cost, row_mask, col_mask):
    """Exact min-cost assignment for a batch of matrices (cameras).

    Args:
      cost:     [C, R, T] float cost matrices (inf = forbidden).
      row_mask: [C, R] bool, valid rows.
      col_mask: [C, T] bool, valid columns.

    Returns (col_of_row [C, R] int32, -1 when unmatched;
             match_cost [C, R] float32, inf when unmatched), on the
    input's device: the kernel on the card, the plain version on the CPU.
    """
    return jv_assign(*(torch.as_tensor(x) for x in
                       (cost, row_mask, col_mask)))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _jv_numpy(cost: np.ndarray, row_mask: np.ndarray, col_mask: np.ndarray,
              steps: Optional[np.ndarray] = None):
    """hungarian.py:75-169 in numpy, in lockstep over the leading camera
    axis.  `steps` [C] (optional) receives each camera's Dijkstra steps."""
    nc, r, c = cost.shape
    cams = np.arange(nc)
    if r > c:
        # JV augments one row at a time and needs rows <= cols: solve the
        # transposed problem and invert the matching
        row_of_col, _ = _jv_numpy(cost.transpose(0, 2, 1), col_mask,
                                  row_mask, steps)
        col_of_row = np.full((nc, r), -1, np.int32)
        ci, cj = np.nonzero(row_of_col >= 0)
        col_of_row[ci, row_of_col[ci, cj]] = cj
        matched = col_of_row >= 0
        mcost = cost[cams[:, None], np.arange(r)[None, :],
                     np.where(matched, col_of_row, 0)]
        return (col_of_row,
                np.where(matched, mcost, np.float32(np.inf)).astype(
                    np.float32))

    finite = (np.isfinite(cost) & row_mask[:, :, None]
              & col_mask[:, None, :])
    maxfin = np.max(np.where(finite, cost, -np.inf), axis=(1, 2))
    maxfin = np.where(np.isfinite(maxfin), maxfin, 0.0).astype(np.float32)
    minfin = np.min(np.where(finite, cost, np.inf), axis=(1, 2))
    minfin = np.where(np.isfinite(minfin), minfin, 0.0).astype(np.float32)
    span = np.maximum(maxfin - minfin, np.float32(1.0))
    big = (maxfin + np.float32(100.0) - minfin) / span
    w = np.where(finite, (cost - minfin[:, None, None]) / span[:, None, None],
                 big[:, None, None]).astype(np.float32)

    cols = np.arange(c)
    x = np.full((nc, c), -1, np.int64)       # row owning each column
    y = np.full((nc, r), -1, np.int64)       # column of each row
    v = np.zeros((nc, c), np.float32)        # column potentials
    for i in range(r):
        # masked rows change nothing in the device version (its sweep runs
        # but neither the potentials nor the matching are updated)
        cs = np.flatnonzero(row_mask[:, i])
        if len(cs) == 0:
            continue
        k = len(cs)
        ks = np.arange(k)
        wc, xc, vc = w[cs], x[cs], v[cs]
        dist = wc[:, i] - vc
        par = np.full((k, c), i, np.int64)
        visited = np.zeros((k, c), bool)
        sink = np.full(k, -1, np.int64)
        dsink = np.zeros(k, np.float32)
        while True:
            run = sink < 0
            if not run.any():
                break
            if steps is not None:
                steps[cs[run]] += 1
            dmask = np.where(visited, _INF, dist)
            j = np.argmin(dmask, axis=1)
            dj = dmask[ks, j]
            visited[ks[run], j[run]] = True
            owner = xc[ks, j]
            free = owner < 0
            i2 = np.maximum(owner, 0)
            nd = ((dj[:, None] + (wc[ks, i2] - vc))
                  - (wc[ks, i2, j] - vc[ks, j])[:, None])
            upd = (run & ~free)[:, None] & ~visited & (nd < dist)
            dist = np.where(upd, nd, dist)
            par = np.where(upd, i2[:, None], par)
            found = run & free
            sink = np.where(found, j, sink)
            dsink = np.where(found, dj, dsink)
        # potential update for scanned columns (keeps reduced costs >= 0)
        keep = visited & (cols[None, :] != sink[:, None])
        v[cs] = np.where(keep, (vc + dist) - dsink[:, None], vc)
        # augment: walk the parent chain back from the free column
        for q, cam in enumerate(cs):
            j = sink[q]
            while True:
                i2 = par[q, j]
                pj = y[cam, i2]
                y[cam, i2] = j
                x[cam, j] = i2
                j = pj
                if i2 == i:
                    break

    matched = y >= 0
    safe = np.where(matched, y, 0)
    rows = np.arange(r)[None, :]
    mcost = cost[cams[:, None], rows, safe]
    valid = matched & np.isfinite(mcost) & finite[cams[:, None], rows, safe]
    return (np.where(valid, y, -1).astype(np.int32),
            np.where(valid, mcost, np.float32(np.inf)).astype(np.float32))


def _host(x: torch.Tensor, dtype) -> np.ndarray:
    return x.detach().cpu().numpy().astype(dtype, copy=False)


def jv_assign_reference(cost: torch.Tensor, row_mask: torch.Tensor,
                        col_mask: torch.Tensor):
    """Plain version of the JV kernel (`_jv_numpy` on the host): the same
    arguments and results as `jv_assign`, on the cost's device (the copy
    returns them there; the original returns CPU tensors)."""
    col, mcost = _jv_numpy(_host(cost, np.float32),
                           _host(row_mask, np.bool_),
                           _host(col_mask, np.bool_))
    return (torch.from_numpy(col).to(cost.device),
            torch.from_numpy(mcost).to(cost.device))


jv_assign = jv_assign_reference
