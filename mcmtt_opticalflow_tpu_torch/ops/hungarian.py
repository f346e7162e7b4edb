"""Linear assignment (detection <-> tracker matching), port of
mcmtt_opticalflow_tpu/ops/hungarian.py.

The JAX package runs Jonker-Volgenant shortest augmenting paths as a
device while_loop; eager PyTorch could only run that with one host sync
per Dijkstra step.  `solve_assignment_batch` is a numpy transcription of
the same algorithm (hungarian.py:90-169), run on the host in lockstep
over a leading batch axis: every Dijkstra step is one vectorised [C, T]
min/argmin/where.  The arithmetic is float32 in the same order as the
device version, and ties go to the first index as jnp.argmin does, so the
matching is identical (tracklet ids drift otherwise).  As in the JAX
package, `solve_assignment` takes one [R, T] matrix and
`solve_assignment_batch` a [C, R, T] stack (its vmap there);
`hungarian_host` is the exact scipy reference (carried over unchanged).

Forbidden (inf / masked) entries are replaced by (finite max + 100) in
span-normalised units before solving, and a match that lands on such an
entry is reported unmatched (ref PSNWhere_Tracker2D.cpp:1040-1063).
"""

from __future__ import annotations

import numpy as np

_INF = np.float32(1e18)


def hungarian_host(cost: np.ndarray):
    """Exact rectangular min-cost assignment on host.

    Returns (rows, cols) index arrays like scipy's linear_sum_assignment,
    with infinite-cost pairs filtered out.
    """
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost, dtype=np.float64)
    finite = np.isfinite(cost)
    if not finite.any():
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    big = cost[finite].max() + 100.0
    work = np.where(finite, cost, big)
    rows, cols = linear_sum_assignment(work)
    keep = finite[rows, cols]
    return rows[keep], cols[keep]


def solve_assignment(cost: np.ndarray, row_mask: np.ndarray,
                     col_mask: np.ndarray, num_iters: int = 2000):
    """Exact min-cost assignment of one matrix.

    Args:
      cost:     [R, T] float cost matrix (inf = forbidden).
      row_mask: [R] bool, valid rows.
      col_mask: [T] bool, valid columns.
      num_iters: unused (the JAX signature's; JV's loop counts are
        bounded by the matrix dimensions).

    Returns (col_of_row [R] int32, -1 when unmatched;
             match_cost [R] float32, inf when unmatched).
    """
    del num_iters
    col, mcost = solve_assignment_batch(np.asarray(cost)[None],
                                        np.asarray(row_mask)[None],
                                        np.asarray(col_mask)[None])
    return col[0], mcost[0]


def solve_assignment_batch(cost: np.ndarray, row_mask: np.ndarray,
                           col_mask: np.ndarray):
    """Exact min-cost assignment for a batch of matrices (cameras).

    Args:
      cost:     [C, R, T] float cost matrices (inf = forbidden).
      row_mask: [C, R] bool, valid rows.
      col_mask: [C, T] bool, valid columns.

    Returns (col_of_row [C, R] int32, -1 when unmatched;
             match_cost [C, R] float32, inf when unmatched).
    """
    cost = np.asarray(cost, np.float32)
    row_mask = np.asarray(row_mask, bool)
    col_mask = np.asarray(col_mask, bool)
    nc, r, c = cost.shape
    cams = np.arange(nc)
    if r > c:
        # JV augments one row at a time and needs rows <= cols: solve the
        # transposed problem and invert the matching
        row_of_col, _ = solve_assignment_batch(cost.transpose(0, 2, 1),
                                               col_mask, row_mask)
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
