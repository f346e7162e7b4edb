"""Linear assignment (detection <-> tracker matching), port of
mcmtt_opticalflow_tpu/ops/hungarian.py.

The JAX package runs Jonker-Volgenant shortest augmenting paths as device
while_loops inside the 2D tracker's jitted step.  Here the same algorithm
is a hand-written CUDA kernel (csrc/jv_assign.cu: one warp per camera
runs the rows, with the column state in registers up to 256 working
columns and in memory past that; any shape) wrapped by `jv_assign`, with
its plain version beside it:
`jv_assign_reference`, a numpy transcription of hungarian.py:90-169 run
on the host in lockstep over the camera axis (every Dijkstra step one
vectorised [C, T] min/argmin/where).  Both compute in float32 in the
device version's order, and ties go to the first index as jnp.argmin
breaks them, so the matching is identical (tracklet ids drift
otherwise).  `jv_assign` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises, on the current
stream and with no host synchronisation, so a CUDA graph can capture it.

As in the JAX package, `solve_assignment` takes one [R, T] matrix and
`solve_assignment_batch` a [C, R, T] stack (its vmap there); both take
tensors or numpy arrays and return tensors on the input's device.
`hungarian_host` is the exact scipy reference (carried over unchanged).

Forbidden (inf / masked) entries are replaced by (finite max + 100) in
span-normalised units before solving, and a match that lands on such an
entry is reported unmatched (ref PSNWhere_Tracker2D.cpp:1040-1063).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from mcmtt_opticalflow_tpu_torch.ops.nvcc_build import build_library

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


def solve_assignment(cost, row_mask, col_mask, num_iters: int = 2000):
    """Exact min-cost assignment of one matrix.

    Args:
      cost:     [R, T] float cost matrix (inf = forbidden).
      row_mask: [R] bool, valid rows.
      col_mask: [T] bool, valid columns.
      num_iters: unused (the JAX signature's; JV's loop counts are
        bounded by the matrix dimensions).

    Returns (col_of_row [R] int32, -1 when unmatched;
             match_cost [R] float32, inf when unmatched), on the input's
    device.
    """
    del num_iters
    col, mcost = solve_assignment_batch(*(torch.as_tensor(x)[None] for x in
                                          (cost, row_mask, col_mask)))
    return col[0], mcost[0]


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
    arguments and results as `jv_assign`, as CPU tensors."""
    col, mcost = _jv_numpy(_host(cost, np.float32),
                           _host(row_mask, np.bool_),
                           _host(col_mask, np.bool_))
    return torch.from_numpy(col), torch.from_numpy(mcost)


def jv_work(cost, row_mask, col_mask) -> dict:
    """The bytes and float32 operations one `jv_assign` call needs on these
    inputs, for its bound on a device.

    - bytes: the cost matrices (4 B an entry) and masks (1 B) read once,
      col_of_row and match_cost (4 B each per row) written once.
    - flops: 4 per entry for the normalisation (min, max, subtract,
      divide); per Dijkstra step 5 per working column (its masked argmin
      and its relaxation: two subtractions, an addition, a comparison);
      per solved row 3 per working column (its distance start and its
      potential update).  The walk moves indices only.

    Returns {"bytes", "flops", "steps", "max_steps"} as Python ints:
    `steps` the Dijkstra steps of every camera (the sum over its rows of
    each row's steps, counted by running the plain version: the kernel's
    serial chain), `max_steps` those of the slowest camera (the cameras'
    blocks run side by side).
    """
    c, r, t = cost.shape
    nc = max(r, t)
    steps = np.zeros(c, np.int64)
    _jv_numpy(_host(cost, np.float32), _host(row_mask, np.bool_),
              _host(col_mask, np.bool_), steps)
    rows = int(_host(col_mask if r > t else row_mask, np.bool_).sum())
    return {"bytes": c * r * t * 4 + c * (r + t) + c * r * 8,
            "flops": 4 * c * r * t + 5 * nc * int(steps.sum())
            + 3 * nc * rows,
            "steps": int(steps.sum()), "max_steps": int(steps.max(
                initial=0))}


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def build() -> ctypes.CDLL:
    """The library of csrc/jv_assign.cu, built at first use (once per
    source hash) and loaded once."""
    lib, _, _ = build_library("jv_assign.cu")
    if lib.jv_assign_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jv_assign_launch.restype = i
        lib.jv_assign_launch.argtypes = [p] * 3 + [i] * 3 + [p] * 4
        lib.jv_scratch_words.restype = ctypes.c_longlong
        lib.jv_scratch_words.argtypes = [i, i]
        lib.jv_layout.restype = None
        lib.jv_layout.argtypes = [i, i, p]
    return lib


def jv_layout(r: int, t: int) -> dict:
    """Where the JV kernel keeps [R, T] matrices (see csrc/jv_assign.cu):
    {"columns_per_lane": 1, 2, 4 or 8 (the column state in registers) or
    0 (in memory, past 256 working columns), "rows_in_smem" (else in
    device memory), "state_in_smem", "smem_bytes"}."""
    out = (ctypes.c_longlong * 4)()
    build().jv_layout(r, t, out)
    return {"columns_per_lane": out[0], "rows_in_smem": bool(out[1]),
            "state_in_smem": bool(out[2]), "smem_bytes": out[3]}


def jv_scratch(c: int, r: int, t: int, device) -> torch.Tensor:
    """The JV kernel's scratch for [C, R, T] matrices: the normalised rows
    and the column state where they do not fit in shared memory (empty at
    the tracker's shapes)."""
    words = build().jv_scratch_words(r, t)
    return torch.empty(c * words, dtype=torch.float32, device=device)


def _check(cost, row_mask, col_mask):
    if cost.dim() != 3:
        raise ValueError(f"cost must be [C, R, T], got {tuple(cost.shape)}")
    c, r, t = cost.shape
    if tuple(row_mask.shape) != (c, r) or tuple(col_mask.shape) != (c, t):
        raise ValueError(f"masks must be [C, R] and [C, T] for cost "
                         f"{tuple(cost.shape)}: {tuple(row_mask.shape)} "
                         f"{tuple(col_mask.shape)}")


def _launch(cost, row_mask, col_mask, col_of_row, match_cost,
            scratch) -> None:
    """Launch the kernel on prepared tensors (contiguous, of the kernel's
    types, outputs and `jv_scratch` allocated) on the current stream: no
    checks, no count.  jv_assign's launch path, and a timing loop's."""
    c, r, t = cost.shape
    lib = build()
    # the launch and its shared-memory attribute go to the current device
    with torch.cuda.device(cost.device):
        err = lib.jv_assign_launch(
            cost.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(), c, r,
            t, col_of_row.data_ptr(), match_cost.data_ptr(),
            scratch.data_ptr(),
            torch.cuda.current_stream(cost.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jv_assign kernel launch failed: CUDA error "
                           f"{err}")


def jv_assign(cost: torch.Tensor, row_mask: torch.Tensor,
              col_mask: torch.Tensor):
    """Exact min-cost assignment of [C, R, T] float32 matrices with [C, R]
    and [C, T] bool masks, on the tensors' device: the CUDA kernel for
    CUDA tensors, its plain version (`jv_assign_reference`) for CPU
    tensors.  Returns (col_of_row [C, R] int32, -1 when unmatched;
    match_cost [C, R] float32, inf when unmatched).  `jv_assign.launches`
    counts kernel launches."""
    _check(cost, row_mask, col_mask)
    if cost.device.type == "cpu":
        return jv_assign_reference(cost, row_mask, col_mask)
    if cost.device.type != "cuda":
        raise ValueError(f"jv_assign: no kernel for device {cost.device}")
    if row_mask.device != cost.device or col_mask.device != cost.device:
        raise ValueError("jv_assign: all inputs must be on one device")
    c, r, t = cost.shape
    col_of_row = torch.empty((c, r), dtype=torch.int32, device=cost.device)
    match_cost = torch.empty((c, r), dtype=torch.float32, device=cost.device)
    # no-ops for inputs already of the kernel's types (the tracker's)
    _launch(cost.contiguous().float(), row_mask.contiguous().bool(),
            col_mask.contiguous().bool(), col_of_row, match_cost,
            jv_scratch(c, r, t, cost.device))
    if c and r:
        jv_assign.launches += 1
    return col_of_row, match_cost


jv_assign.launches = 0
