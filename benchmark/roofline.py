"""Peaks of the card and the work of the kernels the benchmark rates.

Published peaks of one NVIDIA H100 SXM (the data sheet, dense): HBM3 at
3.35 TB/s and 67 TFLOP/s in float32 outside the tensor cores, at the full
700 W limit.

`bls_bytes` and `bls_ops` are frozen copies of the arithmetic of
mcmtt_opticalflow_tpu_torch/ops/mwcp_kernel.py::bls_work at commit
052b569610a6, written as functions of the launch's shapes: replicas R,
vertices V, ring slots S, iterations n.  The bytes are each input read
once and each output written once: the fields' rows of the n iterations
(g_dir and g_rnd 4 B a replica and vertex, u_dir and u_ten 4 B a
replica), the graph (weights 4 B, valid 1 B, adjacency 1 B a pair), and
the replicas' state read once and written once (in_c, best, cp 1 B and
tabu 4 B a vertex; the ring 1 B a slot and vertex plus 4 B a score; 17 B
of scalars).  The operations depend on the clique sizes the search
visits; `bls_ops` takes the largest clique, |C| = V, so it is an upper
bound on them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BLOCK = 50          # iterations a BLS launch runs (FrameProgram.BLOCK)


def bls_bytes(r: int, v: int, s: int, n: int) -> int:
    state = r * v * (3 + 4) + r * s * (v + 4) + r * 17
    return n * r * (2 * v * 4 + 2 * 4) + v * 4 + v + v * v + 2 * state


def bls_ops(r: int, v: int, n: int, members: int) -> int:
    """Operations of n iterations whose cliques have `members` vertices
    summed over iterations and replicas."""
    return v * (2 * members + 20 * n * r)


def bls_launches(iters_padded: int):
    """The iterations of each BLS launch of one solve, in order: blocks
    of BLOCK, then the rest."""
    out = [BLOCK] * (iters_padded // BLOCK)
    if iters_padded % BLOCK:
        out.append(iters_padded % BLOCK)
    return out

