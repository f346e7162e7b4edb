# Plain copy of mcmtt_opticalflow_tpu_torch/ops/threefry_kernel.py (threefry_fields_reference) at commit 052b569610a6.
"""The solver's random fields of one solve, drawn with prng.py: noise
[r, v], u_dir [ip, r], g_dir [ip, r, v], u_ten [ip, r], g_rnd [ip, r, v],
all float32, in that order (as the JAX package's solve_mwcp draws them).
"""

from __future__ import annotations

import torch

from reference import prng

FIELDS = ("noise", "u_dir", "g_dir", "u_ten", "g_rnd")


def threefry_fields_reference(key: torch.Tensor, r: int, v: int,
                              iters_pad: int):
    """The plain version: the fields drawn by utils/prng.py on the key's
    device, as the JAX package's solve draws them (a tuple in FIELDS
    order)."""
    keys = prng.split(key, r + 1)
    ku1, kg2, ku3, kg4 = prng.split(keys[r], 4)
    return (prng.uniform(keys[:r], (v,)),
            prng.uniform(ku1, (iters_pad, r)),
            prng.gumbel(kg2, (iters_pad, r, v)),
            prng.uniform(ku3, (iters_pad, r)),
            prng.gumbel(kg4, (iters_pad, r, v)))




def threefry_fields(key: torch.Tensor, r: int, v: int, iters_pad: int,
                    out=None):
    """The fields in plain PyTorch on the key's device (into `out`'s
    tensors when given)."""
    fields = threefry_fields_reference(key, r, v, iters_pad)
    if out is None:
        return fields
    for dst, src in zip(out, fields):
        dst.copy_(src)
    return tuple(out)
