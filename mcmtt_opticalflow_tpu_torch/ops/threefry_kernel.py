"""The solver's random fields of one solve in one hand-written CUDA kernel
(csrc/threefry_fields.cu), and its plain PyTorch version.

`threefry_fields(key, r, v, iters_pad, out=None)` draws the five fields
that the JAX package's solve_mwcp draws from its key with jax.random
(mcmtt_opticalflow_tpu/models/mwcp.py:134-141, 279-284): noise [r, v],
u_dir [ip, r], g_dir [ip, r, v], u_ten [ip, r], g_rnd [ip, r, v], all
float32, in that order.  For a key on the CPU it takes the plain version
`threefry_fields_reference` (utils/prng.py); for a key on a card it
launches the kernel, on the current stream with no host read (the key is
read on the device, so a CUDA graph captures the draw), or raises.  With
`out`, five float32 tensors of those shapes on the key's device, the
fields are written into them in place.  `threefry_fields.launches` counts
kernel launches; `field_work` gives the bytes and instructions behind
the kernel's bound.  models/mwcp.py::threefry_fields is the solver's entry.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mcmtt_opticalflow_tpu_torch.ops.mwcp_kernel import HBM_BYTES_PER_S
from mcmtt_opticalflow_tpu_torch.ops.nvcc_build import build_library
from mcmtt_opticalflow_tpu_torch.utils import prng

FIELDS = ("noise", "u_dir", "g_dir", "u_ten", "g_rnd")
# Instructions a number of the built kernel (sm_90a, nvcc 12.8, the
# repo's NVCC_FLAGS), counted in its SASS (`cuobjdump -sass` on the
# library in _build/) by chip_smoke.py's threefry phase, which recounts
# them on the card and fails when they differ: a draw loop's body on its
# 16-byte-store path over the 4 numbers it draws, the mean of the two
# loops of a kind.  A threefry2x32 hash is ~60 of them (20 rounds of add,
# rotate, xor); libdevice's logf is a polynomial with no MUFU.  *_ALU:
# those that issue to the integer ALU pipe (IADD3, LOP3, SHF, ISETP, LEA,
# VIADD, I2FP; IMAD issues to the FMA pipe).  The noise rows are counted
# as uniforms.
GUMBEL_INSTRUCTIONS = 130.375
GUMBEL_ALU_INSTRUCTIONS = 63.25
UNIFORM_INSTRUCTIONS = 79.125
UNIFORM_ALU_INSTRUCTIONS = 49.25
# The card: an H100 SXM's SMs and maximum SM clock (nvidia-smi
# --query-gpu=clocks.max.sm: 1980 MHz); an SM issues at most 4
# warp-instructions a clock (one per scheduler), and 32-bit integer ALU
# ones at half that (16 lanes a scheduler).
SMS = 132
SM_CLOCK_HZ = 1.98e9
WARP_INSTRUCTIONS_PER_CLOCK = 4
ALU_PER_CLOCK = 2


def field_shapes(r: int, v: int, iters_pad: int):
    """The five fields' shapes, in FIELDS order."""
    return ((r, v), (iters_pad, r), (iters_pad, r, v), (iters_pad, r),
            (iters_pad, r, v))


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


def field_work(r: int, v: int, iters_pad: int) -> dict:
    """The bytes and instructions one draw needs, and the least time they
    take on the card.  Bytes: every number written once (4 B), no input
    but the key (16 B).  Instructions: the built kernel's a number
    (GUMBEL_* and UNIFORM_* above), issued by a warp for 32 numbers at a
    time: at most WARP_INSTRUCTIONS_PER_CLOCK a clock on each of SMS SMs
    at SM_CLOCK_HZ, the integer ALU ones at ALU_PER_CLOCK.  The
    bound is the largest of the three times.  Returns {"numbers",
    "bytes", "instructions", "alu_instructions", "bytes_s", "issue_s",
    "alu_s", "bound_s", "bound_by"}."""
    uniforms = r * v + 2 * iters_pad * r
    gumbels = 2 * iters_pad * r * v
    numbers = uniforms + gumbels
    nbytes = 4 * numbers + 16
    instr = GUMBEL_INSTRUCTIONS * gumbels + UNIFORM_INSTRUCTIONS * uniforms
    alu = (GUMBEL_ALU_INSTRUCTIONS * gumbels
           + UNIFORM_ALU_INSTRUCTIONS * uniforms)
    warp_clocks = SMS * SM_CLOCK_HZ * 32
    times = {"bytes_s": nbytes / HBM_BYTES_PER_S,
             "issue_s": instr / (WARP_INSTRUCTIONS_PER_CLOCK * warp_clocks),
             "alu_s": alu / (ALU_PER_CLOCK * warp_clocks)}
    bound = max(times.values())
    return {"numbers": numbers, "bytes": nbytes, "instructions": instr,
            "alu_instructions": alu, **times, "bound_s": bound,
            "bound_by": "bytes" if bound == times["bytes_s"]
            else "operations"}


def build() -> ctypes.CDLL:
    """The library of csrc/threefry_fields.cu, built at first use (once
    per source hash) and loaded once."""
    lib, _, _ = build_library("threefry_fields.cu")
    if lib.threefry_fields_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.threefry_fields_launch.restype = i
        lib.threefry_fields_launch.argtypes = [p] + [i] * 3 + [p] * 6
    return lib


def _check(key, r, v, iters_pad, out):
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int64 or \
            tuple(key.shape) != (2,):
        raise ValueError(f"key must be an int64 tensor of shape (2,), got "
                         f"{getattr(key, 'dtype', type(key))} "
                         f"{tuple(getattr(key, 'shape', ()))}")
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"threefry_fields: no kernel for device "
                         f"{key.device}")
    if min(r, v, iters_pad) < 0:
        raise ValueError(f"r, v and iters_pad must be >= 0, got "
                         f"{(r, v, iters_pad)}")
    if out is None:
        return
    if len(out) != len(FIELDS):
        raise ValueError(f"out must hold {len(FIELDS)} tensors, got "
                         f"{len(out)}")
    for name, t, shape in zip(FIELDS, out, field_shapes(r, v, iters_pad)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"out {name} must be float32 of shape {shape},"
                             f" got {t.dtype} {tuple(t.shape)}")
        if t.device != key.device or not t.is_contiguous():
            raise ValueError(f"out {name} must be contiguous on the key's "
                             f"device {key.device}")


def _launch(key, r, v, iters_pad, out) -> None:
    """Launch the draw on a checked key and checked output tensors on the
    current stream: no count.  threefry_fields' launch path, and a timing
    loop's."""
    lib = build()
    with torch.cuda.device(key.device):
        err = lib.threefry_fields_launch(
            key.data_ptr(), r, v, iters_pad, *[t.data_ptr() for t in out],
            torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_fields kernel launch failed: CUDA "
                           f"error {err}")


def threefry_fields(key: torch.Tensor, r: int, v: int, iters_pad: int,
                    out=None):
    """The five fields of one solve from `key` ([2] int64, two uint32
    words) on its device, as a tuple in FIELDS order (`out` when given,
    written in place).  `threefry_fields.launches` counts kernel
    launches."""
    r, v, iters_pad = int(r), int(v), int(iters_pad)
    _check(key, r, v, iters_pad, out)
    shapes = field_shapes(r, v, iters_pad)
    if not any(math.prod(s) for s in shapes):     # every field empty
        return tuple(out) if out is not None else tuple(
            torch.empty(s, device=key.device) for s in shapes)
    if key.device.type == "cpu":
        fields = threefry_fields_reference(key, r, v, iters_pad)
        if out is None:
            return fields
        for dst, src in zip(out, fields):
            dst.copy_(src)
        return tuple(out)
    if out is None:
        out = tuple(torch.empty(s, device=key.device) for s in shapes)
    _launch(key.contiguous(), r, v, iters_pad, out)
    threefry_fields.launches += 1
    return tuple(out)


threefry_fields.launches = 0
