# Frozen copy of mcmtt_opticalflow_tpu_torch/utils/prng.py at commit 052b569610a6, for the benchmark's
# plain reference; imports point at the copies beside it.
"""The JAX package's random numbers in plain PyTorch: threefry2x32 keys,
`split`, `random_bits`, `uniform` and `gumbel`, computed as jax 0.9 does
with `jax_threefry_partitionable` on (its default;
jax/_src/prng.py::_threefry_split_foldlike, _threefry_random_bits_partitionable,
jax/_src/random.py::_uniform, _gumbel with mode "low").

A key is an int64 tensor of shape [..., 2] holding two uint32 words; a
leading batch of keys draws one independent sample per key, as `jax.vmap`
over keys does.  The 32-bit words live in int64 and are masked after
every add and rotate, so the code runs on any device.

`split`, `random_bits` and `uniform` are bit-equal to jax.random.  `gumbel`
takes two logs of a bit-equal uniform with torch's `log`, which may round
differently from XLA's: within 2 ulp of jax.random.gumbel
(tests/test_torch_prng.py)."""

from __future__ import annotations

from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a 32-bit seed: the words
    (seed >> 32, seed & 0xFFFFFFFF), where an int32 seed's high word is 0."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & _MASK
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2); every argument broadcasts against the
    others (jax/_src/prng.py::_threefry2x32_lowering)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0.add_(x1).bitwise_and_(_MASK)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0 = x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1 = x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x0, x1


# counters hashed per pass on the CPU, so that each pass's words stay in
# cache (on a GPU one pass covers the whole draw)
_CPU_CHUNK = 1 << 18


def _hash(key: torch.Tensor, shape: Sequence[int]):
    """threefry2x32 of the 64-bit iota over `shape` (as high and low
    words) under every key of a [..., 2] batch: two words of shape
    [..., *shape]."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    k1 = key[..., 0].reshape(-1, 1)
    k2 = key[..., 1].reshape(-1, 1)
    step = max(n, 1)
    if key.device.type == "cpu":
        step = max(_CPU_CHUNK // k1.shape[0], 1)
    words = ([], [])
    for c0 in range(0, max(n, 1), step):
        c = torch.arange(c0, min(c0 + step, n), dtype=torch.int64,
                         device=key.device)
        for out, w in zip(words, threefry2x32(k1, k2, c >> 32, c & _MASK)):
            out.append(w)
    out_shape = key.shape[:-1] + shape
    return tuple(torch.cat(w, -1).reshape(out_shape) for w in words)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): [num, 2] keys ([..., num, 2] for a
    batch of keys)."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], -1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.bits(key, shape) at 32 bits, as int64 in [0, 2^32)."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval): the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    # filled on the device (no host copy, so a CUDA graph can hold it)
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.gumbel(key, shape) in float32, mode "low"."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))
