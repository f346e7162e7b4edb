"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

- `cuda_device`: fixture that skips a `cuda` test when there is no card.
- `pallas_interpret`: run the JAX package's LK on its Pallas kernel in
  interpret mode on the CPU (the arithmetic the Hopper kernel ports), by
  forcing the backend and wrapping `lk_level_pallas`, which `lk.py`
  imports at trace time.  Nothing in the JAX package changes.
- `JaxFieldSource`: the JAX package's exact solver random fields (its
  threefry draws, split per solve as associator3d.py:2544 and
  mwcp.py:134-141, 279-284 do), handed to the port's solver.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu_torch.models.mwcp import MwcpFields


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100, not here)")
    return torch.device("cuda")


@contextlib.contextmanager
def pallas_interpret():
    from mcmtt_opticalflow_tpu.ops import lk_pallas

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "pallas")
        mp.setattr(lk_pallas, "lk_level_pallas",
                   functools.partial(lk_pallas.lk_level_pallas,
                                     interpret=True))
        yield


def jax_mwcp_fields(key, r, v, iters_pad):
    """The fields `solve_mwcp(key=key)` draws (mwcp.py:134-141, 279-284)."""
    keys = jax.random.split(key, r + 1)
    noise = jax.vmap(lambda k: jax.random.uniform(k, (v,)))(keys[:r])
    ku1, kg2, ku3, kg4 = jax.random.split(keys[r], 4)
    return MwcpFields(
        noise=noise,
        u_dir=jax.random.uniform(ku1, (iters_pad, r)),
        g_dir=jax.random.gumbel(kg2, (iters_pad, r, v)),
        u_ten=jax.random.uniform(ku3, (iters_pad, r)),
        g_rnd=jax.random.gumbel(kg4, (iters_pad, r, v)))


def to_torch_fields(fields, device="cpu"):
    return MwcpFields(*[torch.from_numpy(np.array(f)).to(device)
                        for f in fields])


class JaxFieldSource:
    """Per-solve field source splitting a jax PRNG key as the JAX
    associator does, one split per solved frame."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def draw(self, r, v, iters_pad, device):
        self.key, k = jax.random.split(self.key)
        return to_torch_fields(jax_mwcp_fields(k, r, v, iters_pad), device)


def pad_dets(boxes, cap):
    out = np.zeros((cap, 4), np.float32)
    mask = np.zeros((cap,), bool)
    n = min(len(boxes), cap)
    out[:n] = boxes[:n]
    mask[:n] = True
    return out, mask
