"""Parity of the port's LK level (plain PyTorch version of the Hopper
kernel) and gather path against the JAX package: the Pallas batched
kernel in interpret mode and the XLA gather path, on the same numpy
inputs.  The CUDA kernel itself is compared with the plain version on
the card (marked `cuda`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.ops.lk import lk_track_points as jax_track_points
from mcmtt_opticalflow_tpu.ops.lk_pallas import lk_level_pallas
from mcmtt_opticalflow_tpu.ops.pyramid import image_gradients as jax_grads
from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
from mcmtt_opticalflow_tpu_torch.ops.lk import lk_track_points
from mcmtt_opticalflow_tpu_torch.ops.lk_kernel import (lk_level,
                                                       lk_level_reference)
from mcmtt_opticalflow_tpu_torch.ops.pyramid import image_gradients
from test_lk_pallas import _scene
from torch_parity import cuda_device  # noqa: F401  (fixture)

torch.set_num_threads(2)

# stated tolerances: float32 sums in another order than the TPU kernel's
TRACKED_ATOL = 1e-3      # px
RESID_ATOL = 1e-5


def _jax_level(prev, nxt, cam, pts, guess, act, window, iters):
    out = lk_level_pallas(jnp.asarray(prev), jnp.asarray(nxt),
                          jnp.asarray(cam), jnp.asarray(pts),
                          jnp.asarray(guess), active=jnp.asarray(act),
                          window=window, iters=iters, interpret=True,
                          variant="batched")
    return [np.asarray(o) for o in out]


def _torch_level(prev, nxt, cam, pts, guess, act, window, iters):
    out = lk_level(torch.tensor(prev), torch.tensor(nxt), torch.tensor(cam),
                   torch.tensor(pts), torch.tensor(guess), torch.tensor(act),
                   window=window, iters=iters)
    return [o.numpy() for o in out]


def _assert_level_equal(ref, got):
    tr_r, ok_r, res_r = ref
    tr_g, ok_g, res_g = got
    np.testing.assert_array_equal(ok_g, ok_r)
    np.testing.assert_allclose(tr_g, tr_r, rtol=0, atol=TRACKED_ATOL)
    np.testing.assert_allclose(res_g, res_r, rtol=0, atol=RESID_ATOL)


def _two_camera_scene(rng, shift):
    a = _scene(rng, shift=shift)
    b = _scene(rng, shift=(-shift[1], shift[0]))
    return np.stack([a[0], b[0]]), np.stack([a[1], b[1]])


@pytest.mark.parametrize("window", [8, 16])
@pytest.mark.parametrize("shift", [(2.3, -1.6), (0.4, 0.9), (-3.1, 2.2)])
def test_level_matches_pallas_interpret(shift, window):
    rng = np.random.RandomState(7)
    prev, nxt = _two_camera_scene(rng, shift)
    _, h, w = prev.shape
    n = 48
    pts = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)],
                   -1).astype(np.float32)
    guess = (pts + rng.uniform(-3, 3, (n, 2))).astype(np.float32)
    cam = (np.arange(n) % 2).astype(np.int32)
    act = rng.rand(n) < 0.75
    ref = _jax_level(prev, nxt, cam, pts, guess, act, window, 8)
    got = _torch_level(prev, nxt, cam, pts, guess, act, window, 8)
    _assert_level_equal(ref, got)
    assert ref[1].sum() >= 10          # the scene exercises valid tracks


def test_level_edge_cases():
    """Points at the patch and image edges, guesses far off, inactive
    slots (which return the patch corner, valid False, residual 0)."""
    rng = np.random.RandomState(3)
    prev, nxt = _two_camera_scene(rng, (1.2, -0.7))
    _, h, w = prev.shape
    xs = [0.0, 0.5, 1.0, 8.0, 63.9, 64.0, 127.5, 128.0, 191.0, 240.0,
          247.5, 254.0, 255.9, 300.0, -5.0, 130.0]
    ys = [0.0, 0.5, 1.0, 2.0, 8.0, 19.5, 20.0, 31.9, 40.0, 55.0, 60.5,
          62.0, 63.9, 80.0, -3.0, 33.0]
    pts = np.asarray([(x, y) for x in xs for y in ys[:4]]
                     + [(x, y) for x in xs[:4] for y in ys], np.float32)
    n = len(pts)
    guess = pts.copy()
    guess[::3] += np.float32(20.0)        # far guesses: clamp to the patch
    guess[1::3] -= np.float32(0.75)
    cam = (np.arange(n) % 2).astype(np.int32)
    act = np.ones(n, bool)
    act[::5] = False
    ref = _jax_level(prev, nxt, cam, pts, guess, act, 16, 8)
    got = _torch_level(prev, nxt, cam, pts, guess, act, 16, 8)
    _assert_level_equal(ref, got)
    assert not got[1][~act].any() and (got[2][~act] == 0).all()


@pytest.mark.parametrize("window", [8, 16])
def test_track_points_matches_jax(window):
    rng = np.random.RandomState(11)
    prev, nxt = _scene(rng, shift=(1.7, -0.9))
    h, w = prev.shape
    n = 40
    pts = np.stack([rng.uniform(-4, w + 4, n), rng.uniform(-4, h + 4, n)],
                   -1).astype(np.float32)
    gx, gy = jax_grads(jnp.asarray(prev))
    ref = jax_track_points(jnp.asarray(prev), jnp.asarray(nxt), gx, gy,
                           jnp.asarray(pts), jnp.asarray(pts),
                           window=window, iterations=8)
    tp, tn = torch.tensor(prev), torch.tensor(nxt)
    ix, iy = image_gradients(tp)
    np.testing.assert_allclose(ix.numpy(), np.asarray(gx), rtol=1e-6)
    got = lk_track_points(tp, tn, ix, iy, torch.tensor(pts),
                          torch.tensor(pts), window=window, iterations=8)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for g, r in zip((got[0], got[2]), (ref[0], ref[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)


def test_wrapper_counts_only_kernel_launches():
    """On CPU tensors the wrapper takes the plain version and counts no
    kernel launch."""
    rng = np.random.RandomState(0)
    prev, nxt = _scene(rng)
    before = lk_level.launches
    n = 8
    pts = np.full((n, 2), 30.0, np.float32)
    _torch_level(prev[None], nxt[None], np.zeros(n, np.int32), pts, pts,
                 np.ones(n, bool), 16, 4)
    assert lk_level.launches == before


def test_window_larger_than_kernel_rejected():
    z = torch.zeros((1, 64, 256))
    p = torch.zeros((8, 2))
    with pytest.raises(ValueError):
        lk_level(z, z, torch.zeros(8, dtype=torch.int32), p, p,
                 torch.ones(8, dtype=torch.bool), window=32)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    rng = np.random.RandomState(5)
    prev, nxt = _two_camera_scene(rng, (2.3, -1.6))
    _, h, w = prev.shape
    n = 4096
    pts = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)],
                   -1).astype(np.float32)
    guess = (pts + rng.uniform(-3, 3, (n, 2))).astype(np.float32)
    args = [torch.tensor(a, device=cuda_device) for a in
            (prev, nxt, (np.arange(n) % 2).astype(np.int32), pts, guess,
             rng.rand(n) < 0.3)]
    lk_kernel.build()
    before = lk_level.launches
    tr_k, ok_k, res_k = lk_level(*args, window=16, iters=8)
    torch.cuda.synchronize()
    assert lk_level.launches == before + 1
    tr_r, ok_r, res_r = lk_level_reference(*args, window=16, iters=8)
    assert (ok_k == ok_r).float().mean().item() >= 0.999
    both = ok_k & ok_r
    assert (tr_k - tr_r)[both].abs().max().item() <= TRACKED_ATOL
    assert (res_k - res_r)[both].abs().max().item() <= 1e-4
