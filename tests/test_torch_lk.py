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
from mcmtt_opticalflow_tpu_torch.ops.lk_kernel import (SLOT_BYTES, lk_level,
                                                       lk_level_reference,
                                                       lk_level_work)
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


# One feature at (100.3, 20.4) of a [1, 64, 256] level, w=8: both patch
# corners are (0, 0), its template reads the 11x11 region of prev at row
# 15, column 95, and its first Newton window the 9x9 region of next at
# row 16, column 97 (the guess (100.9, 20.0) less half the window).
_PT, _GUESS, _W = (100.3, 20.4), (100.9, 20.0), 8
_TAP = {"batched": 9, "serial": 11}


def _work_inputs(img_prev, img_next, active, dup=False, first=_GUESS):
    n = len(active)
    pts = np.tile(np.float32([[5.0, 5.0]]), (n, 1))
    guess = pts.copy()
    pts[0], guess[0] = _PT, first
    if dup:
        pts[1], guess[1] = _PT, first
    return [torch.tensor(a) for a in (img_prev[None], img_next[None],
                                      np.zeros(n, np.int32), pts, guess,
                                      np.asarray(active, bool))]


def _flops(variant, steps, features=1):
    w2, tap = _W * _W, _TAP[variant]
    return (features * ((_W + 2) ** 2 * tap + w2 * 10 + w2 * (tap + 2))
            + steps * w2 * (tap + 5))


@pytest.mark.parametrize("variant", ["batched", "serial"])
@pytest.mark.parametrize("dup", [False, True])
def test_work_counts_a_feature_that_freezes_at_step_one(variant, dup):
    """A flat image has no gradient, so the feature's step is 0 and it
    freezes after step 1 of 5: one template region, one next window (the
    residual reads the same one).  Inactive slots add their slot bytes
    only; a second feature with the same windows adds no image bytes."""
    flat = np.full((64, 256), 0.5, np.float32)
    active = [True, dup, False, False]
    got = lk_level_work(*_work_inputs(flat, flat, active, dup), window=_W,
                        iters=5, variant=variant)
    features = 2 if dup else 1
    assert got["steps"] == features
    assert got["image_bytes"] == 4 * (11 * 11 + 9 * 9)
    assert got["bytes"] == 4 * SLOT_BYTES + 4 * (11 * 11 + 9 * 9)
    assert SLOT_BYTES == 34
    assert got["flops"] == _flops(variant, features, features)


def test_work_counts_one_forced_step():
    """iters=1 on a textured scene, guess (101.5, 19.5): one Newton step
    from the 9x9 window at row 16, column 98, then the residual window
    where the step ended; the two windows count their overlap once."""
    prev, nxt = _scene(np.random.RandomState(1), shift=(2.3, -1.6))
    args = _work_inputs(prev, nxt, [True, False, False], first=(101.5, 19.5))
    got = lk_level_work(*args, window=_W, iters=1)
    tracked = lk_level_reference(*args, window=_W, iters=1)[0][0].tolist()
    half = (_W - 1) / 2
    ey, ex = int(np.floor(tracked[1] - half)), int(np.floor(tracked[0] - half))
    dy, dx = abs(ey - 16), abs(ex - 98)
    assert (dy, dx) != (0, 0)             # the step moved the window
    union = 2 * 81 - max(0, 9 - dy) * max(0, 9 - dx)
    assert got["steps"] == 1
    assert got["image_bytes"] == 4 * (11 * 11 + union)
    assert got["bytes"] == 3 * SLOT_BYTES + got["image_bytes"]
    assert got["flops"] == _flops("batched", 1)


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
