"""Parity of the port's serial LK level variant (plain PyTorch version of
its Hopper kernel) against the JAX package's
lk_level_pallas(variant="serial") in interpret mode, on the same numpy
inputs; the semantic difference from the batched variant (the working
subpatch clamp); and, on the card (marked `cuda`), the CUDA kernel
against its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.ops.lk_pallas import lk_level_pallas
from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
from mcmtt_opticalflow_tpu_torch.ops.lk_kernel import (lk_level,
                                                       lk_level_reference)
from test_torch_lk import (TRACKED_ATOL, _assert_level_equal,
                           _two_camera_scene)
from torch_parity import cuda_device  # noqa: F401  (fixture)

torch.set_num_threads(2)

N = 48


def _jax_level(args, window, iters=8, variant="serial"):
    prev, nxt, cam, pts, guess, act = args
    out = lk_level_pallas(jnp.asarray(prev), jnp.asarray(nxt),
                          jnp.asarray(cam), jnp.asarray(pts),
                          jnp.asarray(guess), active=jnp.asarray(act),
                          window=window, iters=iters, interpret=True,
                          variant=variant)
    return [np.asarray(o) for o in out]


def _torch_level(args, window, iters=8, variant="serial"):
    out = lk_level(*[torch.tensor(a) for a in args], window=window,
                   iters=iters, variant=variant)
    return [o.numpy() for o in out]


def _random_features(rng, prev, guess_off):
    """N features over both cameras with guesses `guess_off` px off."""
    _, h, w = prev.shape
    pts = np.stack([rng.uniform(0, w, N), rng.uniform(0, h, N)],
                   -1).astype(np.float32)
    guess = (pts + rng.uniform(-guess_off, guess_off, (N, 2))).astype(
        np.float32)
    return pts, guess, (np.arange(N) % 2).astype(np.int32), rng.rand(N) < 0.75


@pytest.mark.parametrize("window", [8, 16])
@pytest.mark.parametrize("shift", [(2.3, -1.6), (0.4, 0.9), (-3.1, 2.2)])
def test_serial_matches_pallas_interpret(shift, window):
    rng = np.random.RandomState(7)
    prev, nxt = _two_camera_scene(rng, shift)
    pts, guess, cam, act = _random_features(rng, prev, 3.0)
    args = (prev, nxt, cam, pts, guess, act)
    ref = _jax_level(args, window)
    _assert_level_equal(ref, _torch_level(args, window))
    assert ref[1].sum() >= 10          # the scene exercises valid tracks


@pytest.mark.parametrize("window", [8, 16])
def test_serial_far_guesses(window):
    """Guesses 10-20 px off: the subpatch clamp binds on some slots."""
    rng = np.random.RandomState(9)
    prev, nxt = _two_camera_scene(rng, (1.7, -0.9))
    pts, guess, cam, act = _random_features(rng, prev, 3.0)
    far = rng.uniform(10.0, 20.0, (N, 2)) * rng.choice([-1.0, 1.0], (N, 2))
    guess = (pts + far.astype(np.float32)).astype(np.float32)
    args = (prev, nxt, cam, pts, guess, act)
    ref = _jax_level(args, window)
    got = _torch_level(args, window)
    _assert_level_equal(ref, got)
    assert ref[1].any() and not ref[1][act].all()


def test_serial_edge_cases():
    """The edge scene of test_torch_lk.test_level_edge_cases: points at
    the patch and image edges, guesses 20 px off, inactive slots (which
    return the patch corner, valid False, residual 0)."""
    rng = np.random.RandomState(3)
    prev, nxt = _two_camera_scene(rng, (1.2, -0.7))
    xs = [0.0, 0.5, 1.0, 8.0, 63.9, 64.0, 127.5, 128.0, 191.0, 240.0,
          247.5, 254.0, 255.9, 300.0, -5.0, 130.0]
    ys = [0.0, 0.5, 1.0, 2.0, 8.0, 19.5, 20.0, 31.9, 40.0, 55.0, 60.5,
          62.0, 63.9, 80.0, -3.0, 33.0]
    pts = np.asarray([(x, y) for x in xs for y in ys[:4]]
                     + [(x, y) for x in xs[:4] for y in ys], np.float32)
    n = len(pts)
    guess = pts.copy()
    guess[::3] += np.float32(20.0)
    guess[1::3] -= np.float32(0.75)
    cam = (np.arange(n) % 2).astype(np.int32)
    act = np.ones(n, bool)
    act[::5] = False
    args = (prev, nxt, cam, pts, guess, act)
    got = _torch_level(args, 16)
    _assert_level_equal(_jax_level(args, 16), got)
    assert not got[1][~act].any() and (got[2][~act] == 0).all()
    ref_b = _torch_level(args, 16, variant="batched")
    np.testing.assert_array_equal(got[0][~act], ref_b[0][~act])


def _sinusoid_scene():
    """A smooth scene moved by (0.5, 1.0) px: LK converges from ~9 rows
    away, farther than the serial variant's subpatch lets it move."""
    ys, xs = np.mgrid[0:64, 0:256].astype(np.float32)

    def f(y, x):
        return (0.5 + 0.2 * np.sin(x / 9.0)
                + 0.2 * np.sin(y / 7.0)).astype(np.float32)
    return f(ys, xs)[None], f(ys - 1.0, xs + 0.5)[None]


def test_serial_differs_from_batched_where_subpatch_clamp_binds():
    """Guesses 10 rows below the true position.  The batched variant may
    move anywhere in its 40-row patch and recovers the motion; the serial
    variant's estimate may move only -7..+6 rows from the guess's floor
    (w=16: subpatch 32 rows, the guess window 8 rows down), so it stops at
    the subpatch's top row and reports invalid.  The JAX package's two
    variants differ in the same way."""
    prev, nxt = _sinusoid_scene()
    rng = np.random.RandomState(0)
    n = 16
    pts = np.stack([rng.uniform(40, 216, n), rng.uniform(24, 40, n)],
                   -1).astype(np.float32)
    guess = (pts + np.float32([0.0, 10.0])).astype(np.float32)
    args = (prev, nxt, np.zeros(n, np.int32), pts, guess, np.ones(n, bool))
    serial = _torch_level(args, 16)
    batched = _torch_level(args, 16, variant="batched")
    _assert_level_equal(_jax_level(args, 16), serial)
    _assert_level_equal(_jax_level(args, 16, variant="batched"), batched)
    # the serial estimate sits on the subpatch's top row: the guess
    # window's floor less (32 - 16) // 2 rows, plus the lowest clamp 1
    half = 7.5
    top = np.floor(guess[:, 1] - half) - 8 + 1 + half
    np.testing.assert_allclose(serial[0][:, 1], top, rtol=0,
                               atol=TRACKED_ATOL)
    assert not serial[1].any()
    assert batched[1].sum() >= n - 2
    flow = batched[0][batched[1]] - pts[batched[1]]
    assert (np.abs(flow[:, 1] - 1.0) < 0.3).mean() >= 0.8
    assert (np.abs(serial[0][:, 1] - batched[0][:, 1]) > 0.5).all()


def test_unknown_variant_rejected():
    z = torch.zeros((1, 64, 256))
    p = torch.full((8, 2), 30.0)
    args = (z, z, torch.zeros(8, dtype=torch.int32), p, p,
            torch.ones(8, dtype=torch.bool))
    for fn in (lk_level, lk_level_reference):
        with pytest.raises(ValueError):
            fn(*args, window=16, iters=4, variant="rolled")


def test_serial_on_cpu_counts_no_kernel_launch():
    rng = np.random.RandomState(0)
    prev, nxt = _two_camera_scene(rng, (1.0, 1.0))
    pts, guess, cam, act = _random_features(rng, prev, 2.0)
    before = (lk_level.launches, lk_level.serial_launches)
    _torch_level((prev, nxt, cam, pts, guess, act), 16, 4)
    assert (lk_level.launches, lk_level.serial_launches) == before


@pytest.mark.cuda
def test_cuda_serial_kernel_matches_plain_version(cuda_device):
    rng = np.random.RandomState(5)
    prev, nxt = _two_camera_scene(rng, (2.3, -1.6))
    _, h, w = prev.shape
    n = 4096
    pts = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)],
                   -1).astype(np.float32)
    guess = (pts + rng.uniform(-15, 15, (n, 2))).astype(np.float32)
    args = [torch.tensor(a, device=cuda_device) for a in
            (prev, nxt, (np.arange(n) % 2).astype(np.int32), pts, guess,
             rng.rand(n) < 0.3)]
    lk_kernel.build()
    before = lk_level.serial_launches
    tr_k, ok_k, res_k = lk_level(*args, window=16, iters=8,
                                 variant="serial")
    torch.cuda.synchronize()
    assert lk_level.serial_launches == before + 1
    tr_r, ok_r, res_r = lk_level_reference(*args, window=16, iters=8,
                                           variant="serial")
    assert (ok_k == ok_r).float().mean().item() >= 0.999
    both = ok_k & ok_r
    assert (tr_k - tr_r)[both].abs().max().item() <= TRACKED_ATOL
    assert (res_k - res_r)[both].abs().max().item() <= 1e-4
