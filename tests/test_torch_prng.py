"""The port's threefry stream (utils/prng.py, models/mwcp.py's
ThreefryFields) against jax.random and the JAX package's solver draws.

`split`, `random_bits` and `uniform` must be bit-equal to jax.random at
odd shapes, at the bench solve's gumbel shape (150, 38, 1024), and after
1, 2 and 37 successive splits.  `gumbel` takes torch's logs: within 2 ulp
of max(|g|, 1) on 99.99% of a (150, 38, 1024) draw and within 1e-3
everywhere.  ThreefryFields must draw what JaxFieldSource draws on three
successive solves (uniform fields bit-equal, gumbel fields as above, and
the solves' masks equal), and the tests/test_torch_pipeline.py scene (2
cameras, 256x192, 10 frames) on the port's default stream must equal the
JAX engine's CPU run: both on the gather LK, ids equal and points within
1 mm every frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu import config as jcfg
from mcmtt_opticalflow_tpu.data import make_scenario
from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine as JaxEngine
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario as t_make_scenario
from mcmtt_opticalflow_tpu_torch.models.mwcp import (ThreefryFields,
                                                     solve_mwcp)
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.utils import prng
from test_torch_pipeline import ARENA, NUM_FRAMES, POINT_ATOL_MM, _cfg
from torch_parity import JaxFieldSource

torch.set_num_threads(2)

SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 9), (150, 38, 1024)]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1])
def test_key_equals_prngkey(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 3, 39])
def test_split_bit_equal(num):
    key, jkey = prng.prng_key(7), jax.random.PRNGKey(7)
    np.testing.assert_array_equal(prng.split(key, num).numpy(),
                                  _np(jax.random.split(jkey, num)))


@pytest.mark.parametrize("chain", [1, 2, 37])
def test_successive_splits_bit_equal(chain):
    """The associator's per-solve pattern: key, k = split(key)."""
    key, jkey = prng.prng_key(0), jax.random.PRNGKey(0)
    for _ in range(chain):
        key, k = prng.split(key)
        jkey, jk = jax.random.split(jkey)
    np.testing.assert_array_equal(key.numpy(), _np(jkey))
    np.testing.assert_array_equal(k.numpy(), _np(jk))
    np.testing.assert_array_equal(prng.uniform(k, (5, 3)).numpy(),
                                  np.asarray(jax.random.uniform(jk, (5, 3))))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_equal(shape):
    key, jkey = prng.prng_key(3), jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        prng.random_bits(key, shape).numpy(),
        _np(jax.random.bits(jkey, shape, jnp.uint32)))
    got = prng.uniform(key, shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, np.asarray(jax.random.uniform(
        jkey, shape)))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(key, shape, tiny, 1.0).numpy(),
        np.asarray(jax.random.uniform(jkey, shape, minval=tiny, maxval=1.0)))


def test_batched_keys_draw_as_vmap():
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    want = jax.vmap(lambda k: jax.random.uniform(k, (11,)))(keys)
    got = prng.uniform(prng.split(prng.prng_key(4), 6), (11,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gumbel_close(got, want):
    d = np.abs(np.asarray(want, np.float64) - np.asarray(got, np.float64))
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert np.mean(d <= 2 * ulp) >= 0.9999, np.max(d / ulp)
    assert d.max() <= 1e-3


@pytest.mark.parametrize("shape", [(7,), (3, 5), (150, 38, 1024)])
def test_gumbel_within_stated_ulps(shape):
    got = prng.gumbel(prng.prng_key(5), shape).numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(5), shape))
    assert got.dtype == np.float32 and got.shape == shape
    _gumbel_close(got, want)


def test_threefry_fields_equal_jax_field_source():
    """Three successive draws at a bench-like replica count, and the
    solves they drive."""
    r, v, iters = 38, 64, 30
    ours, ref = ThreefryFields(prng.prng_key(0)), JaxFieldSource(0)
    rng = np.random.RandomState(0)
    weights = torch.tensor(rng.rand(v).astype(np.float32) * 10)
    up = np.triu(rng.rand(v, v) < 0.5, 1)
    adj = torch.tensor(up | up.T)
    valid = torch.ones(v, dtype=torch.bool)
    init = torch.zeros(v, dtype=torch.bool)
    cfg = tcfg.SolverConfig(num_replicas=r, max_vertices=v,
                            solutions_per_replica=4)
    for _ in range(3):
        a = ours.draw(r, v, iters, "cpu")
        b = ref.draw(r, v, iters, "cpu")
        for name in ("noise", "u_dir", "u_ten"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        for name in ("g_dir", "g_rnd"):
            _gumbel_close(getattr(a, name).numpy(), getattr(b, name).numpy())

        class Fixed:
            def __init__(self, f):
                self.f = f

            def draw(self, *args):
                return self.f
        ra = solve_mwcp(weights, adj, valid, init, Fixed(a), cfg, iters)
        rb = solve_mwcp(weights, adj, valid, init, Fixed(b), cfg, iters)
        assert torch.equal(ra.sol_masks, rb.sol_masks)
        assert torch.equal(ra.best_mask, rb.best_mask)
    np.testing.assert_array_equal(ours.key.numpy(), _np(ref.key))


@pytest.fixture(scope="module")
def default_stream_runs():
    sc = make_scenario(num_cameras=2, num_frames=NUM_FRAMES, num_people=3,
                       image_size=(256, 192), arena=ARENA, seed=11)
    frames = [np.stack(sc.frames(t)) for t in range(NUM_FRAMES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MCMTT_LK_BACKEND", raising=False)
        jeng = JaxEngine(_cfg(jcfg), sc.cameras)
        jres = [jeng.process_frame(frames[t], sc.detections[t], frame_idx=t)
                for t in range(NUM_FRAMES)]
    tsc = t_make_scenario(num_cameras=2, num_frames=NUM_FRAMES,
                          num_people=3, image_size=(256, 192), arena=ARENA,
                          seed=11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        teng = TrackingEngine(_cfg(tcfg), tsc.cameras, device="cpu")
        assert teng.assoc.field_source is None       # the default stream
        tres = [teng.process_frame(frames[t], tsc.detections[t],
                                   frame_idx=t) for t in range(NUM_FRAMES)]
    return jeng, jres, teng, tres


def test_default_stream_engine_equals_jax(default_stream_runs):
    jeng, jres, teng, tres = default_stream_runs
    for t, (j, g) in enumerate(zip(jres, tres)):
        assert j.frame_idx == g.frame_idx == t
        assert j.ids == g.ids, f"first divergent frame {t}"
        np.testing.assert_allclose(np.reshape(g.points, (-1, 3)),
                                   np.reshape(j.points, (-1, 3)), rtol=0,
                                   atol=POINT_ATOL_MM, err_msg=f"frame {t}")
    assert any(len(r.ids) > 0 for r in tres[2:])
    np.testing.assert_array_equal(teng.assoc.solver_key.numpy(),
                                  _np(jeng.assoc.solver_key))
