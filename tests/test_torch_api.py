"""Parity of the port's public ops against the JAX package on the same
numpy inputs: camera position and back-projection lines, N-view
reconstruction, the 3x3 blur and direct SG smoothing, the device RGB
histogram (exact) and appearance cost, the enter / exit / connectivity
costs, the host Hungarian and both assignment names, `lk_track_pyramid`
(the JAX side on its Pallas kernel in interpret mode), the batched clique
solve with the JAX package's fields and the host K-best, and the
single-camera 2D step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.config import Associator3DConfig, SolverConfig
from mcmtt_opticalflow_tpu.data import make_scenario as jax_make_scenario
from mcmtt_opticalflow_tpu.geometry import tsai as jax_tsai
from mcmtt_opticalflow_tpu.geometry import triangulation as jax_tri
from mcmtt_opticalflow_tpu.models import costs as jax_costs
from mcmtt_opticalflow_tpu.models import mwcp as jax_mwcp
from mcmtt_opticalflow_tpu.ops import histogram as jax_hist
from mcmtt_opticalflow_tpu.ops import hungarian as jax_hungarian
from mcmtt_opticalflow_tpu.ops import lk as jax_lk
from mcmtt_opticalflow_tpu.ops import pyramid as jax_pyramid
from mcmtt_opticalflow_tpu.ops import sgsmooth as jax_sg
from mcmtt_opticalflow_tpu_torch import convert
from mcmtt_opticalflow_tpu_torch.config import Tracker2DConfig
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.geometry import (
    back_projection_line, camera_position, nview_ground_reconstruction,
    nview_point_reconstruction)
from mcmtt_opticalflow_tpu_torch.geometry.tsai import stack_cameras
from mcmtt_opticalflow_tpu_torch.models import (init_tracker2d_state,
                                                make_tracker2d_step)
from mcmtt_opticalflow_tpu_torch.models.costs import (enter_probability,
                                                      exit_cost,
                                                      tracklet_connectivity)
from mcmtt_opticalflow_tpu_torch.models.mwcp import (MwcpResult,
                                                     collect_k_best,
                                                     solve_mwcp_batch)
from mcmtt_opticalflow_tpu_torch.ops import (gaussian_blur_3x3,
                                             hungarian_host, lk_track_pyramid,
                                             rgb_histogram, sg_smooth,
                                             solve_assignment,
                                             solve_assignment_batch)
from mcmtt_opticalflow_tpu_torch.ops.histogram import (host_rgb_histogram,
                                                       rgb_cost)
from mcmtt_opticalflow_tpu_torch.ops.lk_kernel import lk_level
from torch_parity import jax_mwcp_fields, pad_dets, pallas_interpret
from torch_parity import to_torch_fields

torch.set_num_threads(2)

CFG = Associator3DConfig()


def _close(got, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def cams():
    sc = jax_make_scenario(num_cameras=3, num_frames=1, num_people=2,
                           image_size=(256, 192), seed=4)
    jcams = jax_tsai.stack_cameras(sc.cameras)
    tcams = convert.camera_from_numpy(
        {f: np.asarray(getattr(jcams, f)) for f in jcams._fields})
    return jcams, tcams


# ---- geometry --------------------------------------------------------------

def test_camera_position(cams):
    jcams, tcams = cams
    _close(camera_position(tcams), jax.vmap(jax_tsai.camera_position)(jcams))


def test_back_projection_line(cams):
    jcams, tcams = cams
    uv = np.random.RandomState(0).uniform(-20, 280, (3, 30, 2)).astype(
        np.float32)
    for z_top in (2000.0, 1700.0):
        got = back_projection_line(tcams.expand(1), torch.tensor(uv), z_top)
        ref = jax.vmap(lambda c, p: jax_tsai.back_projection_line(
            c, p, z_top))(jcams, jnp.asarray(uv))
        for g, r in zip(got, ref):
            _close(g, r)


def _nview_case(seed, b=24, n=4):
    """Lines through noisy common points, with masks holding every count
    of valid lines from 0 to n."""
    rng = np.random.RandomState(seed)
    target = rng.uniform(-4000, 4000, (b, 1, 3)) * [1, 1, 0.25]
    origins = rng.uniform(-8000, 8000, (b, n, 3)) * [1, 1, 0.2] + [0, 0, 2500]
    bottoms = origins + 2.0 * (target - origins) \
        + rng.normal(0, 30, (b, n, 3))
    mask = rng.rand(b, n) < 0.6
    mask[:n + 1] = np.arange(n)[None, :] < np.arange(n + 1)[:, None]
    return (origins.astype(np.float32), bottoms.astype(np.float32), mask)


@pytest.mark.parametrize("seed", [0, 1])
def test_nview_point_reconstruction(seed):
    a, b, mask = _nview_case(seed)
    got = nview_point_reconstruction(torch.tensor(a), torch.tensor(b),
                                     torch.tensor(mask))
    ref = jax_tri.nview_point_reconstruction(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(mask))
    _close(got[0], ref[0], rtol=0, atol=1e-2)           # mm
    _close(got[1], ref[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_nview_point_masked_fallback():
    """tests/test_geometry.py's one-valid-line case: the first valid
    line's second point, distance 0."""
    tops = np.zeros((3, 3), np.float32)
    bottoms = np.asarray([[1.0, 2.0, 0.0], [5.0, 6.0, 0.0],
                          [7.0, 8.0, 0.0]], np.float32)
    for m in ([True, False, False], [False, True, False]):
        mask = np.asarray(m)
        got = nview_point_reconstruction(torch.tensor(tops),
                                         torch.tensor(bottoms),
                                         torch.tensor(mask))
        ref = jax_tri.nview_point_reconstruction(
            jnp.asarray(tops), jnp.asarray(bottoms), jnp.asarray(mask))
        _close(got[0], ref[0], rtol=0, atol=1e-6)
        assert float(got[1]) == float(ref[1]) == 0.0
        assert int(got[2]) == int(ref[2]) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_nview_ground_reconstruction(seed):
    _, b, mask = _nview_case(seed)
    b[..., 2] = 0.0
    got = nview_ground_reconstruction(torch.tensor(b), torch.tensor(mask))
    ref = jax_tri.nview_ground_reconstruction(jnp.asarray(b),
                                              jnp.asarray(mask))
    _close(got[0], ref[0], rtol=0, atol=1e-2)
    _close(got[1], ref[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


# ---- blur, smoothing -------------------------------------------------------

def test_gaussian_blur_3x3():
    img = np.random.RandomState(1).rand(2, 40, 56).astype(np.float32)
    _close(gaussian_blur_3x3(torch.tensor(img)),
           jax_pyramid.gaussian_blur_3x3(jnp.asarray(img)), rtol=0,
           atol=1e-6)


@pytest.mark.parametrize("n", [1, 4, 9, 23])
def test_sg_smooth(n):
    rng = np.random.RandomState(n)
    for shape in ((n,), (n, 3)):
        data = rng.rand(*shape).astype(np.float32)
        _close(sg_smooth(torch.tensor(data)),
               jax_sg.sg_smooth(jnp.asarray(data)), rtol=0, atol=1e-6)


# ---- appearance ------------------------------------------------------------

def _hist_case(seed, dtype):
    rng = np.random.RandomState(seed)
    h, w = 120, 160
    if dtype == np.uint8:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    else:
        img = rng.rand(h, w, 3).astype(np.float32)
        img[:5] = 1.0                            # the top bin's clip
    boxes = np.concatenate([
        rng.uniform(-20, 150, (12, 2)), rng.uniform(0.5, 80, (12, 2))],
        -1).astype(np.float32)
    return img, boxes


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_histogram_exact(dtype):
    img, boxes = _hist_case(3, dtype)
    got = rgb_histogram(torch.tensor(img), torch.tensor(boxes)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_hist.rgb_histogram(jnp.asarray(img),
                                               jnp.asarray(boxes))))
    np.testing.assert_array_equal(got, host_rgb_histogram(img, boxes))
    assert got.dtype == np.float32 and got.shape == (12, 48)


def test_rgb_cost():
    rng = np.random.RandomState(4)
    f1 = rng.rand(20, 48).astype(np.float32) * 0.3
    f2 = rng.rand(20, 48).astype(np.float32) * 0.3
    for gap in (1.0, 3.0, np.arange(20, dtype=np.float32) + 1):
        _close(rgb_cost(torch.tensor(f1), torch.tensor(f2),
                        torch.as_tensor(gap)),
               jax_hist.rgb_cost(jnp.asarray(f1), jnp.asarray(f2),
                                 jnp.asarray(gap)), atol=1e-6)


# ---- cost terms ------------------------------------------------------------

def test_enter_exit_scenes():
    """The scenes of tests/test_costs.py::TestEnterExit."""
    for d in (5000.0, 100.0, -100.0, 800.0):
        for free in (False, True):
            _close(enter_probability(torch.tensor(d), torch.tensor(free),
                                     CFG),
                   jax_costs.enter_probability(jnp.asarray(d),
                                               jnp.asarray(free), CFG),
                   atol=1e-6)
        _close(exit_cost(torch.tensor(d), torch.tensor(10.0), CFG),
               jax_costs.exit_cost(jnp.asarray(d), jnp.asarray(10.0), CFG),
               atol=1e-6)


def test_enter_exit_batched():
    rng = np.random.RandomState(5)
    d = rng.uniform(-500, 6000, 64).astype(np.float32)
    free = rng.rand(64) < 0.3
    length = rng.randint(0, 40, 64).astype(np.float32)
    _close(enter_probability(torch.tensor(d), torch.tensor(free), CFG),
           jax_costs.enter_probability(jnp.asarray(d), jnp.asarray(free),
                                       CFG), atol=1e-6)
    _close(exit_cost(torch.tensor(d), torch.tensor(length), CFG),
           jax_costs.exit_cost(jnp.asarray(d), jnp.asarray(length), CFG),
           atol=1e-6)


def test_tracklet_connectivity():
    """tests/test_costs.py::TestConnectivity, then a batch."""
    a = np.zeros(3, np.float32)
    for b, gap in (([1000.0, 0, 0], 1), ([3000.0, 0, 0], 1),
                   ([3000.0, 0, 0], 3)):
        b = np.asarray(b, np.float32)
        assert bool(tracklet_connectivity(torch.tensor(a), torch.tensor(b),
                                          1.0, 1.0, gap, CFG)) == bool(
            jax_costs.tracklet_connectivity(jnp.asarray(a), jnp.asarray(b),
                                            1.0, 1.0, gap, CFG))
    rng = np.random.RandomState(6)
    e = rng.uniform(-3000, 3000, (50, 3)).astype(np.float32)
    s = rng.uniform(-3000, 3000, (50, 3)).astype(np.float32)
    s1 = rng.uniform(0, 400, 50).astype(np.float32)
    s2 = rng.uniform(0, 400, 50).astype(np.float32)
    gap = rng.randint(1, 4, 50)
    got = tracklet_connectivity(*map(torch.tensor, (e, s, s1, s2, gap)), CFG)
    ref = jax_costs.tracklet_connectivity(*map(jnp.asarray,
                                               (e, s, s1, s2, gap)), CFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---- assignment ------------------------------------------------------------

def _tie_heavy(rng, c, r, t):
    cost = rng.choice([0.0, 1.0, 2.0, 2.5, np.inf], (c, r, t),
                      p=[0.2, 0.2, 0.2, 0.1, 0.3]).astype(np.float32)
    return cost, rng.rand(c, r) < 0.85, rng.rand(c, t) < 0.85


def test_hungarian_host():
    rng = np.random.RandomState(7)
    for r, t in ((5, 7), (6, 6), (8, 5)):
        cost, _, _ = _tie_heavy(rng, 1, r, t)
        cost[0, 0] = np.inf
        got = hungarian_host(cost[0])
        ref = jax_hungarian.hungarian_host(cost[0])
        for g, f in zip(got, ref):
            np.testing.assert_array_equal(g, f)
    assert [len(x) for x in hungarian_host(np.full((3, 3), np.inf))] == [0, 0]


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 6, 6), (4, 8, 5)])
def test_assignment_names_match_jax(shape):
    """solve_assignment takes one [R, T] matrix and solve_assignment_batch
    a [C, R, T] stack, as in the JAX package (hungarian.py:55, :172)."""
    rng = np.random.RandomState(sum(shape))
    cost, rmask, cmask = _tie_heavy(rng, *shape)
    got_b = solve_assignment_batch(cost, rmask, cmask)
    ref_b = jax_hungarian.solve_assignment_batch(
        jnp.asarray(cost), jnp.asarray(rmask), jnp.asarray(cmask))
    for g, f in zip(got_b, ref_b):
        np.testing.assert_array_equal(g, np.asarray(f))
    for ci in range(shape[0]):
        got = solve_assignment(cost[ci], rmask[ci], cmask[ci])
        ref = jax_hungarian.solve_assignment(
            jnp.asarray(cost[ci]), jnp.asarray(rmask[ci]),
            jnp.asarray(cmask[ci]))
        for g, f in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(f))
            assert g.shape == (shape[1],)


# ---- pyramidal LK ----------------------------------------------------------

def test_lk_track_pyramid_matches_jax():
    """3 levels of a 96x256 pair: the two finer levels take the LK level
    kernel's route (plain version here; the Pallas kernel in interpret mode
    on the JAX side), the 24x64 level the gather path on both sides."""
    from test_lk_pallas import _scene
    rng = np.random.RandomState(12)
    prev, nxt = _scene(rng, h=96, w=256, shift=(2.1, -1.3))
    n = 32
    pts = np.stack([rng.uniform(20, 236, n), rng.uniform(16, 80, n)],
                   -1).astype(np.float32)
    act = rng.rand(n) < 0.8
    kw = dict(levels=3, window=8, iterations=6)
    with pallas_interpret():
        ref = jax_lk.lk_track_pyramid(jnp.asarray(prev), jnp.asarray(nxt),
                                      jnp.asarray(pts),
                                      active=jnp.asarray(act), **kw)
    lk_level.launches = 0
    got = lk_track_pyramid(torch.tensor(prev), torch.tensor(nxt),
                           torch.tensor(pts), active=torch.tensor(act), **kw)
    assert lk_level.launches == 0          # CPU tensors: the plain version
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _close(got[0], ref[0], rtol=0, atol=1e-3)
    _close(got[2], ref[2], rtol=0, atol=1e-5)
    assert got[1].sum() >= n // 2 and not got[1][~torch.tensor(act)].any()


# ---- clique solver ---------------------------------------------------------

class _Fixed:
    """A field source handing out one solve's precomputed fields."""

    def __init__(self, fields):
        self.fields = fields

    def draw(self, r, v, iters_pad, device):
        return to_torch_fields(self.fields, device)


def _instances(rng, b, v, n):
    weights = np.zeros((b, v), np.float32)
    weights[:, :n] = rng.rand(b, n) * 10
    up = np.triu(rng.rand(b, v, v) < 0.5, 1)
    adj = up | up.transpose(0, 2, 1)
    valid = np.zeros((b, v), bool)
    valid[:, :n] = True
    adj &= valid[:, :, None] & valid[:, None, :]
    init = np.zeros((b, v), bool)
    init[1, :3] = True                          # not a clique: cold start
    return weights, adj, valid, init


def test_solve_mwcp_batch_and_k_best():
    rng = np.random.RandomState(9)
    b, v, n, iters = 3, 32, 28, 60
    cfg = SolverConfig(num_replicas=4, max_vertices=v,
                       solutions_per_replica=6)
    weights, adj, valid, init = _instances(rng, b, v, n)
    keys = jax.random.split(jax.random.PRNGKey(21), b)
    ref = jax_mwcp.solve_mwcp_batch(
        jnp.asarray(weights), jnp.asarray(adj), jnp.asarray(valid),
        jnp.asarray(init), keys, cfg, iters)
    got = solve_mwcp_batch(
        torch.tensor(weights), torch.tensor(adj), torch.tensor(valid),
        torch.tensor(init),
        [_Fixed(jax_mwcp_fields(k, cfg.num_replicas, v, iters))
         for k in keys], cfg, iters)
    for f in ("best_mask", "sol_masks"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    for f in ("best_score", "sol_scores"):
        _close(getattr(got, f), getattr(ref, f), rtol=0, atol=1e-4)

    for i in range(b):
        one = type(got)(*[x[i] for x in got])
        gm, gs = collect_k_best(one, 5)
        rm, rs = jax_mwcp.collect_k_best(
            jax_mwcp.MwcpResult(*[x[i] for x in ref]), 5)
        assert len(gm) == len(rm) > 0
        for x, y in zip(gm, rm):
            np.testing.assert_array_equal(x, y)
        _close(gs, rs, rtol=0, atol=1e-4)


def test_k_best_host_equals_device_lists():
    """collect_k_best on hand-made rings equals the JAX copy's lists
    exactly (duplicates, empty slots, equal scores)."""
    rng = np.random.RandomState(10)
    masks = rng.rand(3, 5, 24) < 0.3
    masks[1, 2] = masks[0, 0]
    scores = rng.choice([5.0, 7.0, -1e30], (3, 5)).astype(np.float32)
    scores[1, 2] = scores[0, 0] = 7.0
    for k in (3, 20):
        gm, gs = collect_k_best(
            MwcpResult(None, None, torch.tensor(masks),
                       torch.tensor(scores)), k)
        rm, rs = jax_mwcp.collect_k_best(
            jax_mwcp.MwcpResult(None, None, masks, scores), k)
        assert gs == rs
        assert all(np.array_equal(x, y) for x, y in zip(gm, rm))


# ---- single-camera 2D step -------------------------------------------------

def test_single_camera_step_equals_camera_slices():
    """make_tracker2d_step(cfg) on each camera alone gives the slices of
    the multi-camera step's state and outputs (the cameras are
    independent, which the camera-split mesh engine relies on)."""
    cfg = Tracker2DConfig(max_detections=8, max_trackers=16, max_features=16,
                          lk_window=8, lk_pyramid_levels=2, lk_iterations=4)
    sc = make_scenario(num_cameras=2, num_frames=4, num_people=3,
                       image_size=(128, 96), arena=3000.0, seed=5)
    cams = stack_cameras(sc.cameras, "cpu")
    multi = make_tracker2d_step(cfg, multi_camera=True)
    single = make_tracker2d_step(cfg)
    state = init_tracker2d_state(cfg, 96, 128, 2, device="cpu")
    singles = [init_tracker2d_state(cfg, 96, 128, device="cpu")
               for _ in range(2)]
    assert singles[0].frames.shape == (cfg.backtrack_interval, 96, 128)
    for t in range(4):
        gray = torch.tensor(np.stack(sc.frames(t)).mean(-1),
                            dtype=torch.float32)
        dets = [pad_dets(sc.detections[t][c], 8) for c in range(2)]
        det = torch.tensor(np.stack([d[0] for d in dets]))
        mask = torch.tensor(np.stack([d[1] for d in dets]))
        state, out = multi(state, gray, det, mask, cams, t)
        for c in range(2):
            cam = type(cams)(*[f[c] for f in cams])
            singles[c], o = single(singles[c], gray[c], det[c], mask[c],
                                   cam, t)
            for f in out._fields:
                np.testing.assert_array_equal(getattr(o, f).numpy(),
                                              getattr(out, f)[c].numpy())
    assert int(state.next_id.sum()) > 0
