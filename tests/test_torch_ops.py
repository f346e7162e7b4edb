"""Parity of the port's device ops and host solvers against the JAX
package on the same numpy inputs: pyramid, features, geometry, side-maps,
SG smoothing, the window cost model (allclose at rtol 1e-5), the 2D
assignment (exact, under hypothesis) and the BLS clique solver with the
JAX package's random fields injected (identical masks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from mcmtt_opticalflow_tpu.config import Associator3DConfig, SolverConfig
from mcmtt_opticalflow_tpu.data import make_scenario as jax_make_scenario
from mcmtt_opticalflow_tpu.geometry import sidemaps as jax_sidemaps
from mcmtt_opticalflow_tpu.geometry import tsai as jax_tsai
from mcmtt_opticalflow_tpu.geometry import triangulation as jax_tri
from mcmtt_opticalflow_tpu.models import costs as jax_costs
from mcmtt_opticalflow_tpu.models import mwcp as jax_mwcp
from mcmtt_opticalflow_tpu.ops import features as jax_features
from mcmtt_opticalflow_tpu.ops import hungarian as jax_hungarian
from mcmtt_opticalflow_tpu.ops import pyramid as jax_pyramid
from mcmtt_opticalflow_tpu.ops import sgsmooth as jax_sg
from mcmtt_opticalflow_tpu_torch import convert
from mcmtt_opticalflow_tpu_torch.geometry import sidemaps, tsai, triangulation
from mcmtt_opticalflow_tpu_torch.models import costs, mwcp
from mcmtt_opticalflow_tpu_torch.ops import features, hungarian, pyramid
from mcmtt_opticalflow_tpu_torch.ops import sgsmooth
from torch_parity import jax_mwcp_fields, to_torch_fields

torch.set_num_threads(2)

RTOL = 1e-5


def _close(got, ref, rtol=RTOL, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def cams():
    """The same ring cameras in both packages: JAX stacked, port stacked
    (carried over through convert.py)."""
    sc = jax_make_scenario(num_cameras=3, num_frames=2, num_people=2,
                           image_size=(256, 192), seed=4)
    jcams = jax_tsai.stack_cameras(sc.cameras)
    fields = {f: np.asarray(getattr(jcams, f)) for f in jcams._fields}
    tcams = convert.camera_from_numpy(fields)
    back = convert.camera_to_numpy(tcams)
    for f in fields:
        np.testing.assert_array_equal(back[f], fields[f])
    return sc.cameras, jcams, tcams


def test_pyramid_and_gradients():
    rng = np.random.RandomState(0)
    img = rng.rand(2, 64, 96).astype(np.float32)
    ref = jax_pyramid.build_pyramid(jnp.asarray(img), 3)
    got = pyramid.build_pyramid(torch.tensor(img), 3)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close(g, r)
    for g, r in zip(pyramid.image_gradients(torch.tensor(img)),
                    jax_pyramid.image_gradients(jnp.asarray(img))):
        _close(g, r)


def test_grid_features():
    rng = np.random.RandomState(1)
    img = rng.rand(2, 96, 128).astype(np.float32)
    img = np.cumsum(np.cumsum(img, 1), 2) / 50.0 % 1.0   # corner-rich
    boxes = np.asarray([[[10, 12, 30, 50], [-5, 40, 20, 60],
                         [100, 70, 40, 40], [50, 5, 1, 1]],
                        [[0, 0, 127, 95], [60, 30, 16, 16],
                         [20, 20, 30, 30], [90, 60, 10, 70]]], np.float32)
    mask = np.asarray([[True, True, True, False], [True, True, False, True]])
    fn = jax.vmap(lambda i, b, m: jax_features.detect_grid_features(
        i, b, m, grid=4, sub=2, quality=0.01))
    rp, rv = fn(jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(mask))
    gp, gv = features.detect_grid_features(
        torch.tensor(img), torch.tensor(boxes), torch.tensor(mask), grid=4,
        sub=2, quality=0.01)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))


def test_projections(cams):
    _, jcams, tcams = cams
    rng = np.random.RandomState(2)
    pts3 = np.concatenate([rng.uniform(-6000, 6000, (3, 40, 2)),
                           rng.uniform(0, 2000, (3, 40, 1))],
                          -1).astype(np.float32)
    uv = rng.uniform(-50, 300, (3, 40, 2)).astype(np.float32)
    ex = tcams.expand(1)
    # 0.5 px: at kappa1=1e-9 the float32 Cardano root is s + t with
    # |s|, |t| ~ 1e4 x the result, so a 1-ulp cube-root difference moves
    # the projection by ~0.2 px (XLA's own cbrt is up to 5 ulp off)
    _close(tsai.world_to_image(ex, torch.tensor(pts3)),
           jax.vmap(jax_tsai.world_to_image)(jcams, jnp.asarray(pts3)),
           atol=0.5)
    for z in (0.0, 2000.0):
        _close(tsai.image_to_world(ex, torch.tensor(uv), z),
               jax.vmap(lambda c, p: jax_tsai.image_to_world(c, p, z))(
                   jcams, jnp.asarray(uv)), atol=1e-2)
    vis_g = tsai.check_visibility(ex, torch.tensor(pts3)).numpy()
    vis_r = np.asarray(jax.vmap(jax_tsai.check_visibility)(
        jcams, jnp.asarray(pts3)))
    assert (vis_g != vis_r).mean() <= 0.02


def test_triangulation():
    rng = np.random.RandomState(3)
    p = rng.uniform(-100, 100, (4, 32, 3)).astype(np.float32)
    p[3, :4] = p[2, :4] + (p[1, :4] - p[0, :4])    # parallel lines
    mid_g, gap_g = triangulation.triangulate_two_lines(
        *[torch.tensor(x) for x in p])
    mid_r, gap_r = jax_tri.triangulate_two_lines(*[jnp.asarray(x) for x in p])
    _close(mid_g, mid_r, atol=1e-3)
    _close(gap_g, gap_r, atol=1e-3)
    s = rng.uniform(0, 10, (4, 64, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        triangulation.segments_intersect(*[torch.tensor(x) for x in s]),
        np.asarray(jax_tri.segments_intersect(*[jnp.asarray(x) for x in s])))


def test_sidemaps_equal(cams):
    host_cams, _, tcams = cams
    tcam0 = convert.camera_from_numpy(
        {f: np.asarray(getattr(host_cams[0], f)) for f in tcams._fields})
    for name in ("projection_sensitivity_map", "distance_from_boundary_map"):
        np.testing.assert_array_equal(
            getattr(sidemaps, name)(tcam0, 256, 192, 4),
            getattr(jax_sidemaps, name)(host_cams[0], 256, 192, 4))


def test_sg_smooth_masked():
    rng = np.random.RandomState(4)
    data = rng.uniform(-3000, 3000, (12, 20, 3)).astype(np.float32)
    lens = np.asarray([0, 1, 2, 3, 4, 5, 8, 9, 10, 15, 19, 20], np.int32)
    _close(sgsmooth.sg_smooth_masked(torch.tensor(data), torch.tensor(lens)),
           jax_sg.sg_smooth_masked(jnp.asarray(data), jnp.asarray(lens)),
           atol=1e-2)


def test_score_track_windows(cams):
    _, jcams, tcams = cams
    rng = np.random.RandomState(5)
    n, w, c = 16, 12, 3
    base = rng.uniform(-4000, 4000, (n, 1, 3))
    base[..., 2] = 0.0
    walk = np.cumsum(rng.normal(0, 150, (n, w, 3)) * [1, 1, 0], 1)
    pts = (base + walk).astype(np.float32)
    raws = (pts[:, :, None] + rng.normal(0, 120, (n, w, c, 3)) * [1, 1, 0]
            ).astype(np.float32)
    raws[3, 4, 1] += 5000.0                  # invalidating scatter
    rmask = rng.rand(n, w, c) < 0.7
    merr = rng.choice([0.0, 400.0, 900.0], (n, w)).astype(np.float32)
    lens = rng.randint(0, w + 1, n).astype(np.int32)
    cfg = Associator3DConfig()
    ref = jax_costs.score_track_windows(
        jnp.asarray(pts), jnp.asarray(raws), jnp.asarray(rmask),
        jnp.asarray(merr), jnp.asarray(lens), jcams, cfg)
    got = costs.score_track_windows(
        torch.tensor(pts), torch.tensor(raws), torch.tensor(rmask),
        torch.tensor(merr), torch.tensor(lens), tcams, cfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for f in ("smoothed", "velocity"):
        _close(getattr(got, f), getattr(ref, f), atol=1e-2)
    for f in ("cost_recon", "cost_link", "window_cost"):
        _close(getattr(got, f), getattr(ref, f), atol=1e-4)


# ---- 2D assignment: exact equality ----------------------------------------

_jax_assign = jax.jit(jax.vmap(jax_hungarian.solve_assignment))


def _check_assignment(cost, rmask, cmask):
    ref_c, ref_m = _jax_assign(jnp.asarray(cost), jnp.asarray(rmask),
                               jnp.asarray(cmask))
    got_c, got_m = hungarian.solve_assignment_batch(cost, rmask, cmask)
    np.testing.assert_array_equal(got_c, np.asarray(ref_c))
    np.testing.assert_array_equal(got_m, np.asarray(ref_m))


_SHAPES = [(3, 5, 7), (2, 6, 6), (4, 8, 5)]


@st.composite
def _assignment_case(draw, ties):
    c, r, t = draw(st.sampled_from(_SHAPES))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.RandomState(seed)
    if ties:   # few distinct values, many infinities
        cost = rng.choice([0.0, 1.0, 2.0, 2.5, np.inf], (c, r, t),
                          p=[0.2, 0.2, 0.2, 0.1, 0.3]).astype(np.float32)
    else:
        cost = (rng.rand(c, r, t) * 10 ** rng.uniform(-2, 3)).astype(
            np.float32)
        cost[rng.rand(c, r, t) < 0.2] = np.inf
    rmask = rng.rand(c, r) < 0.85
    cmask = rng.rand(c, t) < 0.85
    return cost, rmask, cmask


@settings(max_examples=30, deadline=None, database=None)
@given(_assignment_case(ties=False))
def test_assignment_random_matches_jax(case):
    _check_assignment(*case)


@settings(max_examples=30, deadline=None, database=None)
@given(_assignment_case(ties=True))
def test_assignment_ties_and_inf_match_jax(case):
    _check_assignment(*case)


def test_assignment_tracker_shape():
    """The tracker's [C, D, T] shape with every column forbidden in one
    camera and a fully masked camera."""
    rng = np.random.RandomState(9)
    cost = (rng.rand(4, 16, 32) * 3).astype(np.float32)
    cost[1] = np.inf
    rmask = rng.rand(4, 16) < 0.6
    rmask[2] = False
    cmask = rng.rand(4, 32) < 0.7
    _check_assignment(cost, rmask, cmask)


# ---- BLS clique solver with the JAX package's random fields ---------------

def _instance(rng, n, v, p_edge):
    weights = np.zeros(v, np.float32)
    weights[:n] = rng.rand(n).astype(np.float32) * 10
    up = np.triu(rng.rand(v, v) < p_edge, 1)
    adj = up | up.T
    adj[n:] = False
    adj[:, n:] = False
    valid = np.zeros(v, bool)
    valid[:n] = True
    return weights, adj, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mwcp_with_jax_fields(seed):
    rng = np.random.RandomState(seed)
    v, n = 48, 40
    cfg = SolverConfig(num_replicas=6, max_vertices=v,
                       solutions_per_replica=8, seed=seed)
    weights, adj, valid = _instance(rng, n, v, 0.45)
    # warm starts: a real clique, a non-clique and an empty row
    init = np.zeros((3, v), bool)
    init[0, 0] = True
    for u in range(1, n):
        if adj[u, init[0]].all():
            init[0, u] = True
    init[1, :5] = True
    iters = 90
    key = jax.random.PRNGKey(100 + seed)
    ref = jax_mwcp.solve_mwcp(jnp.asarray(weights), jnp.asarray(adj),
                              jnp.asarray(valid), jnp.asarray(init), key,
                              cfg, iters)
    fields = jax_mwcp_fields(key, cfg.num_replicas, v, iters)

    class Fixed:
        def draw(self, r, v_, iters_pad, device):
            assert (r, v_, iters_pad) == (cfg.num_replicas, v, iters)
            return to_torch_fields(fields, device)

    got = mwcp.solve_mwcp(torch.tensor(weights), torch.tensor(adj),
                          torch.tensor(valid), torch.tensor(init), Fixed(),
                          cfg, iters)
    np.testing.assert_array_equal(got.best_mask.numpy(),
                                  np.asarray(ref.best_mask))
    np.testing.assert_array_equal(got.sol_masks.numpy(),
                                  np.asarray(ref.sol_masks))
    _close(got.best_score, ref.best_score, atol=1e-4)
    _close(got.sol_scores, ref.sol_scores, atol=1e-4)

    k = 7
    ref_m, ref_s = jax_mwcp.device_k_best(ref, k)
    got_m, got_s = mwcp.device_k_best(got, k)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    _close(got_s, ref_s, atol=1e-4)


def test_k_best_hash_ties():
    """Equal scores with different masks, duplicates and empty slots."""
    rng = np.random.RandomState(8)
    r, s, v = 3, 5, 40
    masks = rng.rand(r, s, v) < 0.3
    masks[1, 2] = masks[0, 0]
    scores = rng.choice([5.0, 7.0, -1e30], (r, s)).astype(np.float32)
    scores[1, 2] = scores[0, 0] = 7.0
    res_j = jax_mwcp.MwcpResult(None, None, jnp.asarray(masks),
                                jnp.asarray(scores))
    res_t = mwcp.MwcpResult(None, None, torch.tensor(masks),
                            torch.tensor(scores))
    for k in (4, 20):
        ref_m, ref_s = jax_mwcp.device_k_best(res_j, k)
        got_m, got_s = mwcp.device_k_best(res_t, k)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
