"""The port against the JAX engine beyond the toy scenes: the faults the
bench scene exposed, each at the smallest input that shows it, and a
mid-size pipelined scene that reaches what the 2-camera scenes do not
(a warm-started K=30 solve over 38 replicas, a rank-pruned vertex pool,
f16-rounded smoothed positions feeding the compatibility grid).

Faults (ROADMAP.md, Queue 3):
- the BLS swap-partner product multiplied the membership mask by the
  weights, so a pool track of infinite cost (weight -inf, outside the
  graph) put NaN into every partner weight (0 * -inf); XLA rewrites the
  JAX package's multiply into a select;
- replica 0's greedy order scaled its noise by 0 * max|w|, NaN when a
  weight is infinite; the JAX package orders replica 0 by the weights;
- the window smoothing summed its products in another order than XLA's
  CPU dot, so a smoothed position could round to another float16 and
  move a track's grid point by one f16 step.

The mid-size scene: 4 cameras at 384x288, 16 people, K=30, 8 + 30
replicas, 150 BLS iterations, 128 solver vertices (the pool overflows),
12 frames, pipelined; the JAX engine on its CPU gather LK against the
port with MCMTT_LK_BACKEND=xla on its default solver stream.  The 2D
handoff must be equal, every frame's 3D ids equal with points within
1 mm, and the MOTA at windows 0/3/6 equal.

The slow case rebuilds mcmtt_opticalflow_tpu_torch/bench_reference.json
(tests/bench_reference.py) and holds it against the file."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu import config as jcfg
from mcmtt_opticalflow_tpu.data import make_scenario
from mcmtt_opticalflow_tpu.eval import ClearMotAccumulator
from mcmtt_opticalflow_tpu.models import mwcp as jmwcp
from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine as JaxEngine
from mcmtt_opticalflow_tpu.ops import sgsmooth as jsg
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario as t_make_scenario
from mcmtt_opticalflow_tpu_torch.models import mwcp as tmwcp
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.ops import sgsmooth as tsg
from mcmtt_opticalflow_tpu_torch.utils import prng

torch.set_num_threads(2)

POINT_ATOL_MM = 1.0
WINDOWS = (0, 3, 6)


def _instance(v, seed, density=0.5):
    rng = np.random.RandomState(seed)
    w = (rng.rand(v) * 10).astype(np.float32)
    up = np.triu(rng.rand(v, v) < density, 1)
    return w, up | up.T


def _both_solves(w, adj, valid, init, r, iters, seed=0):
    v = len(w)
    jc = jcfg.SolverConfig(num_replicas=r, max_vertices=v,
                           solutions_per_replica=4)
    tc = tcfg.SolverConfig(num_replicas=r, max_vertices=v,
                           solutions_per_replica=4)
    want = jmwcp.solve_mwcp(jnp.asarray(w), jnp.asarray(adj),
                            jnp.asarray(valid), jnp.asarray(init),
                            jax.random.PRNGKey(seed), jc, iters)
    got = tmwcp.solve_mwcp(torch.tensor(w), torch.tensor(adj),
                           torch.tensor(valid), torch.tensor(init),
                           prng.prng_key(seed), tc, iters)
    return want, got


def test_infinite_weight_outside_the_graph():
    """A -inf weight on an invalid vertex leaves the solve as it is."""
    v, r = 24, 4
    w, adj = _instance(v, 1)
    valid = np.ones(v, bool)
    valid[-3:] = False
    w[-1] = -np.inf
    adj[:, ~valid] = adj[~valid, :] = False
    init = np.zeros((r, v), bool)
    want, got = _both_solves(w, adj, valid, init, r, 60)
    assert np.isfinite(got.best_score.numpy()).all()
    np.testing.assert_array_equal(got.sol_masks.numpy(),
                                  np.asarray(want.sol_masks))
    np.testing.assert_array_equal(got.best_mask.numpy(),
                                  np.asarray(want.best_mask))


def test_replica0_keeps_the_weight_order_with_an_infinite_weight():
    """No warm start is a clique, a weight is -inf: replica 0 starts from
    the weight-ordered greedy clique, as in the JAX package."""
    v, r = 24, 3
    w, adj = _instance(v, 2)
    valid = np.ones(v, bool)
    valid[-1] = False
    w[-1] = -np.inf
    adj[:, -1] = adj[-1, :] = False
    init = np.zeros((r, v), bool)
    want, got = _both_solves(w, adj, valid, init, r, 1)
    # the first ring slot of each replica holds its initial solution
    np.testing.assert_array_equal(got.sol_masks[:, 0].numpy(),
                                  np.asarray(want.sol_masks)[:, 0])
    assert got.sol_masks[0, 0].any()


@pytest.mark.parametrize("t", [16, 20])
def test_smoothing_bit_equal_to_jax_cpu(t):
    """Bench-like windows (mm-scale positions, lengths 1..t): the float32
    smoothed positions equal the JAX package's jitted CPU result bit for
    bit (the host rounds them to float16)."""
    rng = np.random.RandomState(t)
    b = 512
    pts = (rng.rand(b, t, 3) * 18000.0 - 9000.0).astype(np.float32)
    lens = rng.randint(1, t + 1, size=b).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, n: jsg.sg_smooth_masked(p, n, 9, 1))(
        pts, lens))
    got = tsg.sg_smooth_masked(torch.tensor(pts), torch.tensor(lens), 9, 1)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- engine
NUM_FRAMES = 12


def _mid_cfg(mod):
    return mod.EngineConfig(
        num_cameras=4, image_width=384, image_height=288,
        tracker2d=mod.Tracker2DConfig(lk_pyramid_levels=2, lk_iterations=8,
                                      max_detections=24, max_trackers=32,
                                      max_features=36),
        assoc3d=mod.Associator3DConfig(k_best_size=30),
        solver=mod.SolverConfig(num_replicas=8, max_vertices=128,
                                max_iterations=150))


def _mid_scene(make):
    return make(num_cameras=4, num_frames=NUM_FRAMES, num_people=16,
                image_size=(384, 288), arena=6000.0, noise_px=1.0,
                fp_rate=0.10, fn_rate=0.05, seed=3)


def _run(eng, sc, frames):
    """Pipelined engine over the scene with bench.py's harvest: (2D
    handoff per frame, final result per frame, MOTA per window)."""
    seen = {}
    a = eng.assoc
    for name in ("step_begin", "step"):
        orig = getattr(a, name)

        def rec(frame_idx, ids, boxes, mask, rgb, _o=orig):
            seen[frame_idx] = (np.array(ids), np.array(boxes),
                               np.array(mask))
            return _o(frame_idx, ids, boxes, mask, rgb)
        setattr(a, name, rec)
    gx, gy = sc.gt_matrices()
    zone = (-6000.0, -6000.0, 6000.0, 6000.0)
    accs = {w: ClearMotAccumulator(gx, gy, zone, 1000.0) for w in WINDOWS}
    done = -1

    def put(w, td):
        r = eng.deferred_result(td)
        accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                zip(r.ids, r.points)])

    def harvest():
        nonlocal done
        while done < a.completed_frame:
            done += 1
            for w in WINDOWS:
                if done - w >= 0:
                    put(w, done - w)
    for t in range(NUM_FRAMES):
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
        harvest()
    while eng.flush() is not None:
        harvest()
    for w in WINDOWS:
        for td in range(max(done - w + 1, 0), done + 1):
            put(w, td)
    res = [eng.deferred_result(t) for t in range(NUM_FRAMES)]
    return seen, res, [accs[w].evaluate().mota for w in WINDOWS]


@pytest.fixture(scope="module")
def mid_runs():
    sc = _mid_scene(make_scenario)
    frames = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
              .astype(np.uint8) for t in range(NUM_FRAMES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MCMTT_LK_BACKEND", raising=False)
        jeng = JaxEngine(_mid_cfg(jcfg), sc.cameras, pipelined=True)
        jout = _run(jeng, sc, frames)
    tsc = _mid_scene(t_make_scenario)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        teng = TrackingEngine(_mid_cfg(tcfg), tsc.cameras, pipelined=True,
                              device="cpu")
        tout = _run(teng, tsc, frames)
    return jeng, jout, teng, tout


def test_mid_scene_reaches_the_bench_paths(mid_runs):
    jeng, _, teng, _ = mid_runs
    assert jeng.assoc.pool_dropped_total > 0
    assert teng.assoc.pool_dropped_total == jeng.assoc.pool_dropped_total


def test_mid_scene_2d_handoff_equal(mid_runs):
    _, (jseen, _, _), _, (tseen, _, _) = mid_runs
    assert sorted(jseen) == sorted(tseen) == list(range(NUM_FRAMES))
    for t in range(NUM_FRAMES):
        j, g = jseen[t], tseen[t]
        np.testing.assert_array_equal(g[2], j[2], err_msg=f"mask, frame {t}")
        m = j[2]
        np.testing.assert_array_equal(g[0][m], j[0][m],
                                      err_msg=f"ids, frame {t}")
        np.testing.assert_allclose(g[1][m], j[1][m], rtol=0, atol=1e-3,
                                   err_msg=f"boxes, frame {t}")


def test_mid_scene_3d_results_equal(mid_runs):
    _, (_, jres, _), _, (_, tres, _) = mid_runs
    for t, (j, g) in enumerate(zip(jres, tres)):
        assert j.ids == g.ids, f"first divergent frame {t}"
        np.testing.assert_allclose(np.reshape(g.points, (-1, 3)),
                                   np.reshape(j.points, (-1, 3)), rtol=0,
                                   atol=POINT_ATOL_MM, err_msg=f"frame {t}")
    assert sum(len(r.ids) for r in tres) > NUM_FRAMES


def test_mid_scene_mota_equal(mid_runs):
    _, (_, _, jm), _, (_, _, tm) = mid_runs
    assert jm[0] > 0.0
    assert tm == jm


# ----------------------------------------------------------------- slow
def _by_id(frame):
    return dict(zip(frame["ids"], map(tuple, frame["points"])))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["jax", "xla", "plain"])
def test_bench_reference_rebuilds(name):
    """Rebuild one run of the record (~3 min, ~3.5 min and ~15 min on the
    CPU) and hold it against the file: triple, tracks_peak, pool_dropped
    equal; every frame's ids equal, points within 0.1 mm of the rounded
    ones.  The `xla` run also equals the `jax` record frame by frame."""
    import bench_reference
    with open(bench_reference.OUT) as f:
        ref = json.load(f)
    got = bench_reference.build(name)
    want = ref[name]
    for k in ("mota", "tracks_peak", "pool_dropped"):
        assert got[k] == want[k], k
    for runs in ((got, want),) + (((got, ref["jax"]),) if name == "xla"
                                  else ()):
        for g, w in zip(*[r["frames"] for r in runs]):
            gd, wd = _by_id(g), _by_id(w)
            assert sorted(gd) == sorted(wd), f"frame {g['frame']}"
            for i in gd:
                np.testing.assert_allclose(gd[i], wd[i], rtol=0, atol=0.1)
    assert os.path.basename(bench_reference.OUT) == "bench_reference.json"
