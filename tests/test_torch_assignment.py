"""The 2D assignment's tensor API (ops/hungarian.py: solve_assignment_batch
and solve_assignment over `jv_assign`, whose plain version runs for CPU
tensors) against the JAX package's jax.vmap(solve_assignment) on the same
seeded numpy inputs: exact equality of col_of_row and match_cost on the
random and tie-heavy generators of tests/test_torch_ops.py, on more rows
than columns, at the tracker's bench shape, at shapes whose working matrix
passes a block's 227 KB of shared memory, and on the [C, D, T] cost
matrices the 10-frame pipeline scene hands the assignment.  Also the
wrapper's checks, the work count behind the kernel's bound, and (on a
card only) the CUDA kernel against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.ops import hungarian as jax_hungarian
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models import tracker2d
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.ops import hungarian
from mcmtt_opticalflow_tpu_torch.ops.hungarian import (jv_assign,
                                                       jv_assign_reference,
                                                       jv_work,
                                                       solve_assignment,
                                                       solve_assignment_batch)
from torch_parity import cuda_device  # noqa: F401

torch.set_num_threads(2)

_jax_assign = jax.jit(jax.vmap(jax_hungarian.solve_assignment))


def _case(seed, shape, ties):
    """tests/test_torch_ops.py's generators: few distinct values and many
    infinities (ties), or costs over five decades with 20% forbidden."""
    rng = np.random.RandomState(seed)
    c, r, t = shape
    if ties:
        cost = rng.choice([0.0, 1.0, 2.0, 2.5, np.inf], (c, r, t),
                          p=[0.2, 0.2, 0.2, 0.1, 0.3]).astype(np.float32)
    else:
        cost = (rng.rand(c, r, t) * 10 ** rng.uniform(-2, 3)).astype(
            np.float32)
        cost[rng.rand(c, r, t) < 0.2] = np.inf
    return cost, rng.rand(c, r) < 0.85, rng.rand(c, t) < 0.85


def _check(cost, rmask, cmask):
    ref_c, ref_m = _jax_assign(jnp.asarray(cost), jnp.asarray(rmask),
                               jnp.asarray(cmask))
    got_c, got_m = solve_assignment_batch(torch.from_numpy(cost),
                                          torch.from_numpy(rmask),
                                          torch.from_numpy(cmask))
    assert got_c.dtype == torch.int32 and got_m.dtype == torch.float32
    assert got_c.device.type == got_m.device.type == "cpu"
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    return got_c


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 6, 6), (4, 16, 32),
                                   (4, 48, 64)])
@pytest.mark.parametrize("seed", range(3))
def test_tensor_api_equals_jax(seed, shape, ties):
    _check(*_case(seed, shape, ties))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(4, 8, 5), (2, 64, 48), (3, 9, 1)])
@pytest.mark.parametrize("seed", range(2))
def test_more_rows_than_columns_equals_jax(seed, shape, ties):
    """JV needs rows <= columns: the transposed solve and its inversion
    (the JAX function's :75-88)."""
    _check(*_case(100 + seed, shape, ties))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(1, 256, 256), (1, 320, 240),
                                   (2, 400, 150)])
def test_past_shared_memory_equals_jax(shape, ties):
    """Working matrices past a block's 227 KB of shared memory (a side of
    about 240), which the kernel keeps in device memory: square, and more
    rows than columns (the transposed solve).  The kernel must take any
    shape, as the JAX function does; the plain version it is held to is
    held to the JAX function here."""
    _check(*_case(200 + shape[1], shape, ties))


def test_degenerate_cases_equal_jax():
    """A camera with every entry forbidden, one with every row masked,
    one with every column masked, and one entry alone."""
    rng = np.random.RandomState(3)
    cost = (rng.rand(4, 6, 9) * 5).astype(np.float32)
    rmask = np.ones((4, 6), bool)
    cmask = np.ones((4, 9), bool)
    cost[0] = np.inf
    rmask[1] = False
    cmask[2] = False
    _check(cost, rmask, cmask)
    _check(np.full((1, 1, 1), 2.5, np.float32), np.ones((1, 1), bool),
           np.ones((1, 1), bool))


@pytest.fixture(scope="module")
def scene_costs():
    """The [C, D, T] cost matrices and masks that the port's engine hands
    the assignment on the 10-frame pipeline scene
    (tests/test_torch_pipeline.py's scene and config)."""
    sc = make_scenario(num_cameras=2, num_frames=10, num_people=3,
                       image_size=(256, 192), arena=5000.0, seed=11)
    cfg = tcfg.EngineConfig(
        num_cameras=2, image_width=256, image_height=192,
        tracker2d=tcfg.Tracker2DConfig(max_detections=16, max_trackers=32,
                                       max_features=16, lk_window=8,
                                       lk_pyramid_levels=2,
                                       lk_iterations=6),
        solver=tcfg.SolverConfig(num_replicas=4, max_vertices=64,
                                 solutions_per_replica=8,
                                 max_iterations=200))
    eng = TrackingEngine(cfg, sc.cameras, device="cpu")
    seen = []
    orig = tracker2d.solve_assignment_batch

    def record(cost, rmask, cmask):
        seen.append([x.clone().numpy() for x in (cost, rmask, cmask)])
        return orig(cost, rmask, cmask)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracker2d, "solve_assignment_batch", record)
        for t in range(10):
            eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                              frame_idx=t)
    assert len(seen) == 10
    return seen


def test_scene_cost_matrices_equal_jax(scene_costs):
    matched = 0
    for cost, rmask, cmask in scene_costs:
        assert cost.shape == (2, 16, 32)
        matched += int((_check(cost, rmask, cmask) >= 0).sum())
    assert matched >= 10, "the scene matched too little: the test is vacuous"


def test_numpy_inputs_give_cpu_tensors():
    cost, rmask, cmask = _case(7, (2, 5, 6), ties=True)
    col, mcost = solve_assignment_batch(cost, rmask, cmask)
    assert isinstance(col, torch.Tensor) and col.device.type == "cpu"
    one = solve_assignment(cost[1], rmask[1], cmask[1])
    assert one[0].shape == (5,)
    np.testing.assert_array_equal(one[0].numpy(), col[1].numpy())
    np.testing.assert_array_equal(one[1].numpy(), mcost[1].numpy())


def test_wrapper_checks():
    cost = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="masks"):
        jv_assign(cost, torch.ones((2, 4), dtype=torch.bool),
                  torch.ones((2, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\[C, R, T\]"):
        jv_assign(cost[0], torch.ones(3, dtype=torch.bool),
                  torch.ones(4, dtype=torch.bool))
    meta = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        jv_assign(meta, torch.ones((2, 3), dtype=torch.bool, device="meta"),
                  torch.ones((2, 4), dtype=torch.bool, device="meta"))


def test_plain_runs_for_cpu_tensors_and_launches_nothing():
    before = jv_assign.launches
    jv_assign(*[torch.from_numpy(x) for x in _case(1, (2, 4, 5), False)])
    assert jv_assign.launches == before


def test_work_counts_dijkstra_steps():
    """A diagonal problem: every row's cheapest column is free, so each
    row takes one Dijkstra step; one masked row takes none."""
    cost = np.full((1, 4, 6), 9.0, np.float32)
    for i in range(4):
        cost[0, i, i] = 1.0
    rmask = np.array([[True, True, False, True]])
    cmask = np.ones((1, 6), bool)
    work = jv_work(*[torch.from_numpy(x) for x in (cost, rmask, cmask)])
    assert work["steps"] == work["max_steps"] == 3
    assert work["bytes"] == 4 * 24 + (4 + 6) + 8 * 4
    assert work["flops"] == 4 * 24 + 5 * 6 * 3 + 3 * 6 * 3
    col, _ = jv_assign_reference(*[torch.from_numpy(x) for x in
                                   (cost, rmask, cmask)])
    assert col.tolist() == [[0, 1, -1, 3]]


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version(cuda_device):
    hungarian.build()
    for n, shape in enumerate([(3, 5, 7), (4, 48, 64), (2, 64, 48),
                               (2, 128, 256), (1, 256, 256), (1, 320, 240),
                               (2, 400, 150), (1, 320, 320),
                               (1, 12, 14000)]):
        for ties in (False, True):
            args = [torch.tensor(x, device=cuda_device)
                    for x in _case(n, shape, ties)]
            before = jv_assign.launches
            col_k, mc_k = jv_assign(*args)
            torch.cuda.synchronize()
            assert jv_assign.launches == before + 1
            col_r, mc_r = jv_assign_reference(*args)
            assert torch.equal(col_k.cpu(), col_r)
            assert torch.equal(mc_k.cpu().view(torch.int32),
                               mc_r.view(torch.int32))
