"""The port's native bindings (mcmtt_opticalflow_tpu_torch/native.py), the
counterpart of tests/test_native.py: exact LAP totals against the port's
hungarian_host (abs 1e-9) with forbidden pairs, the serial BLS
brute-force optimal on 5 seeds and deterministic for a seed, agreement
with the port's solve_mwcp on the CPU (abs 1e-3), the detection parser
round-tripping the port's write_detection_file (rtol 1e-6), and every
binding's output equal to the JAX package's binding on the same inputs.
Skipped, like tests/test_native.py, without a native toolchain.

The JAX binding is loaded here from the port's finished library (the
same source, built whole into the port's _build/): its own loader builds
native/libmcmtt_native.so in place, and a worker that opens that file
while another worker writes it caches the failure for its life."""

import itertools

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu import native as jax_native
from mcmtt_opticalflow_tpu_torch import native
from mcmtt_opticalflow_tpu_torch.config import SolverConfig
from mcmtt_opticalflow_tpu_torch.data import write_detection_file
from mcmtt_opticalflow_tpu_torch.models.mwcp import ThreefryFields, solve_mwcp
from mcmtt_opticalflow_tpu_torch.ops import hungarian_host
from mcmtt_opticalflow_tpu_torch.utils import prng

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def jax_binding_on_the_port_library():
    """Point the JAX binding at the port's finished library and reload it
    there; restore its path and load state afterwards."""
    saved = (jax_native._LIB_PATH, jax_native._TRIED, jax_native._LIB)
    jax_native._LIB_PATH = native.build()
    jax_native._TRIED, jax_native._LIB = False, None
    yield
    jax_native._LIB_PATH, jax_native._TRIED, jax_native._LIB = saved


def _graph(rng, n, p=0.5):
    adj = np.triu(rng.rand(n, n) < p, 1)
    return adj | adj.T


def _same(a, b):
    """Equal outputs of two bindings: same types, values and dtypes."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


class TestLap:
    @pytest.mark.parametrize("r,c", [(3, 3), (5, 8), (8, 5), (10, 10)])
    def test_total_equals_hungarian_host(self, r, c):
        rng = np.random.RandomState(r * 10 + c)
        for _ in range(5):
            cost = rng.rand(r, c) * 10
            col, total = native.lap_solve(cost)
            rows, cols = hungarian_host(cost)
            assert total == pytest.approx(cost[rows, cols].sum(), abs=1e-9)
            used = col[col >= 0]
            assert len(used) == len(set(used.tolist())) == min(r, c)
            _same((col, total), jax_native.lap_solve(cost))

    def test_forbidden(self):
        cost = np.full((2, 2), np.inf)
        cost[0, 1] = 3.0
        col, total = native.lap_solve(cost)
        assert col.tolist() == [1, -1]
        assert total == pytest.approx(3.0)
        _same((col, total), jax_native.lap_solve(cost))


class TestBls:
    @staticmethod
    def brute(weights, adj):
        best = 0.0
        for k in range(1, len(weights) + 1):
            for combo in itertools.combinations(range(len(weights)), k):
                if all(adj[a, b] for a, b in itertools.combinations(combo, 2)):
                    best = max(best, sum(weights[i] for i in combo))
        return best

    @pytest.mark.parametrize("seed", range(5))
    def test_optimal_small(self, seed):
        rng = np.random.RandomState(100 + seed)
        weights = rng.rand(10) * 10
        adj = _graph(rng, 10)
        out = native.bls_mwcp_solve(weights, adj, max_iterations=500,
                                    seed=seed)
        mask, score = out[0], out[1]
        assert score == pytest.approx(self.brute(weights, adj), abs=1e-6)
        members = np.flatnonzero(mask)
        assert all(adj[a, b] for a, b in itertools.combinations(members, 2))
        assert weights[mask].sum() == pytest.approx(score)
        _same(out, jax_native.bls_mwcp_solve(weights, adj, max_iterations=500,
                                             seed=seed))

    def test_deterministic(self):
        rng = np.random.RandomState(7)
        weights = rng.rand(12) * 5
        adj = _graph(rng, 12)
        _same(native.bls_mwcp_solve(weights, adj, 300, seed=7),
              native.bls_mwcp_solve(weights, adj, 300, seed=7))

    def test_agrees_with_the_port_solver(self):
        """solve_mwcp (4 replicas, 400 iterations, on the CPU) and the
        serial native solver find the same optimum (abs 1e-3)."""
        rng = np.random.RandomState(3)
        n, pad = 14, 2
        weights = np.zeros(n + pad, np.float32)
        weights[:n] = rng.rand(n) * 10
        adj = _graph(rng, n + pad, 0.55)
        adj[n:, :] = adj[:, n:] = False
        valid = np.arange(n + pad) < n
        cfg = SolverConfig(num_replicas=4, max_vertices=n + pad,
                           solutions_per_replica=8)
        res = solve_mwcp(torch.tensor(weights), torch.tensor(adj),
                         torch.tensor(valid), torch.zeros(n + pad,
                                                          dtype=torch.bool),
                         ThreefryFields(prng.prng_key(0)),
                         cfg, 400)
        _, host, _, _ = native.bls_mwcp_solve(
            weights[:n].astype(np.float64), adj[:n, :n], 2000, seed=0)
        assert float(res.best_score.max()) == pytest.approx(host, abs=1e-3)


class TestParser:
    def test_round_trip(self, tmp_path):
        boxes = np.asarray([[1.5, 2.5, 30.0, 60.0], [7.0, 8.0, 20.0, 40.0],
                            [640.25, 300.75, 55.5, 140.0]])
        path = str(tmp_path / "d.txt")
        write_detection_file(path, boxes)
        with open(path) as f:
            text = f.read()
        out = native.parse_detections(text)
        assert out.dtype == np.float32 and out.shape == (3, 4)
        np.testing.assert_allclose(out, boxes, rtol=1e-6)
        _same(out, jax_native.parse_detections(text))
        _same(native.parse_detections(text, max_boxes=2),
              jax_native.parse_detections(text, max_boxes=2))


def test_gray_equals_jax_binding():
    rgb = np.random.RandomState(0).randint(0, 256, (2, 37, 53, 3)) \
        .astype(np.uint8)
    _same(native.rgb_to_gray_u8(rgb), jax_native.rgb_to_gray_u8(rgb))


def test_unavailable_library_raises(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    for call in (lambda: native.lap_solve(np.zeros((2, 2))),
                 lambda: native.bls_mwcp_solve(np.ones(2), np.eye(2, dtype=bool)),
                 lambda: native.parse_detections(""),
                 lambda: native.rgb_to_gray_u8(np.zeros((1, 3), np.uint8))):
        with pytest.raises(RuntimeError, match="unavailable"):
            call()
