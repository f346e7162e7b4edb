"""MCMTT_LK_BACKEND in the port (ops/lk.py::use_kernel).

With `xla` the port takes the gather LK (`lk_track_points`) at every
level, as the JAX package's `xla_impl` does, so the port engine on the
CPU must equal the JAX engine's own CPU run (its default gather path, no
Pallas interpret mode) on the tests/test_torch_pipeline.py scene (2
cameras, 256x192, 10 frames; the port's solver draws the JAX package's
fields): 2D ids and masks exactly equal, boxes within 1e-3 px, 3D ids
equal and points within 1 mm every frame.  Unset, `pallas` or an
unknown value keep the kernel route at kernel-sized levels.  CUDA
tensors ignore the switch and always take the kernel (chip_smoke.py
checks that on the card)."""

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu import config as jcfg
from mcmtt_opticalflow_tpu.data import make_scenario
from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine as JaxEngine
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario as t_make_scenario
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.ops import lk
from test_torch_pipeline import ARENA, NUM_FRAMES, POINT_ATOL_MM, _cfg, \
    _record_2d
from torch_parity import JaxFieldSource

torch.set_num_threads(2)

BOX_ATOL_PX = 1e-3


class _Routes:
    """Counts the calls of each LK route of ops/lk.py."""

    def __init__(self, mp):
        self.kernel = self.gather = 0
        kernel, gather = lk.lk_level, lk.lk_track_points

        def on_kernel(*a, **k):
            self.kernel += 1
            return kernel(*a, **k)

        def on_gather(*a, **k):
            self.gather += 1
            return gather(*a, **k)
        mp.setattr(lk, "lk_level", on_kernel)
        mp.setattr(lk, "lk_track_points", on_gather)


@pytest.fixture(scope="module")
def runs():
    sc = make_scenario(num_cameras=2, num_frames=NUM_FRAMES, num_people=3,
                       image_size=(256, 192), arena=ARENA, seed=11)
    frames = [np.stack(sc.frames(t)) for t in range(NUM_FRAMES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MCMTT_LK_BACKEND", raising=False)
        jeng = JaxEngine(_cfg(jcfg), sc.cameras)
        jseen = _record_2d(jeng)
        jres = [jeng.process_frame(frames[t], sc.detections[t], frame_idx=t)
                for t in range(NUM_FRAMES)]

    tsc = t_make_scenario(num_cameras=2, num_frames=NUM_FRAMES,
                          num_people=3, image_size=(256, 192), arena=ARENA,
                          seed=11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        routes = _Routes(mp)
        teng = TrackingEngine(_cfg(tcfg), tsc.cameras, device="cpu")
        teng.assoc.field_source = JaxFieldSource(teng.cfg.solver.seed)
        tseen = _record_2d(teng)
        tres = [teng.process_frame(frames[t], tsc.detections[t],
                                   frame_idx=t) for t in range(NUM_FRAMES)]
    return jseen, jres, tseen, tres, routes


def test_xla_takes_the_gather_route_only(runs):
    routes = runs[4]
    assert routes.kernel == 0
    # per frame: 4 LK calls (3 backward, 1 forward) x 2 pyramid levels x
    # 2 cameras
    assert routes.gather == NUM_FRAMES * 4 * 2 * 2


def test_xla_2d_outputs_equal_jax_cpu(runs):
    jseen, _, tseen, _, _ = runs
    assert len(jseen) == len(tseen) == NUM_FRAMES
    for t, (j, g) in enumerate(zip(jseen, tseen)):
        np.testing.assert_array_equal(g[2], j[2], err_msg=f"mask, frame {t}")
        m = j[2]
        np.testing.assert_array_equal(g[0][m], j[0][m],
                                      err_msg=f"ids, frame {t}")
        np.testing.assert_allclose(g[1][m], j[1][m], rtol=0,
                                   atol=BOX_ATOL_PX,
                                   err_msg=f"boxes, frame {t}")


def test_xla_track3d_results_equal_jax_cpu(runs):
    _, jres, _, tres, _ = runs
    for t, (j, g) in enumerate(zip(jres, tres)):
        assert j.frame_idx == g.frame_idx == t
        assert j.ids == g.ids, f"first divergent frame {t}"
        np.testing.assert_allclose(np.reshape(g.points, (-1, 3)),
                                   np.reshape(j.points, (-1, 3)), rtol=0,
                                   atol=POINT_ATOL_MM, err_msg=f"frame {t}")
    assert any(len(r.ids) > 0 for r in tres[2:])


@pytest.mark.parametrize("value,kernel", [
    (None, True), ("pallas", True), ("PALLAS", True), ("bogus", True),
    ("", True), ("xla", False), ("XLA", False)])
def test_switch_read_on_every_call(value, kernel, monkeypatch):
    """One kernel-sized level (2 cameras, 48x128, 8 features): the
    kernel route (its plain version on the CPU) unless the switch says
    xla, which takes one gather call per camera."""
    if value is None:
        monkeypatch.delenv("MCMTT_LK_BACKEND", raising=False)
    else:
        monkeypatch.setenv("MCMTT_LK_BACKEND", value)
    routes = _Routes(monkeypatch)
    g = torch.Generator().manual_seed(0)
    prev = torch.rand((2, 48, 128), generator=g)
    nxt = torch.roll(prev, 1, dims=2)
    src = torch.rand((2, 8, 2), generator=g) * torch.tensor([100.0, 30.0]) \
        + 10.0
    act = torch.ones((2, 8), dtype=torch.bool)
    out = lk.lk_level_cams(prev, nxt, src, src, act, window=8, iterations=4)
    assert lk.use_kernel() is kernel
    assert (routes.kernel, routes.gather) == ((1, 0) if kernel else (0, 2))
    assert [tuple(x.shape) for x in out] == [(2, 8, 2), (2, 8), (2, 8)]
