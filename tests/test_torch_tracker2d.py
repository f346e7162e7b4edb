"""Parity of the port's 2D tracker step with the JAX package over 8
frames of the tests/test_tracker2d.py scenario.  The JAX side runs its
LK on the Pallas kernel in interpret mode (the arithmetic the Hopper
kernel ports; off the TPU the JAX package would otherwise take its XLA
gather path).  ids, mask and det_mask must be equal; boxes and the cost
matrix agree within 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu.config import Tracker2DConfig
from mcmtt_opticalflow_tpu.data import make_scenario
from mcmtt_opticalflow_tpu.geometry.tsai import stack_cameras
from mcmtt_opticalflow_tpu.models.tracker2d import (
    init_tracker2d_state as jax_init, make_tracker2d_step)
from mcmtt_opticalflow_tpu_torch import convert
from mcmtt_opticalflow_tpu_torch.models.tracker2d import (
    Track2DOutput, init_tracker2d_state, tracker2d_step)
from torch_parity import pad_dets, pallas_interpret

torch.set_num_threads(2)

CFG = Tracker2DConfig(max_detections=16, max_trackers=32, max_features=16,
                      lk_window=8, lk_pyramid_levels=2, lk_iterations=8)
ATOL = 1e-3
NUM_FRAMES = 8


@pytest.fixture(scope="module")
def runs():
    """Both packages over the same frames; the JAX states are kept so a
    mid-sequence state can be handed to the port."""
    sc = make_scenario(num_cameras=1, num_frames=NUM_FRAMES, num_people=3,
                       image_size=(256, 192), arena=4000.0, seed=3)
    jcams = stack_cameras(sc.cameras)
    tcams = convert.camera_from_numpy(
        {f: np.asarray(getattr(jcams, f)) for f in jcams._fields})
    inputs = []
    for t in range(NUM_FRAMES):
        gray = sc.render_frame(t, 0).mean(-1).astype(np.float32)[None]
        det, mask = pad_dets(sc.detections[t][0], CFG.max_detections)
        inputs.append((gray, det[None], mask[None]))

    with pallas_interpret():
        step = make_tracker2d_step(CFG, multi_camera=True)
        jstate = jax_init(CFG, 192, 256, num_cameras=1)
        jouts, jstates = [], []
        for t, (gray, det, mask) in enumerate(inputs):
            jstate, out = step(jstate, jnp.asarray(gray), jnp.asarray(det),
                               jnp.asarray(mask), jcams, jnp.int32(t))
            jouts.append(out)
            jstates.append(jstate)

    tstate = init_tracker2d_state(CFG, 192, 256, num_cameras=1,
                                  device="cpu")
    touts = []
    for t, (gray, det, mask) in enumerate(inputs):
        tstate, out = tracker2d_step(tstate, torch.tensor(gray),
                                     torch.tensor(det), torch.tensor(mask),
                                     tcams, t, CFG)
        touts.append(out)
    return inputs, tcams, jouts, jstates, touts


def _assert_output_equal(got: Track2DOutput, ref, t):
    for f in ("ids", "mask", "det_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"frame {t}: {f}")
    for f in ("boxes", "cost_matrix", "det_boxes"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=ATOL, err_msg=f"frame {t}: {f}")


@pytest.mark.parametrize("t", range(NUM_FRAMES))
def test_frame_outputs_match(runs, t):
    _, _, jouts, _, touts = runs
    _assert_output_equal(touts[t], jouts[t], t)


def test_scene_exercises_tracking(runs):
    _, _, jouts, _, _ = runs
    # tracklets persist (matched trackers) and costs are finite somewhere
    ids = [set(np.asarray(o.ids)[np.asarray(o.mask)]) for o in jouts]
    assert any(len(a & b) >= 2 for a, b in zip(ids[1:], ids[2:]))
    assert np.isfinite(np.asarray(jouts[3].cost_matrix)).any()


def test_state_roundtrip_mid_sequence(runs):
    """A mid-sequence JAX state carried to the port through convert.py
    steps to the JAX package's next output."""
    inputs, tcams, jouts, jstates, _ = runs
    t = 4
    fields = {f: (tuple(np.asarray(a) for a in v) if f == "frames_lo"
                  else np.asarray(v))
              for f, v in jstates[t - 1]._asdict().items()}
    state = convert.tracker2d_state_from_numpy(fields)
    back = convert.tracker2d_state_to_numpy(state)
    for f, v in fields.items():
        for a, b in zip(np.atleast_1d(back[f]) if f != "frames_lo"
                        else back[f], np.atleast_1d(v) if f != "frames_lo"
                        else v):
            np.testing.assert_array_equal(a, b)
    gray, det, mask = inputs[t]
    _, out = tracker2d_step(state, torch.tensor(gray), torch.tensor(det),
                            torch.tensor(mask), tcams, t, CFG)
    _assert_output_equal(out, jouts[t], t)
