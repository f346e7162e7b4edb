"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a tiny size (tiny.py),
skipping the look for a card, with the program broken under the
recording probes, and judges it by a cell's real limits (MOTA by the tiny
scene's own).  The window is a fixed 16 frames, so each reading is the
same on every machine."""

import numpy as np
import pytest
import torch

import faults
import run
from tiny import TINY_MISS_SHARE, tiny_cell

def _run(hook=None, seed=4_000_000_123):
    c, t, lim = tiny_cell()
    return run.run(c, t, lim, seed, 600.0, False, device="cpu",
                   engine_hook=hook, frames=16)


class _Under:
    """Replaces what a probe wraps with `fn(real, *args)`."""

    def __init__(self, real, fn):
        self._real, self._fn = real, fn

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __call__(self, *args):
        return self._fn(self._real, *args)


def _under_2d(engine, fn):
    for probe in engine._progs2d:
        probe._prog = _Under(probe._prog, fn)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["numbers"]["frames_2d"] > 0 and res["numbers"]["frames_3d"] > 0
    assert res["numbers"]["ids_out_missing"] == 0
    assert res["numbers"]["frames_unreported"] == 0
    assert res["numbers"]["miss_share"] < TINY_MISS_SHARE
    assert res["correct"], res["rows"]


def test_an_enumeration_fault_fails_the_association():
    """Every other admitted seed dropped: the tracks of the reported
    frames still agree with the reference's cliques, and only the
    people it misses show the fault."""
    res = _run(faults.seeds_half)
    assert res["numbers"]["miss_share"] > TINY_MISS_SHARE
    assert not res["correct"]


def test_tracks_dropped_from_the_result():
    res = _run(faults.tracks_dropped)
    assert res["numbers"]["ids_out_missing"] > 0
    assert not res["correct"]


def test_a_chosen_frame_left_unreported():
    class Lossy(list):
        def append(self, r):
            if r.frame_idx % 2 == 0:
                super().append(r)

    def lossy(engine):
        engine.results = Lossy(engine.results)
    res = _run(lossy)
    assert res["numbers"]["frames_unreported"] > 0
    assert not res["correct"]


def test_a_2d_answer_altered_where_it_is_produced():
    def shift(prog, boxes, mask, t):
        out = prog(boxes, mask, t)
        out[..., 2] += 0.5                 # every box half a pixel right
        return out
    res = _run(lambda e: _under_2d(e, shift))
    assert not res["correct"]


def test_a_2d_step_that_returns_its_state_unchanged():
    def frozen(prog, boxes, mask, t):
        saved = [x.clone() for x in prog._leaves]
        out = prog(boxes, mask, t)
        prog._load_leaves(saved)
        return out
    res = _run(lambda e: _under_2d(e, frozen))
    assert not res["correct"]


def test_half_the_cameras_left_out():
    def half(prog, boxes, mask, t):
        mask = np.array(mask)
        mask[mask.shape[0] // 2:] = False
        return prog(boxes, mask, t)
    res = _run(lambda e: _under_2d(e, half))
    assert not res["correct"]


@pytest.mark.parametrize("what", ["score", "mask"])
def test_a_3d_answer_altered_where_it_is_produced(monkeypatch, what):
    from mcmtt_opticalflow_tpu_torch.models.associator3d import FrameProgram
    real = FrameProgram.__call__

    def altered(self, host, key, field_source=None):
        pack_a, pack_b = real(self, host, key, field_source)
        if what == "score":
            s = pack_b[:, -4:].contiguous().view(torch.float32)
            s[0] += 1.0
            pack_b[:, -4:] = s.view(torch.uint8)
        else:
            pack_b[0, 0] ^= 0x80           # vertex 0 in or out of clique 0
        return pack_a, pack_b
    monkeypatch.setattr(FrameProgram, "__call__", altered)
    res = _run()
    assert not res["correct"]
