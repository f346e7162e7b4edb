"""Faults planted under the timed path, for readings and tests.

Each function takes a `TrackingEngine` after set-up (run.run's
`engine_hook`) and breaks one layer of the association in place, by
wrapping a bound method of the engine's `Associator3D`:

- `seeds_half`: every other admitted seed track is dropped, as a faster
  enumeration that births fewer tracks would;
- `branches_half`: every other branch candidate is dropped, as a faster
  branching that extends fewer tracks would;
- `tracks_dropped`: every other track of a frame's result goes
  unreported, as an engine that loses results would.

control.py --faults reads a cell's numbers under each of them on the card.
"""

from __future__ import annotations


def seeds_half(engine) -> None:
    a = engine.assoc
    real = a._enumerate_seeds

    def enumerate_seeds(frame_idx):
        oks, enter_costs = real(frame_idx)
        return oks[::2], enter_costs[::2]
    a._enumerate_seeds = enumerate_seeds


def branches_half(engine) -> None:
    a = engine.assoc
    real = a._apply_history_batch

    def apply_history_batch(candidates, frame_idx):
        return real(candidates, frame_idx)[::2]
    a._apply_history_batch = apply_history_batch


def tracks_dropped(engine) -> None:
    a = engine.assoc
    real = a._package_result

    def package_result(frame_idx):
        r = real(frame_idx)
        r.ids, r.points = r.ids[::2], r.points[::2]
        return r
    a._package_result = package_result


FAULTS = {f.__name__: f for f in (seeds_half, branches_half, tracks_dropped)}
