"""The repository's quality fixtures (tests/test_quality_regression.py)
for the port: the same scenes, configurations, loops, windows and zone,
and the gates with their thresholds.

- `sparse_fixture`: the full pipeline on 3 cameras at 384x288, 4 people,
  22 frames, scored at deferred windows 0 and 5.
- `density_fixture`: the associator alone on a 22-person, 4-camera
  synthesized 2D tracklet stream over 30 frames, scored at windows 0, 3
  and 6, with the registry's peak and the pool's drops.

Each runs on the card unless given device="cpu".  `kit` names the
modules a fixture is built from (`port_kit()` by default); another
package with the same interface builds the same fixture from its own.

`quality_reference.json` beside this file is the port's CPU run of both
(on the gather LK, MCMTT_LK_BACKEND=xla, where the port equals the JAX
package frame for frame; tests/test_torch_quality_regression.py holds it
so): every CLEAR-MOT number per window, tracks_peak, pool_dropped and
each frame's 3D ids after the run.  Rebuild it (both fixtures on the
CPU, their gates printed) with

    MCMTT_LK_BACKEND=xla python -m mcmtt_opticalflow_tpu_torch.quality

chip_smoke.py's phase 13 runs both fixtures with their gates on the
card."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import types
from typing import Dict, List, Tuple

import numpy as np

SPARSE_WINDOWS = (0, 5)
DENSITY_WINDOWS = (0, 3, 6)
ZONE = (-9000.0, -9000.0, 9000.0, 9000.0)
REFERENCE = os.path.join(os.path.dirname(__file__), "quality_reference.json")


def port_kit() -> types.SimpleNamespace:
    """The port's modules a fixture is built from."""
    from mcmtt_opticalflow_tpu_torch import config
    from mcmtt_opticalflow_tpu_torch.data import make_scenario
    from mcmtt_opticalflow_tpu_torch.data.synthetic import \
        synth_tracklet_stream
    from mcmtt_opticalflow_tpu_torch.eval import ClearMotAccumulator
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    return types.SimpleNamespace(
        config=config, make_scenario=make_scenario,
        synth_tracklet_stream=synth_tracklet_stream,
        ClearMotAccumulator=ClearMotAccumulator,
        TrackingEngine=TrackingEngine)


@dataclasses.dataclass
class FixtureRun:
    evals: Dict[int, object]        # window -> EvaluationResult
    # (window, frame) -> (ids, [n, 3] points) as each window scored it
    scored: Dict[Tuple[int, int], tuple]
    results: List[tuple]            # per frame, after the run: (ids, points)
    tracks_peak: int
    pool_dropped: int
    engine: object


def _result(rr):
    return (list(rr.ids), np.reshape(np.asarray(rr.points, np.float64),
                                     (-1, 3)))


def _score(eng, accs, scored, w, td):
    rr = eng.deferred_result(td)
    scored[(w, td)] = _result(rr)
    accs[w].set_result(td, [(i, p[0], p[1]) for i, p in zip(rr.ids,
                                                               rr.points)])


def _engine(kit, cfg, cameras, device):
    kw = {} if device is None else {"device": device}
    return kit.TrackingEngine(cfg, cameras, **kw)


def sparse_config(c):
    """The sparse scene's EngineConfig, from the config module `c`."""
    return c.EngineConfig(
        num_cameras=3, image_width=384, image_height=288,
        tracker2d=c.Tracker2DConfig(max_detections=16, max_trackers=32,
                                    max_features=16, lk_window=12,
                                    lk_pyramid_levels=2, lk_iterations=8),
        solver=c.SolverConfig(num_replicas=4, max_vertices=128,
                              solutions_per_replica=8, max_iterations=300,
                              solve_batch=8))


def density_config(c):
    """The density scene's EngineConfig, from the config module `c`."""
    return c.EngineConfig(
        num_cameras=4, image_width=768, image_height=576,
        tracker2d=c.Tracker2DConfig(max_detections=48, max_trackers=64),
        assoc3d=c.Associator3DConfig(k_best_size=30),
        solver=c.SolverConfig(num_replicas=8, max_vertices=512,
                              max_iterations=150))


def sparse_fixture(device=None, kit=None) -> FixtureRun:
    """The sparse scene through the full pipeline (sequential engine).
    device: the card by default, or "cpu"; None for a kit whose engine
    takes no device."""
    kit = kit or port_kit()
    sc = kit.make_scenario(num_cameras=3, num_frames=22, num_people=4,
                           image_size=(384, 288), arena=3500.0, seed=3,
                           fp_rate=0.2, fn_rate=0.05, noise_px=1.0)
    eng = _engine(kit, sparse_config(kit.config), sc.cameras, device)
    gx, gy = sc.gt_matrices()
    accs = {w: kit.ClearMotAccumulator(gx, gy, ZONE)
            for w in SPARSE_WINDOWS}
    scored, peak = {}, 0
    for t in range(sc.num_frames):
        eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                          frame_idx=t)
        peak = max(peak, len(eng.assoc.registry.tracks))
        for w in SPARSE_WINDOWS:
            if t - w >= 0:
                _score(eng, accs, scored, w, t - w)
    return FixtureRun(
        {w: acc.evaluate() for w, acc in accs.items()}, scored,
        [_result(eng.deferred_result(t)) for t in range(sc.num_frames)],
        peak, eng.assoc.pool_dropped_total, eng)


def density_fixture(device=None, kit=None) -> FixtureRun:
    """The 22-person density scene through the associator alone
    (`assoc.step` on the synthesized tracklet stream, flat gray frames),
    with the finalize-time backfill of every window."""
    kit = kit or port_kit()
    sc = kit.make_scenario(num_cameras=4, num_frames=30, num_people=22,
                           image_size=(768, 576), arena=9000.0,
                           noise_px=1.0, fp_rate=0.10, fn_rate=0.05, seed=0)
    eng = _engine(kit, density_config(kit.config), sc.cameras, device)
    stream = kit.synth_tracklet_stream(sc, 64, 3, seed=1)
    gray = np.full((4, 576, 768, 3), 128, np.uint8)
    gx, gy = sc.gt_matrices()
    accs = {w: kit.ClearMotAccumulator(gx, gy, ZONE, 1000.0)
            for w in DENSITY_WINDOWS}
    scored, peak = {}, 0
    for t in range(sc.num_frames):
        ids, boxes, mask = stream[t]
        eng.assoc.step(t, ids, boxes, mask, gray)
        peak = max(peak, len(eng.assoc.registry.tracks))
        for w in DENSITY_WINDOWS:
            if t - w >= 0:
                _score(eng, accs, scored, w, t - w)
    last = sc.num_frames - 1
    for w in DENSITY_WINDOWS:
        for td in range(max(last - w + 1, 0), last + 1):
            _score(eng, accs, scored, w, td)
    return FixtureRun(
        {w: acc.evaluate() for w, acc in accs.items()}, scored,
        [_result(eng.deferred_result(t)) for t in range(sc.num_frames)],
        peak, eng.assoc.pool_dropped_total, eng)


def _above(value, threshold, strict=True):
    ok = value > threshold if strict else value >= threshold
    return ok, value, threshold, value - threshold


def _below(value, threshold):
    return value <= threshold, value, threshold, threshold - value


def sparse_gates(run: FixtureRun) -> Dict[str, tuple]:
    """tests/test_quality_regression.py's gates on the sparse scene:
    name -> (holds, value, threshold, margin)."""
    r0, r5 = run.evals[0], run.evals[5]
    return {
        "mota_w5 > 0.55": _above(r5.mota, 0.55),
        "recall_w5 > 0.7": _above(r5.recall, 0.7),
        "precision_w5 > 0.8": _above(r5.precision, 0.8),
        "mota_w5 >= mota_w0 - 0.05": _above(r5.mota, r0.mota - 0.05,
                                            strict=False),
        "most_tracked_w5 >= 2": _above(r5.most_tracked, 2, strict=False),
        "most_lost_w5 <= 1": _below(r5.most_lost, 1),
    }


def density_gates(run: FixtureRun) -> Dict[str, tuple]:
    """tests/test_quality_regression.py's gates on the density scene:
    name -> (holds, value, threshold, margin)."""
    r = run.evals
    return {
        "mota_w6 > 0.6": _above(r[6].mota, 0.6),
        "mota_w3 >= mota_w0 - 0.01": _above(r[3].mota, r[0].mota - 0.01,
                                            strict=False),
        "mota_w6 >= mota_w3 - 0.01": _above(r[6].mota, r[3].mota - 0.01,
                                            strict=False),
        "id_switches_w6 <= id_switches_w0": _below(r[6].id_switches,
                                                   r[0].id_switches),
        "tracks_peak <= 2000": _below(run.tracks_peak, 2000),
        "pool_dropped <= 100": _below(run.pool_dropped, 100),
    }


def record(run: FixtureRun) -> dict:
    """A run as quality_reference.json keeps it."""
    return {"evals": {str(w): dataclasses.asdict(e)
                      for w, e in run.evals.items()},
            "tracks_peak": run.tracks_peak,
            "pool_dropped": run.pool_dropped,
            "ids": [[int(i) for i in ids] for ids, _ in run.results]}


FIXTURES = (("sparse", sparse_fixture, sparse_gates),
            ("density", density_fixture, density_gates))


def main(argv=None) -> None:
    """Rebuild quality_reference.json: both fixtures on the CPU on the
    gather LK (MCMTT_LK_BACKEND=xla, where the port equals the JAX
    package), each gate printed with its margin."""
    argparse.ArgumentParser(
        prog="python -m mcmtt_opticalflow_tpu_torch.quality",
        description=main.__doc__).parse_args(argv)
    if os.environ.get("MCMTT_LK_BACKEND", "").lower() != "xla":
        raise SystemExit("error: the record is the CPU run on the gather "
                         "LK: set MCMTT_LK_BACKEND=xla")
    out = {}
    for name, fixture, gates in FIXTURES:
        run = fixture(device="cpu")
        out[name] = record(run)
        print(f"{name}: " + json.dumps({k: [bool(g[0]), *g[1:]]
                                        for k, g in gates(run).items()}),
              flush=True)
    out["command"] = ("MCMTT_LK_BACKEND=xla python -m "
                      "mcmtt_opticalflow_tpu_torch.quality")
    with open(REFERENCE, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
