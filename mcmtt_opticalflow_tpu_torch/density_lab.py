"""The density-quality lab (scripts/density_lab.py) on the port: the
bench's 22-person scene, or an associator-only variant of it, scored by
CLEAR-MOT at deferred windows 0, 3 and 6, with the population counters.

    python -m mcmtt_opticalflow_tpu_torch.density_lab [--frames 35]
        [--people 22] [--assoc-only] [--vmax 512] [--seed 0]
        [--profile FILE] [--debug] [--device cuda|cpu]

The full mode runs `TrackingEngine(pipelined=False).process_frame` on
the rendered frames: on the card its 2D step and its fused 3D program
run as captured CUDA graphs.  --assoc-only skips the 2D stage: per
camera each visible person's box becomes a tracklet whose id rotates
every max_tracklet_length frames (the synchronized rotation that loads
the bench scene), false positives become one-frame tracklets and misses
drop the tracklet for a frame (data/synthetic.py::synth_tracklet_stream);
the associator steps on that stream and a flat gray frame.

LAB_FEATS in the environment sets the 2D stage's features a box
(default 64).  --profile writes the loop's cProfile statistics to FILE.
--debug prints, after each frame, the associator's counters and an
audit of each ground-truth person: is a best track near them, a
selectable (cost < 0) track, any valid track at all; for a person with
only an unselectable track, that track's cost terms.  Then stderr gets
the windows' CLEAR-MOT summaries and the associator's stage timer, and
stdout one JSON line with the JAX script's keys.  The card is the
default; the CPU only runs when asked for."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from mcmtt_opticalflow_tpu_torch.config import (Associator3DConfig,
                                                EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario

WINDOWS = (0, 3, 6)
ZONE = (-9000.0, -9000.0, 9000.0, 9000.0)
NEAR_MM = 1000.0            # a track "near" a ground-truth person
IMAGE_SIZE = (768, 576)
# the CPU record of this module and tracklet_audit.py at their defaults,
# beside the JAX scripts' (built by tests/lab_reference.py)
REFERENCE = os.path.join(os.path.dirname(__file__), "lab_reference.json")


def lab_scene(frames: int = 35, people: int = 22, seed: int = 0):
    """The bench scene: 4 cameras at 768x576 over a 9 m arena."""
    return make_scenario(num_cameras=4, num_frames=frames,
                         num_people=people, image_size=IMAGE_SIZE,
                         arena=9000.0, noise_px=1.0, fp_rate=0.10,
                         fn_rate=0.05, seed=seed)


def lab_config(vmax: int = 512) -> EngineConfig:
    """The JAX script's EngineConfig (scripts/density_lab.py:115-122);
    LAB_FEATS sets max_features (default 64)."""
    return EngineConfig(
        num_cameras=4, image_width=IMAGE_SIZE[0],
        image_height=IMAGE_SIZE[1],
        tracker2d=Tracker2DConfig(
            lk_pyramid_levels=2, lk_iterations=8, max_detections=48,
            max_trackers=64,
            max_features=int(os.environ.get("LAB_FEATS", 64))),
        assoc3d=Associator3DConfig(k_best_size=30),
        solver=SolverConfig(num_replicas=8, max_vertices=vmax,
                            max_iterations=150))


def _nearest_valid_track(eng, t, gt_p):
    """The valid track nearest to a person at frame t: (track, mm)."""
    cand, dist = None, 1e18
    for tr in eng.assoc.registry.tracks.values():
        if not tr.valid:
            continue
        pt = tr.point_at(t)
        if pt is None:
            continue
        dd = float(np.linalg.norm(pt[:2] - gt_p))
        if dd < dist:
            cand, dist = tr, dd
    return cand, dist


def audit_frame(eng, sc, t, out=None) -> None:
    """Per-person coverage audit of frame t: is each ground-truth person
    near a best track, near any selectable (cost < 0) track, near any
    valid track at all?  Separates formation failures from selection
    failures; prints the cost terms of the nearest unselectable track
    to `out` (stderr by default)."""
    out = out or sys.stderr
    print(f"f{t:03d} {dict(eng.assoc.diag)}", file=out)
    gt = sc.gt_xy[t]
    best_pts = eng.deferred_result(t).points[:, :2]
    sel_pts, any_pts = [], []
    for tr in eng.assoc.registry.tracks.values():
        if not tr.valid:
            continue
        p = tr.point_at(t)
        if p is None:
            continue
        any_pts.append(p[:2])
        if tr.total_cost() < 0:
            sel_pts.append(p[:2])
    sel_pts = np.asarray(sel_pts).reshape(-1, 2)
    any_pts = np.asarray(any_pts).reshape(-1, 2)

    def near(pts, p):
        return len(pts) and np.linalg.norm(pts - gt[p], axis=1).min() \
            < NEAR_MM

    miss_b = miss_s = miss_a = 0
    for p in range(sc.num_people):
        if np.isnan(gt[p, 0]) or near(best_pts, p):
            continue
        miss_b += 1
        if near(sel_pts, p):
            continue
        miss_s += 1
        if not near(any_pts, p):
            miss_a += 1
            continue
        cand, dist = _nearest_valid_track(eng, t, gt[p])
        if cand is None or dist >= NEAR_MM:
            continue
        ncam = int(np.asarray(cand.raw_mask[:cand.n_measured]).sum(1).mean()
                   * 10) / 10 if cand.n_measured else 0
        print(f"      p{p}: d={dist:.0f} len={cand.length} "
              f"meas={cand.n_measured} born={cand.time_start} "
              f"en={cand.cost_enter:.1f} "
              f"rec={float(cand.cost_recon_pos.sum()):.1f} "
              f"lnk={float(cand.cost_link_pos.sum()):.1f} "
              f"rgb={cand.cost_rgb:.1f} "
              f"ex={cand.cost_exit:.1f} avg_cams={ncam}", file=out)
    print(f"      miss_best={miss_b} (no-selectable={miss_s}, "
          f"no-track-at-all={miss_a})", file=out)


@dataclasses.dataclass
class LabRun:
    record: dict                    # the JSON line
    evals: Dict[int, object]        # window -> EvaluationResult
    engine: object
    elapsed_s: float                # the loop's wall seconds
    frame_s: list                   # each frame's step, wall seconds


def run_lab(frames: int = 35, people: int = 22, assoc_only: bool = False,
            vmax: int = 512, seed: int = 0, profile: Optional[str] = None,
            debug: bool = False, device=None, out=None) -> LabRun:
    """The lab on the card by default (raises without one), or
    device="cpu".  `profile` names a file for the loop's cProfile
    statistics; `debug` prints audit_frame after each frame; the
    windows' summaries go to `out` (stderr by default)."""
    from mcmtt_opticalflow_tpu_torch.eval.clearmot import ClearMotAccumulator
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    out = out or sys.stderr
    sc = lab_scene(frames, people, seed)
    cfg = lab_config(vmax)
    gx, gy = sc.gt_matrices()
    accs = {w: ClearMotAccumulator(gx, gy, ZONE, NEAR_MM) for w in WINDOWS}
    eng = TrackingEngine(cfg, sc.cameras, pipelined=False, device=device)

    def score(w, td):
        r = eng.deferred_result(td)
        accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                zip(r.ids, r.points)])

    # the loop's clock starts before the stream is synthesized or the
    # frames rendered, as the JAX script's does
    t0 = time.perf_counter()
    if assoc_only:
        from mcmtt_opticalflow_tpu_torch.data.synthetic import \
            synth_tracklet_stream
        tk = synth_tracklet_stream(
            sc, cfg.tracker2d.max_trackers,
            cfg.tracker2d.max_tracklet_length, seed=seed + 1)
        gray = np.full((4, IMAGE_SIZE[1], IMAGE_SIZE[0], 3), 128, np.uint8)

        def step(t):
            eng.assoc.step(t, *tk[t], gray)
    else:
        rgb = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
               .astype(np.uint8) for t in range(sc.num_frames)]

        def step(t):
            eng.process_frame(rgb[t], sc.detections[t], frame_idx=t)

    tracks_peak = 0
    frame_s = []
    prof = None
    if profile:
        import cProfile
        prof = cProfile.Profile()
        prof.enable()
    for t in range(sc.num_frames):
        t1 = time.perf_counter()
        step(t)
        frame_s.append(time.perf_counter() - t1)
        tracks_peak = max(tracks_peak, len(eng.assoc.registry.tracks))
        if debug:
            audit_frame(eng, sc, t, out)
        for w in WINDOWS:
            if t - w >= 0:
                score(w, t - w)
    if prof:
        prof.disable()
        prof.dump_stats(profile)
    elapsed = time.perf_counter() - t0
    # the frames the windows had not reached yet, scored as they stand
    last = sc.num_frames - 1
    for w in WINDOWS:
        for td in range(max(last - w + 1, 0), last + 1):
            score(w, td)
    evals = {w: accs[w].evaluate() for w in WINDOWS}
    for w in WINDOWS:
        print(f"w{w}: {evals[w].summary()}", file=out)
    record = {
        "frames": sc.num_frames, "elapsed_s": round(elapsed, 1),
        "tracks_peak": tracks_peak,
        "pool_dropped": eng.assoc.pool_dropped_total,
        **{f"mota_w{w}": round(evals[w].mota, 4) for w in WINDOWS},
        **{f"ids_w{w}": evals[w].id_switches for w in WINDOWS},
        **{f"recall_w{w}": round(evals[w].recall, 3) for w in WINDOWS},
    }
    return LabRun(record, evals, eng, elapsed, frame_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m mcmtt_opticalflow_tpu_torch.density_lab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=35)
    ap.add_argument("--people", type=int, default=22)
    ap.add_argument("--assoc-only", action="store_true")
    ap.add_argument("--vmax", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None,
                    help="write the loop's cProfile statistics here")
    ap.add_argument("--debug", action="store_true",
                    help="print per-frame associator diagnostics")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    from mcmtt_opticalflow_tpu_torch.utils.device import card_or_exit
    device = card_or_exit(args.device)
    run = run_lab(args.frames, args.people, args.assoc_only, args.vmax,
                  args.seed, args.profile, args.debug, device)
    print(run.engine.assoc.timer.summary(), file=sys.stderr)
    print(json.dumps(run.record))


if __name__ == "__main__":
    main()
