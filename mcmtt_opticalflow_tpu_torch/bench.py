"""The repository's bench.py for the port: its configuration, its scene and
its protocol, built with the port's modules.

    python -m mcmtt_opticalflow_tpu_torch.bench [frames] [--device cuda|cpu]

runs `TrackingEngine(pipelined=True)` at bench.py's config (4 cameras,
768x576, 22 people, K=30, 1024 solver vertices, 150 BLS iterations) on
bench.py's scene of `frames` + 7 frames: 7 warm-up frames, then `frames`
measured ones; CLEAR-MOT at deferred windows 0/3/6 with bench.py's harvest
and finalize-time backfill; frames/s from the median per-frame wall time.
`BENCH_ASSOC_OVERRIDES="k=v,k=v"` patches Associator3DConfig fields as
in bench.py.  It prints bench.py's stage summary to stderr and one JSON
line with bench.py's keys plus `device` (the card's name, or "cpu") and
`lk_route` (how the LK levels ran: "cuda", the hand-written kernel;
"plain", its plain PyTorch version; "gather", the gather path that
MCMTT_LK_BACKEND=xla selects on the CPU).  The card is the default; the
CPU only runs when asked for."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from mcmtt_opticalflow_tpu_torch.config import (Associator3DConfig,
                                                EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario

# bench.py's warm-up and its default measured frames: 37 frames in all.
# A scenario depends on its length, so a run of other length is another
# scene, and a shorter run of the same scene takes its first frames.
WARMUP = 7
MEASURED = 30
SCENE_FRAMES = WARMUP + MEASURED
WINDOWS = (0, 3, 6)


def assoc_overrides() -> Dict[str, float]:
    """bench.py's BENCH_ASSOC_OVERRIDES: "k=v,k=v" -> {k: int or float}."""
    out = {}
    for kv in os.environ.get("BENCH_ASSOC_OVERRIDES", "").split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            out[k.strip()] = float(v) if "." in v else int(v)
    return out


def bench_config(**overrides) -> EngineConfig:
    """bench.py's EngineConfig; `overrides` patch Associator3DConfig."""
    return EngineConfig(
        num_cameras=4, image_width=768, image_height=576,
        tracker2d=Tracker2DConfig(lk_pyramid_levels=2, lk_iterations=8,
                                  max_detections=48, max_trackers=64,
                                  max_features=36),
        assoc3d=Associator3DConfig(k_best_size=30, **overrides),
        solver=SolverConfig(num_replicas=8, max_vertices=1024,
                            max_iterations=150))


def bench_scene(num_frames: int = SCENE_FRAMES):
    """bench.py's scene over `num_frames` frames: (scenario, frames as
    [C, H, W, 3] uint8 per frame)."""
    sc = make_scenario(num_cameras=4, num_frames=num_frames, num_people=22,
                       image_size=(768, 576), arena=9000.0, noise_px=1.0,
                       fp_rate=0.10, fn_rate=0.05, seed=0)
    frames = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
              .astype(np.uint8) for t in range(num_frames)]
    return sc, frames


@dataclasses.dataclass
class BenchRun:
    record: dict              # the JSON line's keys
    engine: object            # the TrackingEngine, after its flush
    per_frame: List[float]    # wall s of each measured process_frame
    evals: dict               # window -> ClearMotResult
    results: List[dict]       # per frame: {"frame", "ids", "points"}


def lk_route(device) -> str:
    import torch
    from mcmtt_opticalflow_tpu_torch.ops.lk import use_kernel
    if torch.device(device).type == "cuda":
        return "cuda"
    return "plain" if use_kernel() else "gather"


def stage_medians(timer) -> dict:
    """Each stage's median ms in a StageTimer, the costliest first."""
    return {name: round(1e3 * sorted(timer.samples[name])
                        [timer.counts[name] // 2], 2)
            for name in sorted(timer.totals, key=lambda n: -timer.totals[n])
            if not name.startswith("_")}


def run_bench(frames: int = MEASURED, device=None,
              on_frame: Optional[Callable[[int], None]] = None) -> BenchRun:
    """bench.py's protocol on the port (see the module docstring).
    device: the card by default (raises without one), or "cpu".
    on_frame(t) runs before frame t is processed."""
    import torch
    from mcmtt_opticalflow_tpu_torch.eval.clearmot import ClearMotAccumulator
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    total = frames + WARMUP
    sc, imgs = bench_scene(total)
    gx, gy = sc.gt_matrices()
    zone = (-9000.0, -9000.0, 9000.0, 9000.0)
    accs = {w: ClearMotAccumulator(gx, gy, zone, 1000.0) for w in WINDOWS}
    harvested = -1

    def harvest(eng):
        nonlocal harvested
        while harvested < eng.assoc.completed_frame:
            harvested += 1
            for w in WINDOWS:
                td = harvested - w
                if td >= 0:
                    r = eng.deferred_result(td)
                    accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                            zip(r.ids, r.points)])

    eng = TrackingEngine(bench_config(**assoc_overrides()), sc.cameras,
                         pipelined=True, device=device)
    per_frame, tracks_peak = [], 0
    for t in range(total):
        if on_frame is not None:
            on_frame(t)
        if t == WARMUP:
            eng.precompile()
            eng.assoc.timer.reset()        # steady-state stage times only
        f0 = time.perf_counter()
        eng.process_frame(imgs[t], sc.detections[t], frame_idx=t)
        if t >= WARMUP:
            per_frame.append(time.perf_counter() - f0)
            tracks_peak = max(tracks_peak, len(eng.assoc.registry.tracks))
        harvest(eng)
    while eng.flush() is not None:         # drain the pipeline tail
        harvest(eng)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # finalize-time backfill (every window scores every frame)
    for w in WINDOWS:
        for td in range(max(harvested - w + 1, 0), harvested + 1):
            r = eng.deferred_result(td)
            accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                    zip(r.ids, r.points)])
    evals = {w: accs[w].evaluate() for w in WINDOWS}
    fps = 1.0 / float(np.median(per_frame))
    stage_ms = stage_medians(eng.assoc.timer)
    record = {
        "metric": "end_to_end_frames_per_sec_4cam_768x576_22ppl_k30",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 7.0, 3),
        "frames": len(per_frame),
        "tracks_peak": tracks_peak,
        "pool_dropped": eng.assoc.pool_dropped_total,
        **{f"mota_w{w}": round(evals[w].mota, 4) for w in WINDOWS},
        "stage_ms": stage_ms,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "lk_route": lk_route(device),
    }
    results = []
    for td in range(harvested + 1):
        r = eng.deferred_result(td)
        results.append({"frame": td, "ids": [int(i) for i in r.ids],
                        "points": np.asarray(r.points, np.float64)})
    return BenchRun(record, eng, per_frame, evals, results)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m mcmtt_opticalflow_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", nargs="?", type=int, default=MEASURED,
                    help="measured frames after the 7 warm-up frames")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    from mcmtt_opticalflow_tpu_torch.utils.device import card_or_exit
    run = run_bench(args.frames, card_or_exit(args.device))
    for w in WINDOWS:
        print(f"w{w}: {run.evals[w].summary()}", file=sys.stderr)
    timer = run.engine.assoc.timer
    print(timer.summary(), file=sys.stderr)
    rec = run.record
    dominant = next(iter(rec["stage_ms"]), "?")
    print(f"dominant stage: {dominant} ({rec['stage_ms'].get(dominant)} ms "
          f"median); {rec['frames']} frames in {sum(run.per_frame):.1f}s, "
          f"tracks_peak={rec['tracks_peak']}", file=sys.stderr)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
