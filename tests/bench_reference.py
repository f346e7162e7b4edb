"""Build mcmtt_opticalflow_tpu_torch/bench_reference.json: bench.py's scene
and protocol (37 frames, 7 of warm-up, MOTA at deferred windows 0/3/6)
run on the CPU three ways, with every frame's 3D ids and points.

    JAX_PLATFORMS=cpu python tests/bench_reference.py {jax,xla,plain,all}

  jax    the JAX engine (bench.py's loop; on the CPU its LK is the gather
         path, `xla_impl`);
  xla    the port with MCMTT_LK_BACKEND=xla (the same gather LK) on its
         default solver stream: equal to `jax` on every frame;
  plain  the port with the LK kernel's plain PyTorch version, the
         arithmetic of the CUDA kernel that the card runs (~15 min).

Each run replaces its entry in the file; points are rounded to 0.1 mm.
tests/test_torch_bench_parity.py holds the file against fresh runs."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "mcmtt_opticalflow_tpu_torch",
                   "bench_reference.json")
COMMANDS = {
    "jax": "JAX_PLATFORMS=cpu python tests/bench_reference.py jax",
    "xla": "MCMTT_LK_BACKEND=xla: run_bench(30, 'cpu') "
           "(python tests/bench_reference.py xla)",
    "plain": "MCMTT_LK_BACKEND unset: run_bench(30, 'cpu') "
             "(python tests/bench_reference.py plain)",
}


def _frames_json(results):
    return [{"frame": r["frame"], "ids": [int(i) for i in r["ids"]],
             "points": np.round(np.asarray(r["points"], np.float64)
                                .reshape(-1, 3), 1).tolist()}
            for r in results]


def run_jax(frames: int = 30) -> dict:
    """bench.py's main loop on the JAX engine (no override hook), keeping
    each frame's deferred result."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from mcmtt_opticalflow_tpu.config import (Associator3DConfig,
                                              EngineConfig, SolverConfig,
                                              Tracker2DConfig)
    from mcmtt_opticalflow_tpu.data import make_scenario
    from mcmtt_opticalflow_tpu.eval.clearmot import ClearMotAccumulator
    from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine

    warmup, windows = 7, (0, 3, 6)
    total = frames + warmup
    sc = make_scenario(num_cameras=4, num_frames=total, num_people=22,
                       image_size=(768, 576), arena=9000.0, noise_px=1.0,
                       fp_rate=0.10, fn_rate=0.05, seed=0)
    gx, gy = sc.gt_matrices()
    zone = (-9000.0, -9000.0, 9000.0, 9000.0)
    accs = {w: ClearMotAccumulator(gx, gy, zone, 1000.0) for w in windows}
    harvested = -1

    def harvest(eng):
        nonlocal harvested
        while harvested < eng.assoc.completed_frame:
            harvested += 1
            for w in windows:
                td = harvested - w
                if td >= 0:
                    r = eng.deferred_result(td)
                    accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                            zip(r.ids, r.points)])
    cfg = EngineConfig(
        num_cameras=4, image_width=768, image_height=576,
        tracker2d=Tracker2DConfig(lk_pyramid_levels=2, lk_iterations=8,
                                  max_detections=48, max_trackers=64,
                                  max_features=36),
        assoc3d=Associator3DConfig(k_best_size=30),
        solver=SolverConfig(num_replicas=8, max_vertices=1024,
                            max_iterations=150))
    eng = TrackingEngine(cfg, sc.cameras, pipelined=True)
    imgs = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
            .astype(np.uint8) for t in range(total)]
    tracks_peak = 0
    for t in range(total):
        eng.process_frame(imgs[t], sc.detections[t], frame_idx=t)
        if t >= warmup:
            tracks_peak = max(tracks_peak, len(eng.assoc.registry.tracks))
        harvest(eng)
    while eng.flush() is not None:
        harvest(eng)
    for w in windows:
        for td in range(max(harvested - w + 1, 0), harvested + 1):
            r = eng.deferred_result(td)
            accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                    zip(r.ids, r.points)])
    results = [{"frame": td, "ids": list(eng.deferred_result(td).ids),
                "points": eng.deferred_result(td).points}
               for td in range(harvested + 1)]
    return {"mota": [round(accs[w].evaluate().mota, 4) for w in windows],
            "tracks_peak": tracks_peak,
            "pool_dropped": eng.assoc.pool_dropped_total,
            "frames": _frames_json(results)}


def run_port(route: str, frames: int = 30) -> dict:
    """run_bench on the CPU with the LK route `route` ("xla" or "plain")."""
    from mcmtt_opticalflow_tpu_torch.bench import WINDOWS, run_bench
    if route == "xla":
        os.environ["MCMTT_LK_BACKEND"] = "xla"
    else:
        os.environ.pop("MCMTT_LK_BACKEND", None)
    run = run_bench(frames, "cpu")
    rec = run.record
    return {"mota": [rec[f"mota_w{w}"] for w in WINDOWS],
            "tracks_peak": rec["tracks_peak"],
            "pool_dropped": rec["pool_dropped"],
            "frames": _frames_json(run.results)}


def build(name: str) -> dict:
    t0 = time.perf_counter()
    out = run_jax() if name == "jax" else run_port(name)
    out = {"command": COMMANDS[name], **out}
    print(f"{name}: MOTA {out['mota']} tracks_peak {out['tracks_peak']} "
          f"pool_dropped {out['pool_dropped']} "
          f"({time.perf_counter() - t0:.0f} s)", file=sys.stderr)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", choices=("jax", "xla", "plain", "all"))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    data = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            data = json.load(f)
    for name in (("jax", "xla", "plain") if args.run == "all"
                 else (args.run,)):
        data[name] = build(name)
        with open(args.out, "w") as f:
            json.dump(data, f, separators=(",", ":"))
            f.write("\n")


if __name__ == "__main__":
    main()
