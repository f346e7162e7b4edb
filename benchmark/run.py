"""The benchmark of mcmtt_opticalflow_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as `setup_s`, from the start of this script to the window's
start): import the port, make the cell's periodic scene from the seed,
construct `TrackingEngine(cfg, cameras, pipelined=True, device="cuda")`,
run 7 warm-up frames (the port's kernels build on first use, into the
checkout's mcmtt_opticalflow_tpu_torch/_build/), capture the programs of
the buckets the mix meets (`precompile`), reset the stage timer.

The window is a closed loop for `--seconds`: one `process_frame` after
another on frame t mod P of the scene, with frame indices that keep
counting, the calling thread held on one core.  Then the engine is
flushed, the device's peak memory read, CLEAR-MOT scored over the
window's frames, the program freed, and the plain reference checks the
frames chosen from the seed (check.py).  With --trace 1 a steady slice of the window runs under
torch.profiler and the cell's per-layer metrics are reported instead of
its end-to-end ones.

The last line on standard output is one JSON object; the numbers that
decide `correct` are its last key and the last lines on standard error.
Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

if __name__ == "__main__":
    # load from one process with few threads: the host's BLAS and OpenMP
    # pools run single-threaded (set before numpy and torch load)
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                 "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

import cells  # noqa: E402
import check  # noqa: E402
import endtoend  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mcmtt_opticalflow_tpu")
WARMUP = 7
TRACE_START = 1.0 / 3.0      # share of the window before the traced slice
TRACE_SECONDS = 2.0


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def engine_config(cfg_json: dict):
    from mcmtt_opticalflow_tpu_torch.config import EngineConfig
    return EngineConfig.from_json(json.dumps(cfg_json["engine"]))


def reference_config(cfg_json: dict):
    from reference.config import EngineConfig
    return EngineConfig.from_json(json.dumps(cfg_json["engine"]))


def pin_thread():
    """Hold the calling thread on one core of those it may use (threads
    it starts later inherit the mask); returns the mask it had."""
    mask = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(mask)})
    return mask


def window_mota(results, scene, first: int, last: int, arena: float):
    """CLEAR-MOT over the frames first..last of the engine's own results
    (each frame's tracks as the engine reported them) against the scene's
    ground truth."""
    from clearmot import ClearMotAccumulator
    gx, gy = scene.gt_matrices(last + 1)
    acc = ClearMotAccumulator(gx[first:], gy[first:],
                              (-arena, -arena, arena, arena), 1000.0)
    for r in results:
        if first <= r.frame_idx <= last:
            acc.set_result(r.frame_idx - first,
                           [(i, p[0], p[1]) for i, p in zip(r.ids, r.points)])
    return acc.evaluate()


def graph_buckets(vmax: int):
    b, out = min(256, vmax), []
    while b < vmax:
        out.append(b)
        b *= 2
    return out + [vmax]


class Trace:
    """Ranges around the engine's calls into each layer, and the profiler
    over a steady slice of the window."""

    def __init__(self, engine):
        from torch.profiler import record_function
        a = engine.assoc

        def wrap(obj, name, label):
            fn = getattr(obj, name)

            def ranged(*args, **kw):
                with record_function(label):
                    return fn(*args, **kw)
            setattr(obj, name, ranged)

        for name in ("_upload_gray", "_step2d"):
            wrap(engine, name, "engine." + name.strip("_"))
        for name in ("_update_tracklets", "_enumerate_seeds",
                     "_update_tracks_prep", "_collect_solve", "_prune",
                     "_update_tracks", "_materialize_seeds", "_branch_tracks",
                     "_form_hypotheses", "_package_result"):
            wrap(a, name, "assoc." + name.strip("_"))
        import devtrace
        devtrace.warm_up()
        self.profile = devtrace.Profile()
        self.state = "before"

    def at_frame_end(self, elapsed: float, seconds: float) -> None:
        if self.state == "before" and elapsed >= TRACE_START * seconds:
            self.profile.start()
            self.started = time.perf_counter()
            self.frames = 0
            self.state = "on"
        elif self.state == "on":
            self.frames += 1
            if time.perf_counter() - self.started >= TRACE_SECONDS:
                self.stop()

    def stop(self) -> None:
        if self.state == "on":
            self.profile.stop()
            self.slice_s = time.perf_counter() - self.started
            self.state = "done"


def run(cfg_json: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, traced: bool, device: str = "cuda",
        engine_hook=None, controls=(), log=sys.stderr,
        frames: int = None, judge: bool = True) -> dict:
    """One run of a cell (see the module docstring); returns everything the
    result line and the metrics' readers need.  `engine_hook(engine)`
    runs after set-up, before the window (tests break the program there);
    with `frames` (tests) the window ends after that many frames instead;
    with `judge` False (readings of CLEAR-MOT alone) the reference checks no
    frame.
    Each of `controls` ("tf32", "bf16") also judges the reference computed
    in that lower precision in the program's place (control.py; never in a
    benchmark run)."""
    import torch
    from scene import make_scene
    from mcmtt_opticalflow_tpu_torch.geometry.tsai import TsaiCamera
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine

    cfg = engine_config(cfg_json)
    scene = make_scene(traffic, cfg.num_cameras,
                       (cfg.image_width, cfg.image_height), seed)
    cams = [TsaiCamera.create(**p) for p in scene.camera_params]
    eng = TrackingEngine(cfg, cams, pipelined=True, device=device)
    for t in range(WARMUP):
        eng.process_frame(*scene.frame(t), frame_idx=t)
    eng.precompile()
    pairs = [(nr, nb) for nr in traffic["row_buckets"]
             for nb in graph_buckets(cfg.solver.max_vertices)]
    eng.assoc.precompile(pairs=pairs)
    chosen = check.chosen_frames(seed, WARMUP, int(limits["check_every"]),
                                 int(limits["check_count"]))
    recorder = check.Recorder(eng, chosen)
    if engine_hook is not None:
        engine_hook(eng)
    tracer = Trace(eng) if traced else None
    programs_before = len(eng.assoc._programs)
    eng.assoc.timer.reset()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    mask = pin_thread()
    walls, t = [], WARMUP
    start = time.perf_counter()
    while True:
        f0 = time.perf_counter()
        eng.process_frame(*scene.frame(t), frame_idx=t)
        f1 = time.perf_counter()
        walls.append(f1 - f0)
        t += 1
        if tracer is not None:
            tracer.at_frame_end(f1 - start, seconds)
        if (f1 - start >= seconds if frames is None
                else len(walls) >= frames):
            break
    window_s = f1 - start
    last = t - 1
    os.sched_setaffinity(0, mask)
    if tracer is not None:
        tracer.stop()
        if tracer.state != "done":
            raise RuntimeError("the window ended before its traced slice "
                               "began")
        tracer.profile.finish()
        tr = tracer.profile.summary
        tr["window_s"] = max(tr["window_s"], tracer.slice_s)
        print(f"trace: {tracer.frames} frames in a {tracer.slice_s:.3f} s "
              f"slice; events span {tr['window_s']:.3f} s; "
              f"{tr['events']}", file=log)
    totals = dict(eng.assoc.timer.totals)
    captures = len(eng.assoc._programs) - programs_before
    while eng.flush() is not None:
        pass
    if device == "cuda":
        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated())
    else:
        memory_peak = 0
    done = {r.frame_idx for r in eng.results}
    failed = sum(1 for i in range(WARMUP, last + 1) if i not in done)
    recorder.to_host()
    reported = check.results_at(eng, recorder.frames)
    mean_clique = _mean_clique(recorder, cfg.solver.max_vertices)

    mot = window_mota(eng.results, scene, WARMUP, last,
                      float(traffic["arena_mm"]))
    outcome = {"miss_share": float(mot.miss_per_gt)}

    print(f"window: {len(walls)} frames in {window_s:.3f} s; frames "
          f"{WARMUP}..{last}; programs captured in the window: {captures}; "
          f"set-up {setup_s:.3f} s; p95 "
          f"{endtoend.frame_ms_p95(walls):.3f} ms", file=log)
    print(f"clearmot over frames {WARMUP}..{last}: {mot.summary()}",
          file=log)
    del eng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rcfg = reference_config(cfg_json)
    if not judge:
        recorder.r2d.clear()
        recorder.r3d.clear()
    numbers = check.readings(recorder, reported, scene, rcfg, device,
                             outcome=outcome)
    control_numbers = {c: check.readings(recorder, reported, scene, rcfg,
                                         device, c, outcome)
                       for c in controls}
    check_s = time.perf_counter() - t_check
    correct, rows = check.verdict(numbers, limits)
    print(f"check of {numbers['frames_2d']} 2D and {numbers['frames_3d']} "
          f"3D frames took {check_s:.1f} s; numbers: {json.dumps(numbers)}",
          file=log)
    return dict(setup_s=setup_s, walls=walls, window_s=window_s,
                totals=totals, frames=len(walls), failed=failed,
                memory_peak=memory_peak, correct=correct, rows=rows,
                numbers=numbers, cfg=cfg, mean_clique=mean_clique,
                trace=None if tracer is None else tracer.profile.summary,
                captures=captures, control_numbers=control_numbers)


def _mean_clique(recorder, vmax: int):
    sizes = [m.sum() for r in recorder.r3d.values()
             for m in check.unpack_k_best(r.pack_b, vmax)[0]]
    return float(np.mean(sizes)) if sizes else None


def metric_values(bench: dict, cell_name: str, res: dict, traced: bool):
    out = {}
    if not traced:
        e2e = {"frames_per_s": lambda: endtoend.frames_per_s(
                   res["walls"], res["window_s"]),
               "frame_ms_p95": lambda: endtoend.frame_ms_p95(res["walls"]),
               "setup_s": lambda: res["setup_s"]}
        for m in cells.metrics_of(bench, cell_name, "end_to_end"):
            out[m["name"]] = {"value": e2e[m["name"]](), "unit": m["unit"]}
        return out
    ctx = dict(frames=res["frames"], stages=res["totals"], trace=res["trace"],
               cfg=res["cfg"], mean_clique=res["mean_clique"])
    for m in cells.metrics_of(bench, cell_name, "per_layer"):
        v = cells.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"error: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    res = run(cells.config(cell["config"]), cells.traffic(cell["traffic"]),
              cells.limits(cell["name"]), args.seed, args.seconds,
              bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"error: loaded {', '.join(bad)}: the benchmark runs the "
              "PyTorch port alone", file=sys.stderr)
        return 4
    traced = bool(args.trace)
    metrics = metric_values(bench, cell["name"], res, traced)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak"]}
    line = {"correct": res["correct"], "attempted": res["frames"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if traced:
        tr = res["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, v, lim in res["rows"]}
    for k, v, lim in res["rows"]:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
