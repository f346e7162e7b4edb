#!/usr/bin/env python
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), then the LK
     level kernel is built from ops/csrc/lk_level.cu with nvcc;
  2. the LK kernel against its plain PyTorch version at synthetic bench
     shapes (4 cameras, 576x768 and 288x384 levels, 6912 and 9216
     feature slots, points uniform over the image, ~25% active at
     random), and once with images cut to 766 columns (rows not 16-byte
     aligned: the kernel's 4-byte staging): valid agrees on >= 99.9% of
     slots; on slots valid in both, |d tracked| <= 1e-3 px and |d resid|
     <= 1e-4; times per call are
     CUDA-event medians of 20 `lk_level` calls, wrapper host work
     included;
  3. main path: mcmtt_opticalflow_tpu_torch.bench.run_bench(30, "cuda"),
     bench.py's protocol at its config and scene (37 frames, 7 of
     warm-up), with exactly 8 LK kernel launches per processed frame and
     no LK work on the CPU; frames/s, stage medians, tracks_peak,
     pool_dropped, the MOTA triple at w0/w3/w6 beside the CPU record
     (bench_reference.json: the JAX engine, and the port with the LK
     kernel's plain version), the first frame whose 3D ids leave the
     plain record, and a failure when a window's MOTA leaves it by more
     than MOTA_BOUND; then the solver's threefry field draw of one frame,
     timed alone.  The arguments of the 8 `lk_level` calls of frame
     CAPTURE_FRAME are recorded (cloned) on the way;
  3b. both kernels on those recorded inputs: each call against the plain
     version at the limits of phase 2; the distribution of |final -
     initial estimate| (plain version) beside the kernel's staging
     margin; per call the kernel's device-only time (REPS back-to-back
     launches on prepared tensors, queued behind a sleep kernel so the
     host cannot starve the card, between two CUDA events, over REPS),
     the wrapper's host time per `lk_level` call (perf_counter over REPS
     calls, no synchronisation between them), the plain version's time,
     and the bound: the larger of the bytes these inputs need over
     3.35 TB/s and their float32 operations over 67 TFLOP/s
     (ops/lk_kernel.py::lk_level_work); an empty kernel's launch, timed
     like the device-only time, is the practical floor;
  4. checks: sequential and pipelined modes agree on 8 frames of the same
     scene on the same solver stream, and the 2D stage on the card
     agrees with the same stage on the CPU (plain LK version) on a small
     scene;
  5. the serial LK kernel (lk_level(variant="serial"), the JAX package's
     lk_level_pallas(variant="serial")) against its plain version at the
     shapes of phase 2 (the 766-column call included), plus one call
     with guesses 10-20 px off so the working-subpatch clamp binds; same
     limits as phase 2; counts its own launches;
  6. api: every public device function of the slice that ports the rest
     of the JAX package (camera_position, back_projection_line, the
     N-view reconstructions, gaussian_blur_3x3, sg_smooth,
     rgb_histogram, rgb_cost, the enter / exit / connectivity costs,
     solve_mwcp_batch with collect_k_best) on the card and on the CPU on
     the same seeded inputs, at the CPU parity tests' tolerances; the
     device RGB histogram of a bench frame with 48 boxes equals
     host_rgb_histogram exactly; and the LK backend switch, which only
     a CPU run honours: with MCMTT_LK_BACKEND=xla, set here for one
     lk_track_pyramid call on the card (the inputs of phase 7), every
     level still launches the kernel (3 launches), and the result equals
     the same call without the switch at the limits of phase 2 (the
     script clears the switch at its start: its CPU references are the
     kernel's plain version);
  7. lk_track_pyramid: one 768x576 pair, 3 levels, N=1024, w=16, 10
     iterations: 3 batched-kernel launches, held against the CPU call at
     the limits of phase 2;
  8. mesh: the bench configuration for MESH_FRAMES frames without a mesh
     and on make_mesh(devices=[cuda:0] * 4) (4 camera groups; the fused
     3D program's row inputs split in 4 chunks): equal ids, points
     within 1 mm, LK launches counted; solve_mwcp_sharded at V=1024,
     R=38, 150 iterations over 2 blocks equals its per-block solves plus
     the global argmax;
  8b. multiprocess: parallel/multihost_sim.py --bench in two processes on
     the one card, joined by gloo, each with two cuda:0 entries of the
     global cam 4 x block 1 mesh: 16 LK launches per process per frame,
     ids equal to phase 8's mesh run frame by frame (points within 1 mm);
     the solve of phase 8 over a 1 x 4 mesh with two blocks in each
     process equals its per-block solves plus the argmax; wall time
     against phase 8's, the median time per frame in collectives, and
     scaling_report;
  9. profile: utils/timing.py::profile_trace (torch.profiler) around
     PROFILE_FRAMES steady bench frames: device busy share, device ms
     per frame, top 5 kernels, and lk_level_kernel events (8 per frame);
  10. the dataset CLI: the bench scene (12 frames) written in the
     reference's layout (Tsai XML, detection files, .ppm frames, ground
     truth, parameters.txt), run through `main.py <parameters.txt>` in
     process at the default EngineConfig (3 pyramid levels: 12 LK kernel
     launches per frame, none on the CPU, no flat-gray frame), MOTA at
     w0/w3/w6 from the printed table's results.

The whole script takes about 4 minutes on the card.  The line before the
last is a JSON summary of the kernels, on the inputs of phase 3b: per
bench frame (8 launches) `ms` (device-only), `plain_ms`, `bound_ms`;
per launch `device_us_per_launch`, `bound_us`; `host_us_per_call`; what
binds (`bound_by`); `library_ms` null (no single PyTorch call computes
an LK level); `call_ms_synthetic`, phase 2's per-frame time with the
wrapper's host work; `launches_by_path`, the launches of each path that
runs the kernel, each counted from 0 (`launches` is the main path's).
The last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

WARMUP = 7
MEASURED = 30
CAPTURE_FRAME = WARMUP + 10
REPS = 100
HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak HBM3 rate and FP32 rate
FP32_FLOPS_PER_S = 67e12
WINDOWS = (0, 3, 6)
CLI_FRAMES = 12
MESH_FRAMES = 12
MP_LIMIT_S = 240            # each process of the multiprocess phase
PROFILE_FRAMES = 4
CLI_CAM_IDS = (1, 5, 6, 8)
# the largest |card - CPU| MOTA at any window the main path may show,
# against the port's CPU run with the LK kernel's plain version
# (bench_reference.json `plain`; PERF.md section 2)
MOTA_BOUND = 0.01


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_us(launch, reps=REPS, runs=3):
    """Device-only µs per launch: `reps` back-to-back launches queued
    behind a ~10 ms sleep kernel (so the host enqueues them all before the
    card reaches them), between two CUDA events, over `reps`; the median
    of `runs` such runs."""
    import torch
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(reps):
            launch()
        b.record()
        b.synchronize()
        times.append(1e3 * a.elapsed_time(b) / reps)
    return sorted(times)[runs // 2]


def host_us(call, reps=REPS):
    """Host µs per call: perf_counter over `reps` calls with no
    synchronisation between them."""
    import torch
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def prepared_launch(args, kw, variant):
    """A zero-argument launch of the variant's kernel on `args` made ready
    once (the kernel's types, outputs allocated): the wrapper's checks,
    conversions and allocations are left out, and nothing is counted."""
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
    prev, nxt, cam, pts, guess, act = args
    ins = (prev.contiguous().float(), nxt.contiguous().float(),
           cam.contiguous().to(torch.int32), pts.contiguous().float(),
           guess.contiguous().float(), act.contiguous().bool())
    n, (_, h, w) = pts.shape[0], prev.shape
    outs = (torch.empty((n, 2), device=prev.device),
            torch.empty((n,), dtype=torch.bool, device=prev.device),
            torch.empty((n,), device=prev.device))
    ph, pw = min(lk_kernel.PH, h), min(lk_kernel.PW, w)
    return lambda: lk_kernel._launch(variant, *ins, *outs, kw["window"],
                                     kw["iters"], ph, pw)


class LkCapture:
    """Records (cloned) the arguments of every `lk_level` call the
    tracker makes while `frame` equals `capture_frame`; install() wraps
    ops/lk.py's name for it, remove() restores it."""

    def __init__(self, capture_frame):
        self.capture_frame = capture_frame
        self.frame = -1
        self.calls = []

    def install(self):
        from mcmtt_opticalflow_tpu_torch.ops import lk
        self._orig = lk.lk_level

        def capturing(*a, **k):
            if self.frame == self.capture_frame:
                self.calls.append(([x.clone() for x in a], dict(k)))
            return self._orig(*a, **k)
        lk.lk_level = capturing

    def remove(self):
        from mcmtt_opticalflow_tpu_torch.ops import lk
        lk.lk_level = self._orig


def compare(args, kw, variant, label):
    """One kernel launch against the plain version on the same inputs;
    fails beyond the limits.  Returns (max |d tracked| on slots valid in
    both, the line to log)."""
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
    tr_k, ok_k, res_k = lk_kernel.lk_level(*args, **kw, variant=variant)
    torch.cuda.synchronize()
    tr_r, ok_r, res_r = lk_kernel.lk_level_reference(*args, **kw,
                                                     variant=variant)
    agree = (ok_k == ok_r).float().mean().item()
    both = ok_k & ok_r
    if not both.any():
        fail(f"{label}: the check exercised no valid feature")
    d_tr = (tr_k - tr_r)[both].abs().max().item()
    d_res = (res_k - res_r)[both].abs().max().item()
    msg = (f"{label}: valid-agree={agree:.6f} valid={int(ok_k.sum())} "
           f"max|dtracked|={d_tr:.3e} px max|dresid|={d_res:.3e}")
    if agree < 0.999 or d_tr > 1e-3 or d_res > 1e-4:
        fail(f"kernel disagrees with its plain version: {msg}")
    return d_tr, msg


def bench_level_calls(frames, cfg, guess_px=None):
    """The LK level calls of one bench frame, at its shapes: per pyramid
    level, backtrack_interval - 1 backward calls of N=6912 slots and one
    forward call of N=9216, ~25% active, on two consecutive frames'
    pyramids.  Yields (calls per frame, args, kwargs, label); guesses are
    1.5 px off, or `guess_px` (lo, hi) px off in a random direction."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.ops.pyramid import build_pyramid

    dev = torch.device("cuda")
    t2 = cfg.tracker2d
    g0 = torch.tensor(frames[WARMUP].mean(-1) / 255.0, dtype=torch.float32,
                      device=dev)
    g1 = torch.tensor(frames[WARMUP + 1].mean(-1) / 255.0,
                      dtype=torch.float32, device=dev)
    p0 = build_pyramid(g0, t2.lk_pyramid_levels)
    p1 = build_pyramid(g1, t2.lk_pyramid_levels)
    c = cfg.num_cameras
    rng = np.random.RandomState(0)
    n_back = c * t2.max_detections * t2.max_features      # 6912
    n_fwd = c * t2.max_trackers * t2.max_features         # 9216
    kw = dict(window=t2.lk_window, iters=t2.lk_iterations)
    for n, calls in ((n_back, t2.backtrack_interval - 1), (n_fwd, 1)):
        for lvl in range(t2.lk_pyramid_levels):
            prev, nxt = p0[lvl], p1[lvl]
            _, h, w = prev.shape
            pts = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], -1)
            if guess_px is None:
                guess = pts + rng.normal(0, 1.5, (n, 2))
            else:
                ang = rng.uniform(0, 2 * np.pi, n)
                r = rng.uniform(*guess_px, n)
                guess = pts + np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
            args = (prev, nxt,
                    torch.tensor(np.repeat(np.arange(c), n // c),
                                 dtype=torch.int32, device=dev),
                    torch.tensor(pts, dtype=torch.float32, device=dev),
                    torch.tensor(guess, dtype=torch.float32, device=dev),
                    torch.tensor(rng.rand(n) < 0.25, device=dev))
            yield calls, args, kw, f"[{c},{h},{w}] N={n} active=" \
                f"{int(args[5].sum())}"


def unaligned_call(frames, cfg):
    """The first bench call with images cut to 766 columns: rows are not
    16-byte aligned, so the kernel stages with 4-byte copies."""
    _, args, kw, label = next(bench_level_calls(frames, cfg))
    args = (args[0][..., :766].contiguous(), args[1][..., :766].contiguous(),
            *args[2:])
    return args, kw, label.replace(",768]", ",766]") + " (rows unaligned)"


def check_kernel(frames, cfg, variant, extra=()):
    """A kernel against its plain version at every bench shape and on the
    `extra` (args, kwargs, label) calls: (worst |d tracked|, launches
    made)."""
    name = "lk_level" if variant == "batched" else "lk_level_serial"
    calls = [c[1:] for c in bench_level_calls(frames, cfg)] + list(extra)
    worst = 0.0
    for args, kw, label in calls:
        d_tr, msg = compare(args, kw, variant, f"kernel {name} {label}")
        log(msg)
        worst = max(worst, d_tr)
    return worst, len(calls)


def time_kernel(frames, cfg, variant):
    """A kernel's time and its plain version's per bench frame
    (8 launches), from CUDA-event medians of 20 calls at each shape."""
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel

    name = "lk_level" if variant == "batched" else "lk_level_serial"
    total_ms = total_plain = 0.0
    for calls, args, kw, label in bench_level_calls(frames, cfg):
        ms = time_ms(lambda: lk_kernel.lk_level(*args, **kw,
                                                variant=variant))
        plain = time_ms(lambda: lk_kernel.lk_level_reference(
            *args, **kw, variant=variant))
        log(f"kernel {name} {label}: kernel={ms:.4f} ms "
            f"plain={plain:.4f} ms")
        total_ms += calls * ms
        total_plain += calls * plain
    log(f"kernel {name} per frame (8 launches): kernel={total_ms:.4f} ms "
        f"plain={total_plain:.4f} ms")
    return total_ms, total_plain


def phase_serial(frames, cfg):
    """The serial kernel's own path, lk_level(variant="serial"), driven
    with the counts at 0: the bench shapes, and the finest level's
    forward call with guesses 10-20 px off, where the working-subpatch
    clamp must bind (slots whose result differs from the batched
    variant's); then its times against the plain version's."""
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel

    _, args, kw, label = list(bench_level_calls(
        frames, cfg, guess_px=(10.0, 20.0)))[2]
    lk_kernel.lk_level.launches = lk_kernel.lk_level.serial_launches = 0
    worst, calls = check_kernel(
        frames, cfg, "serial",
        extra=[(args, kw, label + " guesses 10-20 px off"),
               unaligned_call(frames, cfg)])
    launches = lk_kernel.lk_level.serial_launches
    log(f"serial path: lk_level serial launches={launches} (expected "
        f"{calls}), batched launches={lk_kernel.lk_level.launches} "
        f"(expected 0)")
    if launches != calls or lk_kernel.lk_level.launches:
        fail("the serial path did not launch the serial kernel once per "
             "call")
    tr_s = lk_kernel.lk_level_reference(*args, **kw, variant="serial")[0]
    tr_b = lk_kernel.lk_level_reference(*args, **kw)[0]
    binds = int(((tr_s - tr_b).abs().amax(-1) > 1e-2)[args[5]].sum())
    log(f"serial path: guesses 10-20 px off: {binds} of "
        f"{int(args[5].sum())} active slots end more than 0.01 px from the "
        f"batched variant's result (the subpatch clamp binds)")
    if not binds:
        fail("the far-guess call never made the subpatch clamp bind")
    return (launches, worst) + time_kernel(frames, cfg, "serial")


def _frame_ids(frames_json):
    return {f["frame"]: sorted(f["ids"]) for f in frames_json}


def phase_main_path(card):
    """mcmtt_opticalflow_tpu_torch.bench.run_bench on the card: bench.py's
    protocol at its config and scene, its LK launches counted from 0, its
    CPU LK calls counted, frame CAPTURE_FRAME's lk_level calls recorded
    and the host JV timed; its MOTA triple held against the CPU record
    (bench_reference.json: `jax`, the JAX engine; `plain`, the port with
    the LK kernel's plain version); then the solver's threefry draw
    timed alone."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch import bench
    from mcmtt_opticalflow_tpu_torch.models import tracker2d
    from mcmtt_opticalflow_tpu_torch.models.mwcp import threefry_fields
    from mcmtt_opticalflow_tpu_torch.ops import lk, lk_kernel
    from mcmtt_opticalflow_tpu_torch.utils import prng

    total = WARMUP + MEASURED
    # count any LK work that runs on the CPU during the main path
    cpu_calls = {"lk_level_reference": 0, "lk_track_points": 0}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            cpu_calls[name] += 1
            return fn(*a, **k)
        setattr(mod, name, wrapped)
        return fn

    orig_ref = counting(lk_kernel, "lk_level_reference")
    orig_pts = counting(lk, "lk_track_points")
    # host time of the 2D stage's assignment (numpy JV), per frame
    jv_s = []
    orig_jv = tracker2d.solve_assignment_batch

    def timed_jv(*a):
        t0 = time.perf_counter()
        out = orig_jv(*a)
        jv_s.append(time.perf_counter() - t0)
        return out
    tracker2d.solve_assignment_batch = timed_jv
    capture = LkCapture(CAPTURE_FRAME)
    capture.install()
    lk_kernel.lk_level.launches = 0
    try:
        run = bench.run_bench(MEASURED, "cuda",
                              on_frame=lambda t: setattr(capture, "frame", t))
    finally:
        lk_kernel.lk_level_reference = orig_ref
        lk.lk_track_points = orig_pts
        tracker2d.solve_assignment_batch = orig_jv
        capture.remove()
    launches = lk_kernel.lk_level.launches
    rec = run.record
    log(f"main path: run_bench({MEASURED}, 'cuda'), {total} frames, "
        f"lk_level launches={launches} (expected {8 * total}), CPU LK "
        f"calls={cpu_calls}")
    if launches != 8 * total:
        fail(f"expected {8 * total} LK kernel launches, got {launches}")
    if any(cpu_calls.values()):
        fail(f"LK ran on the CPU during the main path: {cpu_calls}")
    if len(capture.calls) != 8:
        fail(f"recorded {len(capture.calls)} lk_level calls of frame "
             f"{CAPTURE_FRAME}, expected 8")
    if rec["lk_route"] != "cuda" or rec["frames"] != MEASURED:
        fail(f"main path: unexpected record {rec}")
    for r in run.engine.results:
        pts = np.asarray(r.points)
        if len(r.ids) != len(pts) or (pts.size and (
                pts.shape[1] != 3 or not np.isfinite(pts).all())):
            fail(f"malformed result at frame {r.frame_idx}")
    log(f"main path: {rec['value']} frames/s median over "
        f"{len(run.per_frame)} frames on {card}")
    log(f"main path: per-frame s {[round(x, 4) for x in run.per_frame]}")
    log(f"main path: stage medians ms {json.dumps(rec['stage_ms'])}")
    log(f"main path: host solve_assignment_batch median "
        f"{1e3 * float(np.median(jv_s[WARMUP:])):.3f} ms/frame "
        f"(max {1e3 * max(jv_s[WARMUP:]):.3f})")
    quality = {f"mota_w{w}": run.evals[w].mota for w in WINDOWS}
    log(f"main path: tracks_peak={rec['tracks_peak']} "
        f"pool_dropped={rec['pool_dropped']} {json.dumps(quality)}")
    for w in WINDOWS:
        log(f"main path: w{w}: {run.evals[w].summary()}")
    log(f"main path: bench record {json.dumps(rec)}")
    if not all(np.isfinite(list(quality.values()))) or quality["mota_w0"] \
            <= 0.5:
        fail(f"MOTA out of range: {quality}")

    path = os.path.join(os.path.dirname(bench.__file__),
                        "bench_reference.json")
    with open(path) as f:
        ref = json.load(f)
    card_mota = [quality[f"mota_w{w}"] for w in WINDOWS]
    for name in ("jax", "plain"):
        log(f"main path: MOTA w0/w3/w6 card "
            f"{[round(float(m), 4) for m in card_mota]}"
            f" tracks_peak {rec['tracks_peak']} against {name} "
            f"{ref[name]['mota']} tracks_peak {ref[name]['tracks_peak']} "
            f"({ref[name]['command']})")
    want = _frame_ids(ref["plain"]["frames"])
    got = {r["frame"]: sorted(r["ids"]) for r in run.results}
    first = next((t for t in sorted(want) if got.get(t) != want[t]), None)
    log(f"main path: first frame whose 3D ids leave the plain CPU record: "
        f"{first} (of {len(want)})")
    gap = max(abs(c - p) for c, p in zip(card_mota, ref["plain"]["mota"]))
    log(f"main path: max |card - plain| MOTA {gap:.4f} (bound {MOTA_BOUND})")
    if gap > MOTA_BOUND:
        fail(f"the card's MOTA leaves the plain CPU record by {gap:.4f} "
             f"(bound {MOTA_BOUND})")

    # the solver's random fields of one bench frame, drawn alone
    r = bench.bench_config().solver.num_replicas + \
        bench.bench_config().assoc3d.k_best_size
    key = prng.split(prng.prng_key(0))[1]
    draw_ms = time_ms(lambda: threefry_fields(key, r, 1024, 150, "cuda"),
                      reps=10)
    log(f"main path: threefry field draw (R={r}, V=1024, 150 iterations: "
        f"{2 * 150 * r * 1024 + 2 * 150 * r + r * 1024} numbers) "
        f"{draw_ms:.3f} ms a frame (CUDA events, median of 10) on {card}")
    return launches, capture.calls


def phase_real_inputs(calls):
    """Both kernels on the main path's own inputs (phase 3b): checked
    against the plain version, timed device-only and per wrapper call,
    and held against their bound.  Returns {variant: summary}."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel

    lib = lk_kernel.build()
    margin = lib.lk_level_stage_margin()
    d = []
    for args, kw in calls:
        tr = lk_kernel.lk_level_reference(*args, **kw)[0]
        d.append((tr - args[4])[args[5]].abs().amax(-1))
    d = torch.cat(d).cpu().numpy()
    q = np.percentile(d, [50, 90, 99])
    log(f"real inputs: {len(calls)} lk_level calls of frame "
        f"{CAPTURE_FRAME}; |final - initial estimate| (max over x, y; "
        f"plain version) over {d.size} active features: p50={q[0]:.3f} "
        f"p90={q[1]:.3f} p99={q[2]:.3f} max={d.max():.3f} px; "
        f"{float((d <= margin).mean()):.4f} within the kernel's "
        f"{margin} px staging margin")
    stream = torch.cuda.current_stream().cuda_stream
    noop = device_us(lambda: lib.lk_noop_launch(stream))
    log(f"real inputs: empty kernel {noop:.3f} us per launch (device-only, "
        f"timed like the LK kernel)")
    out = {}
    for variant in lk_kernel.VARIANTS:
        name = "lk_level" if variant == "batched" else "lk_level_serial"
        tot = dict(dev=0.0, host=0.0, plain=0.0, bound=0.0, t_bytes=0.0,
                   t_ops=0.0, err=0.0)
        for args, kw in calls:
            _, h, w = args[0].shape
            label = (f"kernel {name} real [{args[0].shape[0]},{h},{w}] "
                     f"N={args[3].shape[0]} active={int(args[5].sum())}")
            d_tr, msg = compare(args, kw, variant, label)
            log(msg)
            dev = device_us(prepared_launch(args, kw, variant))
            host = host_us(lambda: lk_kernel.lk_level(*args, **kw,
                                                      variant=variant))
            plain = time_ms(lambda: lk_kernel.lk_level_reference(
                *args, **kw, variant=variant), reps=5)
            work = lk_kernel.lk_level_work(*args, **kw, variant=variant)
            t_bytes = 1e6 * work["bytes"] / HBM_BYTES_PER_S
            t_ops = 1e6 * work["flops"] / FP32_FLOPS_PER_S
            bound = max(t_bytes, t_ops)
            log(f"{label}: device-only {dev:.3f} us/launch, wrapper host "
                f"{host:.3f} us/call, plain {plain:.4f} ms; work "
                f"{work['bytes']} B ({work['image_bytes']} B of image), "
                f"{work['flops']} flop, {work['steps']} Newton steps; "
                f"bound {bound:.4f} us ("
                f"{'bytes' if t_bytes >= t_ops else 'operations'}), "
                f"roofline share {bound / dev:.4f}")
            for k, v in (("dev", dev), ("host", host), ("plain", plain),
                         ("bound", bound), ("t_bytes", t_bytes),
                         ("t_ops", t_ops)):
                tot[k] += v
            tot["err"] = max(tot["err"], d_tr)
        n = len(calls)
        bound_by = "bytes" if tot["t_bytes"] >= tot["t_ops"] else \
            "operations"
        log(f"kernel {name} real frame ({n} launches): device-only "
            f"{tot['dev'] / 1e3:.4f} ms, wrapper host "
            f"{tot['host'] / 1e3:.4f} ms, plain {tot['plain']:.4f} ms, "
            f"bound {tot['bound'] / 1e3:.6f} ms ({bound_by}), roofline "
            f"share {tot['bound'] / tot['dev']:.4f}; empty-kernel floor "
            f"{n * noop / 1e3:.4f} ms")
        out[variant] = {
            "ms": tot["dev"] / 1e3, "plain_ms": tot["plain"],
            "bound_ms": tot["bound"] / 1e3, "bound_by": bound_by,
            "device_us_per_launch": tot["dev"] / n,
            "host_us_per_call": tot["host"] / n,
            "bound_us": tot["bound"] / n, "max_abs_err": tot["err"]}
    return out


def phase_modes_agree(cfg, sc, frames):
    import numpy as np
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine

    n = 8
    seq = TrackingEngine(cfg, sc.cameras, device="cuda")
    pipe = TrackingEngine(cfg, sc.cameras, pipelined=True, device="cuda")
    rs, rp = [], []
    for t in range(n):
        rs.append(seq.process_frame(frames[t], sc.detections[t],
                                    frame_idx=t))
        r = pipe.process_frame(frames[t], sc.detections[t], frame_idx=t)
        if r is not None:
            rp.append(r)
    while True:
        r = pipe.flush()
        if r is None:
            break
        rp.append(r)
    if len(rs) != len(rp):
        fail(f"modes: {len(rs)} sequential vs {len(rp)} pipelined results")
    for a, b in zip(rs, rp):
        if a.frame_idx != b.frame_idx or a.ids != b.ids or \
                not np.array_equal(a.points, b.points):
            fail(f"modes disagree at frame {a.frame_idx}")
    log(f"modes agree: sequential == pipelined over {n} frames "
        f"({sum(len(r.ids) for r in rs)} tracked objects)")


def phase_cpu_reference():
    """The 2D stage on the card (LK kernel) against the same stage on the
    CPU (LK plain version) on a small scene."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.config import Tracker2DConfig
    from mcmtt_opticalflow_tpu_torch.data import make_scenario
    from mcmtt_opticalflow_tpu_torch.geometry.tsai import stack_cameras
    from mcmtt_opticalflow_tpu_torch.models.tracker2d import (
        init_tracker2d_state, tracker2d_step)

    cfg = Tracker2DConfig(max_detections=16, max_trackers=32,
                          max_features=16, lk_window=8,
                          lk_pyramid_levels=2, lk_iterations=8)
    sc = make_scenario(num_cameras=2, num_frames=8, num_people=4,
                       image_size=(256, 192), arena=4000.0, seed=3)
    outs = {}
    for dev in ("cuda", "cpu"):
        cams = stack_cameras(sc.cameras, dev)
        state = init_tracker2d_state(cfg, 192, 256, 2, device=dev)
        seq = []
        for t in range(8):
            gray = torch.tensor(np.stack(sc.frames(t)).mean(-1),
                                dtype=torch.float32, device=dev)
            det = np.zeros((2, 16, 4), np.float32)
            mask = np.zeros((2, 16), bool)
            for c in range(2):
                k = min(len(sc.detections[t][c]), 16)
                det[c, :k] = sc.detections[t][c][:k]
                mask[c, :k] = True
            state, out = tracker2d_step(state, gray,
                                        torch.tensor(det, device=dev),
                                        torch.tensor(mask, device=dev),
                                        cams, t, cfg)
            seq.append([x.cpu().numpy() for x in
                        (out.ids, out.mask, out.det_mask, out.boxes)])
        outs[dev] = seq
    n_obj = 0
    for t, (g, c) in enumerate(zip(outs["cuda"], outs["cpu"])):
        if not all(np.array_equal(a, b) for a, b in zip(g[:3], c[:3])) or \
                np.abs(g[3] - c[3]).max() > 1e-3:
            fail(f"2D stage on the card differs from the CPU at frame {t}")
        n_obj += int(g[1].sum())
    log(f"2D stage card == CPU over 8 frames ({n_obj} tracklet outputs)")


def _hold(label, got, ref, rtol=0.0, atol=0.0, exact=False):
    """One card result against the same call on the CPU; fails beyond the
    stated tolerance.  Returns the largest |difference|."""
    import numpy as np
    import torch
    g = got.detach().cpu() if isinstance(got, torch.Tensor) else got
    g, r = np.asarray(g), np.asarray(ref)
    if g.shape != r.shape:
        fail(f"api {label}: shape {g.shape} on the card, {r.shape} on the "
             f"CPU")
    if exact or g.dtype == bool:
        if not np.array_equal(g, r):
            fail(f"api {label}: card and CPU differ (exact check)")
        return 0.0
    err = float(np.abs(g.astype(np.float64) - r).max()) if g.size else 0.0
    if not np.allclose(g, r, rtol=rtol, atol=atol):
        fail(f"api {label}: card and CPU differ by {err:.3e} (rtol "
             f"{rtol}, atol {atol})")
    return err


def phase_api(cfg, sc, frames):
    """Every public device function this slice adds, on the card and on
    the CPU on the same seeded inputs, at the tolerances of the CPU parity
    tests (tests/test_torch_api.py); the device RGB histogram of a bench
    frame with 48 boxes must equal host_rgb_histogram exactly."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.geometry import (
        back_projection_line, camera_position, nview_ground_reconstruction,
        nview_point_reconstruction, stack_cameras, world_to_image)
    from mcmtt_opticalflow_tpu_torch.models.costs import (
        enter_probability, exit_cost, tracklet_connectivity)
    from mcmtt_opticalflow_tpu_torch.models.mwcp import (
        MwcpFields, collect_k_best, solve_mwcp_batch, threefry_fields)
    from mcmtt_opticalflow_tpu_torch.ops import (gaussian_blur_3x3,
                                                 rgb_histogram, sg_smooth)
    from mcmtt_opticalflow_tpu_torch.ops.histogram import (
        host_rgb_histogram, rgb_cost)
    from mcmtt_opticalflow_tpu_torch.config import SolverConfig
    from mcmtt_opticalflow_tpu_torch.utils import prng

    rng = np.random.RandomState(0)
    acfg = cfg.assoc3d
    worst = {}

    def both(label, fn, inputs, **tol):
        """fn on the card and on the CPU; inputs are numpy arrays."""
        outs = []
        for dev in ("cuda", "cpu"):
            args = [torch.tensor(x, device=dev) if isinstance(x, np.ndarray)
                    else x for x in inputs]
            out = fn(dev, *args)
            outs.append(out if isinstance(out, tuple) else (out,))
        for i, (g, r) in enumerate(zip(*outs)):
            worst[f"{label}[{i}]"] = _hold(f"{label}[{i}]", g, r.cpu(),
                                           **tol)

    uv = rng.uniform(-20, 790, (4, 64, 2)).astype(np.float32)
    both("camera_position",
         lambda d: camera_position(stack_cameras(sc.cameras, d)), [],
         rtol=1e-5)
    both("back_projection_line",
         lambda d, p: back_projection_line(
             stack_cameras(sc.cameras, d).expand(1), p), [uv], rtol=1e-5)
    # the associator's lines: each bench camera's back-projection (z=2000
    # and z=0 ends) of a person's position, seen with 1 px of noise
    ex = stack_cameras(sc.cameras).expand(1)
    target = np.concatenate([rng.uniform(-4000, 4000, (1, 256, 2)),
                             rng.uniform(0, 1800, (1, 256, 1))], -1)
    seen = world_to_image(ex, torch.tensor(target, dtype=torch.float32))
    seen = seen + torch.tensor(rng.normal(0, 1, (4, 256, 2)),
                               dtype=torch.float32)
    tops, bottoms = [x.transpose(0, 1).numpy()
                     for x in back_projection_line(ex, seen)]
    mask = rng.rand(256, 4) < 0.6
    mask[:5] = np.arange(4)[None, :] < np.arange(5)[:, None]
    both("nview_point_reconstruction.point",
         lambda d, a, b, m: nview_point_reconstruction(a, b, m)[0],
         [tops, bottoms, mask], atol=1e-2)
    both("nview_point_reconstruction.dist",
         lambda d, a, b, m: nview_point_reconstruction(a, b, m)[1:],
         [tops, bottoms, mask], rtol=1e-4, atol=1e-4)
    ground = bottoms * np.asarray([1, 1, 0], np.float32)
    both("nview_ground_reconstruction",
         lambda d, g, m: nview_ground_reconstruction(g, m),
         [ground, mask], rtol=1e-4, atol=1e-2)
    gray = (frames[0].mean(-1) / 255.0).astype(np.float32)
    both("gaussian_blur_3x3", lambda d, x: gaussian_blur_3x3(x), [gray],
         atol=1e-6)
    for n in (5, 23):
        both(f"sg_smooth[n={n}]", lambda d, x: sg_smooth(x),
             [rng.rand(n, 3).astype(np.float32)], atol=1e-6)
    rgb = frames[0][0]                               # [576, 768, 3] u8
    boxes = np.concatenate([rng.uniform(-30, 740, (48, 1)),
                            rng.uniform(-30, 540, (48, 1)),
                            rng.uniform(8, 120, (48, 1)),
                            rng.uniform(20, 260, (48, 1))],
                           -1).astype(np.float32)
    hist = rgb_histogram(torch.tensor(rgb, device="cuda"),
                         torch.tensor(boxes, device="cuda"))
    worst["rgb_histogram(u8)==host"] = _hold(
        "rgb_histogram u8 vs host_rgb_histogram", hist,
        host_rgb_histogram(rgb, boxes), exact=True)
    both("rgb_histogram(float)", lambda d, x, b: rgb_histogram(x, b),
         [rgb.astype(np.float32) / 255.0, boxes], exact=True)
    f1 = rng.rand(64, 48).astype(np.float32) * 0.3
    f2 = rng.rand(64, 48).astype(np.float32) * 0.3
    gaps = (np.arange(64) % 5 + 1).astype(np.float32)
    both("rgb_cost", lambda d, a, b, g: rgb_cost(a, b, g), [f1, f2, gaps],
         rtol=1e-5, atol=1e-6)
    dist = rng.uniform(-500, 6000, 256).astype(np.float32)
    free = rng.rand(256) < 0.3
    length = rng.randint(0, 40, 256).astype(np.float32)
    both("enter_probability",
         lambda d, x, f: enter_probability(x, f, acfg), [dist, free],
         rtol=1e-5, atol=1e-6)
    both("exit_cost", lambda d, x, n: exit_cost(x, n, acfg), [dist, length],
         rtol=1e-5, atol=1e-6)
    e = rng.uniform(-3000, 3000, (256, 3)).astype(np.float32)
    s = rng.uniform(-3000, 3000, (256, 3)).astype(np.float32)
    sens = rng.uniform(0, 400, (2, 256)).astype(np.float32)
    both("tracklet_connectivity",
         lambda d, a, b, s1, s2, g: tracklet_connectivity(a, b, s1, s2, g,
                                                          acfg),
         [e, s, sens[0], sens[1], rng.randint(1, 4, 256)], exact=True)

    b, v, n = 3, 48, 40
    scfg = SolverConfig(num_replicas=6, max_vertices=v,
                        solutions_per_replica=8)
    weights = np.zeros((b, v), np.float32)
    weights[:, :n] = rng.rand(b, n) * 10
    up = np.triu(rng.rand(b, v, v) < 0.45, 1)
    valid = np.zeros((b, v), bool)
    valid[:, :n] = True
    adj = (up | up.transpose(0, 2, 1)) & valid[:, :, None] \
        & valid[:, None, :]
    init = np.zeros((b, v), bool)
    class CpuDrawn:
        """The threefry fields of `key` drawn on the CPU, so the card and
        the CPU solve on the same bits (the gumbel logs round per
        device)."""

        def __init__(self, key):
            self.key = key

        def draw(self, r, v, iters_pad, device):
            f = threefry_fields(self.key, r, v, iters_pad, "cpu")
            return MwcpFields(*[x.to(device) for x in f])
    res = {}
    for dev in ("cuda", "cpu"):
        res[dev] = solve_mwcp_batch(
            *[torch.tensor(x, device=dev) for x in (weights, adj, valid,
                                                    init)],
            [CpuDrawn(prng.prng_key(40 + i)) for i in range(b)], scfg, 90)
    for f in res["cuda"]._fields:
        exact = f in ("best_mask", "sol_masks")
        worst[f"solve_mwcp_batch.{f}"] = _hold(
            f"solve_mwcp_batch.{f}", getattr(res["cuda"], f),
            getattr(res["cpu"], f), atol=1e-4, exact=exact)
    for i in range(b):
        kb = [collect_k_best(type(r)(*[x[i] for x in r]), 10)
              for r in (res["cuda"], res["cpu"])]
        if len(kb[0][0]) != len(kb[1][0]) or not all(
                np.array_equal(x, y) for x, y in zip(kb[0][0], kb[1][0])) \
                or not np.allclose(kb[0][1], kb[1][1], atol=1e-4):
            fail(f"api collect_k_best: card and CPU lists differ "
                 f"(instance {i})")
    log(f"api: {len(worst)} checks, card == CPU within the tests' "
        f"tolerances; largest |difference| per check "
        f"{json.dumps({k: float(f'{x:.3e}') for k, x in worst.items()})}")
    check_xla_route(frames)


def pyramid_call(frames, dev):
    """The phase-7 lk_track_pyramid call on `dev`: one 768x576 pair of
    camera 0, 3 levels, N=1024 points, w=16, 10 iterations; returns a
    zero-argument call and the point count."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import lk_track_pyramid

    n = 1024
    rng = np.random.RandomState(1)
    g0 = (frames[WARMUP][0].mean(-1) / 255.0).astype(np.float32)
    g1 = (frames[WARMUP + 1][0].mean(-1) / 255.0).astype(np.float32)
    pts = np.stack([rng.uniform(16, 752, n), rng.uniform(16, 560, n)],
                   -1).astype(np.float32)
    args = [torch.tensor(x, device=dev) for x in (g0, g1, pts)]
    return (lambda: lk_track_pyramid(*args, levels=3, window=16,
                                     iterations=10)), n


def pyramid_on_card_and_cpu(frames, label):
    """The pyramid call on the card (its LK kernel launches counted from
    0) and on the CPU, held against each other at the limits of phase 2.
    Returns (launches, the line to log)."""
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel

    card, n = pyramid_call(frames, "cuda")
    lk_kernel.lk_level.launches = 0
    tr_k, ok_k, res_k = [x.cpu() for x in card()]
    launches = lk_kernel.lk_level.launches
    tr_r, ok_r, res_r = pyramid_call(frames, "cpu")[0]()
    agree = (ok_k == ok_r).float().mean().item()
    both = ok_k & ok_r
    d_tr = (tr_k - tr_r)[both].abs().max().item()
    d_res = (res_k - res_r)[both].abs().max().item()
    msg = (f"{label}: [576,768] 3 levels N={n}: lk_level launches="
           f"{launches}, valid={int(ok_k.sum())} valid-agree={agree:.6f} "
           f"max|dtracked|={d_tr:.3e} px max|dresid|={d_res:.3e} vs the CPU")
    if int(both.sum()) < n // 2 or agree < 0.999 or d_tr > 1e-3 \
            or d_res > 1e-4:
        fail(f"{label} on the card disagrees with the CPU: {msg}")
    return launches, msg


def check_xla_route(frames):
    """MCMTT_LK_BACKEND=xla, set for one lk_track_pyramid call on the
    card: the switch is honoured on the CPU only, so every level still
    launches the LK kernel, and the result equals the same card call
    without the switch at the limits of phase 2."""
    call = pyramid_call(frames, "cuda")[0]
    want = [x.cpu() for x in call()]
    os.environ["MCMTT_LK_BACKEND"] = "xla"
    try:
        from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
        lk_kernel.lk_level.launches = 0
        got = [x.cpu() for x in call()]
        launches = lk_kernel.lk_level.launches
    finally:
        del os.environ["MCMTT_LK_BACKEND"]
    agree = (got[1] == want[1]).float().mean().item()
    d_tr = (got[0] - want[0])[got[1] & want[1]].abs().max().item()
    d_res = (got[2] - want[2])[got[1] & want[1]].abs().max().item()
    log(f"api: lk_track_pyramid on the card with MCMTT_LK_BACKEND=xla: "
        f"lk_level launches={launches} (expected 3: the switch is for CPU "
        f"runs), valid-agree={agree:.6f} max|dtracked|={d_tr:.3e} px "
        f"max|dresid|={d_res:.3e} vs the call without the switch")
    if launches != 3:
        fail(f"MCMTT_LK_BACKEND=xla moved the card off the LK kernel: "
             f"{launches} launches, expected 3")
    if agree < 0.999 or d_tr > 1e-3 or d_res > 1e-4:
        fail("MCMTT_LK_BACKEND=xla changed the card's lk_track_pyramid")


def phase_lk_track_pyramid(frames):
    """ops/lk.py::lk_track_pyramid on one 768x576 frame pair, 3 levels,
    N=1024, w=16, 10 iterations: every level (576x768, 288x384, 144x192)
    is the kernel's shape, so the call launches the batched kernel 3
    times; held against the same call on the CPU (plain version)."""
    launches, msg = pyramid_on_card_and_cpu(frames, "lk_track_pyramid")
    ms = time_ms(pyramid_call(frames, "cuda")[0])
    log(f"{msg} (expected 3); {ms:.4f} ms per call on the card")
    if launches != 3:
        fail(f"lk_track_pyramid launched the batched kernel {launches} "
             f"times, expected 3")
    return launches


def _run_engine(eng, sc, frames, n):
    """n frames through a pipelined engine and its flush: the results."""
    out = []
    for t in range(n):
        r = eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
        if r is not None:
            out.append(r)
    while True:
        r = eng.flush()
        if r is None:
            return out
        out.append(r)


def phase_mesh(cfg, sc, frames):
    """The bench configuration for MESH_FRAMES frames without a mesh and
    on make_mesh(devices=[cuda:0] * 4) (cam 4 x block 1: four camera
    groups of one camera, one after another on the card): equal ids,
    points within 1 mm.  Then solve_mwcp_sharded at V=1024, R=38, 150
    iterations over 2 blocks on the card against the two per-block
    solve_mwcp calls plus the global argmax."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
    from mcmtt_opticalflow_tpu_torch.parallel import make_mesh
    from mcmtt_opticalflow_tpu_torch.parallel.multihost_sim import run_solve

    card0 = torch.device("cuda", 0)
    plain = TrackingEngine(cfg, sc.cameras, pipelined=True, device="cuda")
    t0 = time.perf_counter()
    ra = _run_engine(plain, sc, frames, MESH_FRAMES)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    mesh = make_mesh(devices=[card0] * 4)
    eng = TrackingEngine(cfg, sc.cameras, pipelined=True, mesh=mesh)
    lk_kernel.lk_level.launches = 0
    t0 = time.perf_counter()
    rb = _run_engine(eng, sc, frames, MESH_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lk_kernel.lk_level.launches
    if mesh.shape != {"cam": 4, "block": 1} or len(eng.state2d_groups) != 4:
        fail(f"mesh: expected 4 camera groups, got {mesh.shape}")
    if len(ra) != len(rb) or not ra:
        fail(f"mesh: {len(ra)} results without the mesh, {len(rb)} with it")
    d_pts, n_obj = 0.0, 0
    for a, b in zip(ra, rb):
        if a.frame_idx != b.frame_idx or a.ids != b.ids:
            fail(f"mesh: ids differ at frame {a.frame_idx}: {a.ids} vs "
                 f"{b.ids}")
        if len(a.ids):
            d_pts = max(d_pts, float(np.abs(np.asarray(a.points)
                                            - np.asarray(b.points)).max()))
        n_obj += len(a.ids)
    log(f"mesh: {mesh} engine == engine without a mesh over {MESH_FRAMES} "
        f"frames ({n_obj} tracked objects, max |d point| {d_pts:.3e} mm); "
        f"lk_level launches={launches} (expected {32 * MESH_FRAMES}: 8 per "
        f"camera group per frame); {wall:.2f} s against {wall_plain:.2f} s "
        f"without the mesh")
    if d_pts > 1.0:
        fail(f"mesh: points differ by {d_pts} mm (limit 1.0)")
    if launches <= 0:
        fail("mesh: the mesh run launched no LK kernel")

    bmesh = make_mesh(num_cam_shards=1, devices=[card0] * 2)
    s = run_solve(bmesh, bench=True, reps=1)
    log(f"mesh: solve_mwcp_sharded V=1024 (700 valid) R=38 150 iterations "
        f"over {bmesh}: best {s['best_score']:.4f}, a clique of "
        f"{len(s['best_mask'])}: {s['clique']}; equals the per-block solves "
        f"+ argmax: {s['equals_per_block']}; {s['mesh_s']:.2f} s (one block "
        f"{s['one_s']:.2f} s)")
    if not (s["equals_per_block"] and s["clique"]):
        fail("mesh: solve_mwcp_sharded differs from its per-block solves")
    return launches, rb, wall


def phase_multiprocess(mesh_results, mesh_wall, card):
    """parallel/multihost_sim.py --bench in two processes on the one card,
    each holding two cuda:0 entries of the global cam 4 x block 1 mesh.
    They join by gloo: NCCL refuses two ranks on one GPU, and gloo
    stages the collectives' data through the host.  Each process steps
    its two camera groups (16 LK launches a frame, counted in the
    process), scores its chunks of the fused 3D program's rows, and runs
    the rest of the 3D stage whole: both must give phase_mesh's mesh-run
    ids frame by frame, points within 1 mm.  Their solve over a 1 x 4
    mesh (two blocks each) must equal its per-block solves plus the
    argmax, the same in both.  Each process is killed at MP_LIMIT_S.
    Returns the LK launches of both processes."""
    import tempfile
    import numpy as np
    from mcmtt_opticalflow_tpu_torch.parallel import multihost_sim

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report, outs = multihost_sim.spawn(
            2, ["--local-devices", "cuda:0,cuda:0", "--backend", "gloo",
                "--bench", "--engine-frames", str(MESH_FRAMES)], tmp,
            MP_LIMIT_S)
    wall = time.perf_counter() - t0
    for pid, (rc, _, err, res) in enumerate(outs):
        if rc != 0 or res is None:
            for line in err.strip().splitlines()[-20:]:
                log(f"multiprocess| process {pid}: {line}")
            fail(f"multiprocess: process {pid} exited {rc} (limit "
                 f"{MP_LIMIT_S} s) {'with' if res else 'without'} a result")
    if report is None:
        fail("multiprocess: process 0 wrote no scaling report")
    want = [(r.frame_idx, [int(i) for i in r.ids], np.asarray(r.points))
            for r in mesh_results]
    keys = ("best_score", "best_mask", "all_masks_sha256",
            "all_scores_sha256")
    launches = 0
    for pid, (*_, res) in enumerate(outs):
        eng, solver = res["engine"], res["solver"]
        got = [(f["frame"], f["ids"], np.reshape(f["points"], (-1, 3)))
               for f in eng["frames"]]
        if [g[:2] for g in got] != [w[:2] for w in want]:
            bad = next((w[0] for g, w in zip(got, want) if g[:2] != w[:2]),
                       None)
            fail(f"multiprocess: process {pid}'s ids differ from the mesh "
                 f"run (first at frame {bad}; {len(got)} frames against "
                 f"{len(want)})")
        d_pts = max([float(np.abs(g[2] - w[2]).max())
                     for g, w in zip(got, want) if len(w[1])] or [0.0])
        coll = float(np.median(eng["collective_s_per_call"]))
        n_coll = float(np.median(eng["collectives_per_call"]))
        log(f"multiprocess: process {pid} ({res['mesh']}): camera groups "
            f"{eng['groups_here']}, blocks {solver['blocks_here']}; ids == "
            f"the mesh run over {MESH_FRAMES} frames, max |d point| "
            f"{d_pts:.3e} mm; lk_level launches={eng['lk_launches']} "
            f"(expected {16 * MESH_FRAMES}); engine {eng['wall_s']:.2f} s "
            f"against {mesh_wall:.2f} s for the one-process mesh run; "
            f"median {1e3 * coll:.3f} ms a frame in {n_coll:g} "
            f"collectives; solve best "
            f"{solver['best_score']:.4f}, equals its per-block solves: "
            f"{solver['equals_per_block']}, {solver['mesh_s']:.3f} s "
            f"sharded against {solver['one_s']:.3f} s for one block")
        if d_pts > 1.0:
            fail(f"multiprocess: points differ by {d_pts} mm (limit 1.0)")
        if eng["lk_launches"] != 16 * MESH_FRAMES:
            fail(f"multiprocess: process {pid} launched the LK kernel "
                 f"{eng['lk_launches']} times, expected {16 * MESH_FRAMES}")
        if not (solver["equals_per_block"] and solver["clique"]
                and res["fetch_ok"]):
            fail(f"multiprocess: process {pid}'s solve or fetch failed its "
                 f"checks")
        if {k: solver[k] for k in keys} != {
                k: outs[0][3]["solver"][k] for k in keys}:
            fail("multiprocess: the processes' solves differ")
        if eng["collectives_per_call"] != \
                outs[0][3]["engine"]["collectives_per_call"]:
            fail("multiprocess: the processes made different collectives")
        launches += eng["lk_launches"]
    report.pop("frames")
    log(f"multiprocess: scaling_report {json.dumps(report)} on {card}; both "
        f"processes in {wall:.1f} s")
    return launches


def phase_profile(cfg, sc, frames):
    """profile_trace around PROFILE_FRAMES steady frames of the bench main
    path (a fresh pipelined engine, warmed up for WARMUP frames): the
    device's busy share over the window, device ms per frame, the top 5
    kernels, and the count of lk_level_kernel events, which must equal
    the wrapper's count of launches in the window (8 per frame)."""
    import tempfile
    import torch
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
    from mcmtt_opticalflow_tpu_torch.utils import profile_trace
    from mcmtt_opticalflow_tpu_torch.utils.timing import summarize_trace

    eng = TrackingEngine(cfg, sc.cameras, pipelined=True, device="cuda")
    for t in range(WARMUP):
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        lk_kernel.lk_level.launches = 0
        t0 = time.perf_counter()
        with profile_trace(logdir):
            for t in range(WARMUP, WARMUP + PROFILE_FRAMES):
                eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
        wall = time.perf_counter() - t0
        launches = lk_kernel.lk_level.launches
        s = summarize_trace(logdir)
    n_lk = sum(c for k, c in s.kernel_counts.items()
               if "lk_level_kernel" in k)
    top = [(k[:60], round(ms, 4), c) for k, ms, c in s.top_kernels]
    log(f"profile: {PROFILE_FRAMES} steady bench frames under "
        f"torch.profiler ({wall:.2f} s): device busy share "
        f"{s.busy_share:.4f} of the window, {s.device_ms / PROFILE_FRAMES:.3f}"
        f" device ms per frame, {sum(s.kernel_counts.values())} kernel "
        f"events, lk_level_kernel events={n_lk} (wrapper launches "
        f"{launches}, expected {8 * PROFILE_FRAMES}); top 5 kernels "
        f"(name, ms, count) {json.dumps(top)}")
    if not s.kernel_counts or s.busy_share <= 0.0:
        fail("profile: the trace holds no device activity")
    if n_lk != 8 * PROFILE_FRAMES or launches != n_lk:
        fail(f"profile: {n_lk} lk_level_kernel events in the trace, "
             f"{launches} launches, expected {8 * PROFILE_FRAMES}")
    return launches


def write_dataset(root, sc, frames):
    """The scene in the reference's dataset layout under `root`, written
    by the port's writers; returns the parameters.txt path."""
    import math
    import os
    from mcmtt_opticalflow_tpu_torch.data import (write_detection_file,
                                                  write_ground_truth,
                                                  write_image)
    from mcmtt_opticalflow_tpu_torch.data.pets import write_tsai_xml

    for ci, cid in enumerate(CLI_CAM_IDS):
        cam = sc.cameras[ci]
        # Euler angles recovered from the rotation (ZYX, as built)
        write_tsai_xml(os.path.join(root, "calibrationInfos",
                                    f"View_{cid:03d}.xml"), cam,
                       rx=math.atan2(float(cam.r32), float(cam.r33)),
                       ry=math.asin(-float(cam.r31)),
                       rz=math.atan2(float(cam.r21), float(cam.r11)))
        for t in range(CLI_FRAMES):
            write_detection_file(
                os.path.join(root, f"View_{cid:03d}", "detectionResult",
                             f"frame_{t:04d}.txt"), sc.detections[t][ci])
            # .ppm: the card's machine has no PIL or cv2 to decode jpeg
            write_image(os.path.join(root, f"View_{cid:03d}",
                                     f"frame_{t:04d}.ppm"), frames[t][ci])
    gx, gy = sc.gt_matrices()
    write_ground_truth(os.path.join(root, "groundTruth", "cropped.txt"),
                       gx, gy)
    params = os.path.join(root, "parameters.txt")
    with open(params, "w") as f:
        f.write(f"DATASET_PATH={root}\n"
                f"CAM_IDS={','.join(str(c) for c in CLI_CAM_IDS)}\n"
                f"START_FRAME_IDX=0\nEND_FRAME_IDX={CLI_FRAMES - 1}\n"
                "SIZE_OF_KS=10\nNUM_EXPERIMENTS=1\n"
                "CROP_ZONE=-9000,-9000,9000,9000\n")
    return params


def phase_cli(card):
    """`python -m mcmtt_opticalflow_tpu_torch.main <parameters.txt>` in
    process on the bench scene in the reference layout, at the default
    EngineConfig; the only cut is the sequence length."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch import main as cli
    from mcmtt_opticalflow_tpu_torch.config import EngineConfig
    from mcmtt_opticalflow_tpu_torch.data import images
    from mcmtt_opticalflow_tpu_torch.eval import experiment
    from mcmtt_opticalflow_tpu_torch.bench import bench_scene
    from mcmtt_opticalflow_tpu_torch.models import pipeline
    from mcmtt_opticalflow_tpu_torch.ops import lk, lk_kernel

    sc, frames = bench_scene(CLI_FRAMES)
    engines, per_frame, sweeps, missing = [], [], [], []
    cpu_calls = {"lk_level_reference": 0, "lk_track_points": 0}

    class Engine(pipeline.TrackingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

        def process_frame(self, *a, **k):
            t0 = time.perf_counter()
            out = super().process_frame(*a, **k)
            per_frame.append(time.perf_counter() - t0)
            return out

    def k_sweep(*a, **k):
        sweeps.append(orig["k_sweep"](*a, **k))
        return sweeps[-1]

    def find_frame(*a):
        p = orig["find_frame"](*a)
        if p is None:
            missing.append(a)
        return p

    def counting(name, fn):
        def wrapped(*a, **k):
            cpu_calls[name] += 1
            return fn(*a, **k)
        return wrapped

    patches = [(pipeline, "TrackingEngine", Engine),
               (experiment, "k_sweep", k_sweep),
               (images, "find_frame", find_frame),
               (lk_kernel, "lk_level_reference",
                counting("lk_level_reference", lk_kernel.lk_level_reference)),
               (lk, "lk_track_points",
                counting("lk_track_points", lk.lk_track_points))]
    orig = {name: getattr(mod, name) for mod, name, _ in patches}
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        params = write_dataset(root, sc, frames)
        log(f"cli: wrote the {CLI_FRAMES}-frame dataset in "
            f"{time.perf_counter() - t0:.1f} s")
        argv = sys.argv
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        sys.argv = ["mcmtt_opticalflow_tpu_torch.main", params]
        lk_kernel.lk_level.launches = lk_kernel.lk_level.serial_launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                cli.main()
            torch.cuda.synchronize()
        finally:
            sys.argv = argv
            for mod, name, _ in patches:
                setattr(mod, name, orig[name])
        wall = time.perf_counter() - t0
    launches = lk_kernel.lk_level.launches
    table = out.getvalue()
    for line in table.splitlines():
        log(f"cli| {line}")
    levels = EngineConfig().tracker2d.lk_pyramid_levels
    lk_per_frame = 4 * levels      # backtrack_interval - 1 backward + 1
    log(f"cli: {len(engines)} engine(s) on "
        f"{sorted({str(e.device) for e in engines})}, lk_level launches="
        f"{launches} (expected {lk_per_frame * CLI_FRAMES}), serial="
        f"{lk_kernel.lk_level.serial_launches}, CPU LK calls={cpu_calls}, "
        f"frames without an image={len(missing)}")
    if not engines or any(e.device.type != "cuda" for e in engines):
        fail("cli: an engine did not run on the card")
    if launches != lk_per_frame * CLI_FRAMES:
        fail(f"cli: expected {lk_per_frame * CLI_FRAMES} LK kernel "
             f"launches, got {launches}")
    if any(cpu_calls.values()):
        fail(f"cli: LK ran on the CPU: {cpu_calls}")
    if missing:
        fail(f"cli: FrameSource fell back to flat gray for {missing[:3]}")
    if "== K=10 repeat=0" not in table or table.count("window=") != 11:
        fail("cli: the CLEAR-MOT table was not printed")
    (res,), = sweeps
    mota = {f"mota_w{w}": res.per_window[w].mota for w in WINDOWS}
    if not all(np.isfinite(list(mota.values()))) or mota["mota_w0"] <= 0.5:
        fail(f"cli: MOTA out of range: {mota}")
    timer = engines[0].assoc.timer
    stage_ms = {name: round(1e3 * sorted(timer.samples[name])
                            [timer.counts[name] // 2], 3)
                for name in sorted(timer.totals,
                                   key=lambda n: -timer.totals[n])
                if not name.startswith("_")}
    log(f"cli: {CLI_FRAMES} frames in {wall:.1f} s on {card}, k_sweep "
        f"{res.fps:.4f} frames/s, median process_frame "
        f"{float(np.median(per_frame)):.4f} s")
    log(f"cli: per-frame s {[round(x, 4) for x in per_frame]}")
    log(f"cli: stage medians ms {json.dumps(stage_ms)}")
    log(f"cli: pool_dropped={engines[0].assoc.pool_dropped_total} "
        f"{json.dumps(mota)}")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    # the switch is honoured for CPU tensors only, and this script's CPU
    # references (and the multiprocess children) are the kernel's plain
    # version: clear it
    if os.environ.pop("MCMTT_LK_BACKEND", None) is not None:
        log("MCMTT_LK_BACKEND cleared: the CPU references here are the LK "
            "kernel's plain version")
    try:
        from mcmtt_opticalflow_tpu_torch.bench import (bench_config,
                                                       bench_scene)
        from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
    except ImportError as e:
        fail(f"run from the repository root: {e}")
    t_start = time.perf_counter()
    card = card_line()
    log(card)          # name, power limit — as nvidia-smi prints them
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    lk_kernel.build()
    log(f"build: lk_level.cu (batched + serial kernels) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in lk_kernel._Kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")

    cfg = bench_config()
    sc, frames = bench_scene(WARMUP + MEASURED)
    d_tr, _ = check_kernel(frames, cfg, "batched",
                           extra=[unaligned_call(frames, cfg)])
    call_ms, _ = time_kernel(frames, cfg, "batched")
    paths = {}
    launches, calls = phase_main_path(card)
    paths["main"] = launches
    real = phase_real_inputs(calls)
    phase_modes_agree(cfg, sc, frames)
    phase_cpu_reference()
    s_launches, s_tr, s_call_ms, _ = phase_serial(frames, cfg)
    phase_api(cfg, sc, frames)
    paths["lk_track_pyramid"] = phase_lk_track_pyramid(frames)
    paths["mesh"], mesh_results, mesh_wall = phase_mesh(cfg, sc, frames)
    paths["multiprocess"] = phase_multiprocess(mesh_results, mesh_wall, card)
    paths["profile"] = phase_profile(cfg, sc, frames)
    paths["cli"] = phase_cli(card)
    torch.cuda.synchronize()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    src = "mcmtt_opticalflow_tpu_torch/ops/csrc/lk_level.cu"
    kernels = []
    for kname, variant, line, n, err, call, by_path in (
            ("lk_level", "batched", 250, launches, d_tr, call_ms, paths),
            ("lk_level_serial", "serial", 35, s_launches, s_tr, s_call_ms,
             {"serial": s_launches})):
        r = real[variant]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"mcmtt_opticalflow_tpu/ops/lk_pallas.py:{line}",
            "launches": n, "max_abs_err": max(err, r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "device_us_per_launch": r["device_us_per_launch"],
            "host_us_per_call": r["host_us_per_call"],
            "bound_us": r["bound_us"], "call_ms_synthetic": call,
            "launches_by_path": by_path})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
