#!/usr/bin/env python
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero), run in
the order 1, 2, 3d, 3e, 10 eager, 3f, 3c, 3b, 4-8b, 10, 11, 12, 13, 9, 3,
3g, 8 counted, 10 counted, 13 counted:
every timed phase comes before the first CUPTI session (phase 3's kernel
count), which slows graph launches for the rest of the process:
  1. device: the card's name and power limit (nvidia-smi), then the LK
     level kernel (ops/csrc/lk_level.cu), the JV assignment kernel
     (ops/csrc/jv_assign.cu), the solver's greedy start, BLS and clique
     weight kernels (ops/csrc/mwcp_bls.cu), its field draw
     (ops/csrc/threefry_fields.cu) and the CUPTI counter are built with
     nvcc, all at once;
  2. the LK kernel against its plain PyTorch version at synthetic bench
     shapes (4 cameras, 576x768 and 288x384 levels, 6912 and 9216
     feature slots, points uniform over the image, ~25% active at
     random), once with images cut to 766 columns (rows not 16-byte
     aligned: the kernel's 4-byte staging), and the backward call of each
     level at window 12 (GENERIC_WINDOW: the sparse quality scene's, not a
     divisor of 32, so the generic kernel's non-constant offsets and its
     shared-memory layout for w=12): valid agrees on >= 99.9% of
     slots; on slots valid in both, |d tracked| <= 1e-3 px and |d resid|
     <= 1e-4; times per call are
     CUDA-event medians of 20 `lk_level` calls, wrapper host work
     included;
  3. main path: mcmtt_opticalflow_tpu_torch.bench.run_bench(30, "cuda"),
     bench.py's protocol at its config and scene (37 frames, 7 of
     warm-up).  The 2D step runs as one CUDA graph
     (models/pipeline.py::Tracker2DProgram, captured at frame 0): 37
     replays and no eager 2D step but the capture's two calls (its
     warm-up and its recording).  The kernels the card runs are counted
     by CUPTI (utils/kernel_events.py::KernelEvents, around the whole
     run; a replay's kernels one by one): 8 LK and 1 JV kernels per
     replay plus those of the warm-up; the wrappers, which replays do not
     pass through, launch 16 LK and 2 JV kernels (the capture's two
     calls); no LK work on the CPU; ids and points equal to phase 3d's
     run of the same route on every frame; frames/s (under the counter:
     the route's times are phase 3d's), stage medians,
     tracks_peak,
     pool_dropped, the MOTA triple at w0/w3/w6 beside the CPU record
     (bench_reference.json: the JAX engine on the gather LK and on its
     Pallas kernel, and the port with the LK kernel's plain version), the
     first frame whose 3D ids leave the plain record, and a failure when
     a window's MOTA leaves `plain` or `jax_pallas` by more than
     MOTA_BOUND.  The fused 3D
     program runs as CUDA graphs (models/associator3d.py::FrameProgram,
     captured per bucket, three of them by precompile after warm-up):
     graph replays > 0 and 0 calls of its eager body; the capture time
     per bucket, the graph pool's bytes and the static buffers' bytes;
     the solver's greedy_start_kernel, bls_steps_kernel,
     clique_weight_kernel and threefry_fields_kernel runs counted by
     CUPTI equal to those of each captured program's draw, head and
     iteration parts (warm-ups, replays, the head's replay before each
     iteration part's capture), their wrappers' launches those of the
     captures' two calls, and no plain version (LK, solver or field
     draw) called;
  3d. both 2D routes, no counter running: run_bench on the main path's
     route, then again with every 2D step run eagerly (no graph) and its
     assignment downloaded to the plain JV on the host and the matching
     uploaded (the route before the 2D graph, made here by patching the
     engine, never by a switch in the package): frames/s and stage
     medians of both routes (tracker2d, get2d, hyp.solve, hyp.collect
     called out), the host JV's ms a frame, ids and points equal on every
     frame; then the solver's threefry field draw of one frame, timed
     alone, by the kernel route and by its plain version.  On the way it
     records every frame's assignment inputs (phase 3f), every solve's
     inputs (phase 11) and the arguments of the 8 `lk_level` calls of
     frame CAPTURE_FRAME (phase 3b), which replays do not pass through;
  3e. the 2D graph: GRAPH_FRAMES bench frames through a fresh pipelined
     engine; after each frame the program's state buffers (every leaf)
     and its packed output equal, bit for bit, an eager tracker2d_step
     on the card on the same inputs, stepped alongside; the dispatch of
     every frame after the capture (gray upload, box / mask upload, frame
     number, replay) runs under torch.cuda.set_sync_debug_mode("error"),
     which fails on any host synchronisation; no eager 2D step after the
     capture; dispatch host ms against the eager step's, a replay's
     device ms against the eager step's ms to completion, capture s and
     the graph pool's bytes;
  3f. the JV kernel (jv_assign) against its plain version on every
     frame's recorded [4, 48, 64] assignment of phase 3d, on every frame's
     recorded assignment of the CLI (phase 10 eager), on 300 seeded
     random cases (tests/test_torch_ops.py's random and tie-heavy
     generators at its shapes and the bench's, and more rows than
     columns, up to [2, 300, 100]) and on JV_PAST_LIMIT's [1, 256, 256],
     [1, 320, 320], [2, 400, 150] and [1, 12, 14000] (both generators;
     an earlier kernel refused them; the last keeps even the column state
     in the scratch): col_of_row equal and match_cost equal bit for bit;
     per bench frame the device-only µs per launch (timed as in phase
     3b), the wrapper's host µs per call, the plain version's ms (the
     download and the host JV), the serial Dijkstra steps (the sum over
     rows: the kernel's latency floor) and the bound: the larger of the
     bytes over 3.35 TB/s and the float32 operations over 67 TFLOP/s
     (ops/hungarian.py::jv_work); an empty kernel's launch beside it;
     the device-only ns a Dijkstra step (a launch over the slowest
     camera's steps) on the bench's, the CLI's and the past-the-limit
     cases;
  3g. the eager 2D route once more, under the CUPTI counter: every LK
     launch passes through the wrapper there, so the card's count equals
     the wrapper's (296 LK, 0 JV on the card): the check of phase 3's
     counter;
  3c. graphs: GRAPH_FRAMES bench frames through a fresh pipelined engine,
     every program run's inputs recorded: the replayed pack_a / pack_b
     equal the eager body's (Associator3D._rescore_and_solve) on the
     card on the same inputs and subkeys, bit for bit, over at least two
     buckets; one dispatch's host ms (hyp.dispatch) and wall ms to
     completion, eager against replay, on those inputs; the device ms of
     each stage of the body (field draw, and its plain version beside
     it, window scores, compatibility,
     greedy start, BLS per iteration, K-best), each stage replayed as
     one graph between CUDA events queued behind a sleep kernel, and the
     BLS block's kernel alone over the same iterations from the same
     states; then the bench main path again on the eager body
     (run_bench with every engine routed to it): its frames/s and
     hyp.dispatch beside phase 3d's graph route, and its MOTA equal;
  3b. both kernels on the LK calls recorded in phase 3d: each call
     against the plain version at the limits of phase 2; the
     distribution of |final - initial estimate| (plain version) beside
     the kernel's staging margin; per call the kernel's device-only
     time (REPS back-to-back launches on prepared tensors, queued behind
     a sleep kernel so the host cannot starve the card, between two
     CUDA events, over REPS),
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
     the same seeded inputs, at the CPU parity tests' tolerances (a
     solve instance whose masks differ: the card's BLS kernel and the
     CPU's plain version part, in lockstep, at a comparison within the
     sums' rounding, as in phase 11); the
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
     and on make_mesh(devices=[cuda:0] * 4) (4 camera groups, each its
     own 2D program, a CUDA graph; the fused 3D program's row inputs
     split in 4 chunks, each a row part, a CUDA graph, joined on the
     card for the captured parts that follow): equal ids, points within
     1 mm; after every frame each group's replayed state and pack equal
     an eager tracker2d_step on the same inputs, and every mesh 3D
     program call's outputs equal the eager body on the same uploads,
     bit for bit; every captured program's dispatch under
     set_sync_debug_mode("error"); each group replays once a frame, each
     row part once a solve, no eager step or body runs but the
     captures', the wrappers count only the captures' calls.  No counter
     running: the dispatch host ms of the mesh 3D replay set against the
     eager mesh body and the one-card program, and of the four 2D
     replays against four eager steps and the one-card 2D replay, on the
     same inputs; the median per-frame wall time of the pipelined engine
     over MEASURED frames after WARMUP frames and precompile() (the
     bench's protocol), with the mesh and without, in turns.
     solve_mwcp_sharded at V=1024 (700 valid), R=38, 150 iterations
     over 2 blocks on [cuda:0] * 2, as captured block programs
     (parallel/solver_parallel.py: per block a draw, a head, three
     50-iteration block replays and a tail), equals its per-block
     solve_mwcp calls plus the global argmax and the eager per-block
     form, bit for bit; capture s, the graph pools' MiB, dispatch host
     ms captured against eager, a replay's device ms.  With four or
     more cards visible, all of it again on a mesh over four distinct
     cards (cuda:0-3: cross-device copies and joins, a graph pool a
     card; the sharded solve over cuda:0 and cuda:1); with one card that
     part is not run.  8 counted:
     the mesh run again under the CUPTI counter, after every timed
     phase: 8 LK and 1 JV kernels a group's replay and its capture's
     warm-up, the solver's kernels as the captured 3D parts prescribe,
     ids equal; then one sharded solve call on the programs made in
     phase 8: per block a draw, a greedy start, a clique weight and 3
     BLS kernels (`launches_by_path` sharded_solve);
  8b. multiprocess: parallel/multihost_sim.py --bench in two processes on
     the one card, joined by gloo, each with two cuda:0 entries of the
     global cam 4 x block 1 mesh: each replays its two groups' 2D
     programs once a frame and its two chunks' row parts once a solve,
     joins the rows by an all-gather and replays the rest of the 3D
     program; ids equal to phase 8's mesh run frame by frame (points
     within 1 mm), 3D replays equal to that run's and each other's, the
     wrappers 32 LK and 4 JV launches (the captures' calls); the kernels
     the card runs for each process, counted by CUPTI inside it around
     its frames (8 LK and 1 JV a 2D replay and a capture's warm-up; the
     solver's as the other process's and phase 8's counted run's), go to
     the kernels line; the solve of phase 8 over a 1 x 4 mesh with two blocks
     in each process, each a captured block program, equals its per-block
     solves plus the argmax; wall
     time against phase 8's, the median time per frame in collectives,
     and scaling_report;
  9. profile: utils/timing.py::profile_trace (torch.profiler) around
     PROFILE_FRAMES steady bench frames: device busy share, device ms
     per frame, top 5 kernels, and the events of lk_level_kernel (8 per
     frame) and jv_assign_kernel (1 per frame), all in 2D graph replays,
     and of the solver's four kernels (the window's 3D
     draw, head and iteration-part replays), none through a wrapper;
  10. the dataset CLI: the bench scene (12 frames) written in the
     reference's layout (Tsai XML, detection files, .ppm frames, ground
     truth, parameters.txt), run through `main.py <parameters.txt>` in
     process at the default EngineConfig (3 pyramid levels: counted as in
     phase 3, 12 LK and 1 JV kernels run per 2D replay plus the capture's
     warm-up, the wrappers launch those of the capture's two calls, none
     on the CPU, no flat-gray frame), MOTA at w0/w3/w6 from the printed
     table's results; run three times: on the eager 2D route (the
     script's patch of phase 3d) to record every frame's assignment for
     phase 3f, with only the table checked; timed (recording every
     solve's inputs for phase 11); then counted (the solver's kernels as
     in phase 3);
  11. mwcp: the solver's kernels (ops/mwcp_kernel.py) against their
     plain versions on the card, on the recorded solves of phase 3d (the
     bench, 37) and phase 10 (the CLI, 12): the greedy kernel bit-equal
     on every replica; the BLS kernel from the same start and fields:
     the solves whose K-best masks and scores are equal, and for each
     that is not, the first iteration whose decisions part and the
     comparisons the summation order flipped there, with their operands
     (a fault when they lie more than 1e-5 relative apart, or when none
     flipped); every K-best entry a clique of valid vertices scoring its
     weight sum within 1e-4, no clique twice, the top score >= 0.99 x
     the plain version's; the clique-weight kernel's start scores equal
     to ascending float32 sums bit for bit and to torch.sum within 1e-5
     relative, and so on random masks at [1, 33], [7, 1000], [4, 6144]
     and [3, 16400] (CLIQUE_CASES, each timed beside the library call).
     Then synthetic solves past the BLS kernel's shared-memory layouts (V=6144 and V=16400, R=4, S=16, 60 iterations,
     integer weights) bit-equal to the plain version, their greedy starts
     equal to the plain greedy's; the greedy kernel equal to its plain
     version in each of its layouts: V=40000 (256 valid vertices, bound
     256: tier 2; an earlier kernel refused it), V=6144 (tier 1), V=1100
     (tier 0 past the register bit sets), and on an adjacency that is
     not symmetric (V=1024, tier 0 in registers).  Per bench solve:
     each kernel's device-only µs (timed as in phase 3b), its wrapper's
     host µs, the plain version's ms and the bound
     (ops/mwcp_kernel.py::greedy_work, bls_work, clique_work), the serial
     steps (greedy rounds, BLS iterations, additions), and on every
     PLAIN_EVERY-th solve a 50-iteration BLS block replayed as a graph
     (phase 3c's measure) and its kernel alone over the same iterations
     from the same states; the BLS kernel's device-only µs per iteration
     on the 12 CLI solves too, and the greedy kernel's µs a round (a
     launch over the largest clique's rounds) on both; the clique
     weights' library call, torch.sum(torch.where(...)), timed like the
     kernel, on both; all
     beside phase 3c's one-frame block and its kernel alone, with the
     measured differences;
  12. threefry: the solver's field draw kernel (ops/threefry_kernel.py)
     bit-equal to its plain version on the card on every element of the
     five fields, from the subkey of every recorded bench (37, [38, 1024,
     150]) and CLI (12, [18, 256, 2000]) solve, where both also equal the
     fields the captured program drew, and at DRAW_ODD [5, 1000, 7] into
     buffers off 16-byte alignment; then a bench and a CLI draw: the
     kernel's device-only µs (timed as phase 3b), the wrapper's host µs,
     the plain version's ms, the bound (threefry_kernel.field_work: the
     larger of the bytes' time and the instruction issue's, from the
     built kernel's SASS, which the phase recounts with cuobjdump and
     holds the module's constants to, with the card's SM count and
     maximum SM clock) and its binding term, the share of the bound;
  13. quality: the JAX package's quality gates and its stability soak on
     the card (after every timed phase, before any CUPTI session).  The
     soak (mcmtt_opticalflow_tpu_torch/soak.py, scripts/soak.py's
     scenario and config: 3 cameras at 320x240, LK window 8, 512 solver
     vertices) at SOAK_FRAMES frames and SOAK_PEOPLE people: its seven
     checks (fps_stable, registry_flat, buffers_flat, vis_ids_bounded,
     device_memory_flat, captures_settle, pinned_memory_flat) must pass;
     the summary, the
     buckets met and the frame and capture s of each, allocated,
     reserved and pinned host MiB at the second and the last quarter,
     RSS, the graph
     pools' MiB, steady frames/s and the phase's seconds.  Then the two
     fixtures of tests/test_quality_regression.py
     (mcmtt_opticalflow_tpu_torch/quality.py) on the card beside the
     port's CPU record (quality_reference.json): the sparse scene (full
     pipeline, 3 cameras at 384x288, LK window 12, 128 solver vertices):
     every gate of that file at its threshold; the density scene
     (associator only, 512 solver vertices, K=30): the MOTA floor and
     containment at their thresholds and each window's MOTA within
     MOTA_BOUND of the CPU record's, the window-step gates printed with
     their margins (and, where one does not hold, the first frame whose
     ids leave the CPU record).  Every kernel against its plain version
     on these paths' own inputs, at the limits of phases 2, 3f, 11 and
     12: the fixtures' solves (greedy start, clique weights, BLS, field
     draw), the sparse scene's LK calls (window 12) and assignments from
     a second run on the eager 2D route (ids and points equal to the
     graph route's), and a short soak's LK calls (window 8, 6
     iterations), assignments and solves.  13 counted runs the soak and
     both fixtures again under the CUPTI counter at the end: the card's
     runs equal those derived from the wrappers and the replays
     (_derived_runs) in that run and in phase 13's, and the ids (the
     soak's population numbers) equal phase 13's.

The whole script takes about 5 minutes on the card.  The line before the
last is a JSON summary of the kernels.  The LK kernels, on the inputs of
phase 3b: per bench frame (8 launches) `ms` (device-only), `plain_ms`,
`bound_ms`;
per launch `device_us_per_launch`, `bound_us`; `host_us_per_call`; what
binds (`bound_by`); `library_ms` null (no single PyTorch call computes
an LK level); `call_ms_synthetic`, phase 2's per-frame time with the
wrapper's host work; `launches_by_path`, the launches of each path that
runs the kernel, each counted from 0 (`launches` is the main path's):
kernel runs counted on the card for the graphed paths (main, mesh, cli:
CUPTI; profile: trace events; multiprocess: CUPTI inside each process),
the wrapper's count for the eager ones;
`wrapper_launches` and `graph_replays_2d`, measured beside the card's
counts on the graphed paths; `soak`, `quality_sparse` and
`quality_density` are phase 13's paths, counted by CUPTI in 13 counted.
Every kernel's `max_abs_err` also covers phase 13's checks on those
paths' inputs.  The JV kernel, on phase 3f's recorded
frames, per bench frame (1 launch): the same keys, with `serial_steps`
and `device_ns_per_step` (`_cli` on the CLI's frames,
`_past_old_limit` by shape).
The solver's kernels, on phase 11's recorded bench solves, per solve (a
greedy start, the start's clique weights: 1 launch each; the BLS: its
150 iterations, timed as 1 launch): the same keys, with `serial_steps`
(the greedy's `device_us_per_round`, `_cli` on the CLI's solves; the
clique weights' `library_ms`, `_cli` on the CLI's solves; the BLS's
`device_us_per_iteration`, `_cli` on the CLI's solves,
`graph_block_us_per_iteration`, `kernel_block_us_per_iteration`, and
`layout`: where the kernel keeps
the graph and the state); their main-path and CLI launches are kernel
runs counted by CUPTI.  The field draw (phase 12), per bench draw (1
launch): the same keys, with `numbers`, and the CLI draw's
`device_us_per_launch_cli`, `plain_ms_cli`, `bound_us_cli`.
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
GRAPH_FRAMES = 12
CLI_CAM_IDS = (1, 5, 6, 8)
# the largest |card - CPU| MOTA at any window the main path may show,
# against the port's CPU run with the LK kernel's plain version and the
# JAX engine's CPU run on its own Pallas LK kernel (bench_reference.json
# `plain` and `jax_pallas`; PERF.md section 2)
MOTA_BOUND = 0.01
NEG_SCORE = -1e30           # models/mwcp.py's NEG: an empty K-best slot
PLAIN_EVERY = 4             # phase 11 times the plain versions on these
SOAK_FRAMES = 300           # phase 13's soak: tests/test_soak.py's size
SOAK_PEOPLE = 15
# phase 13 holds the kernels against their plain versions on a short soak
# on the eager 2D route: its last SOAK_RECORDED of SOAK_RECORD_FRAMES
# frames' LK calls and assignments, and every SOLVE_EVERY-th solve
SOAK_RECORD_FRAMES = 40
SOAK_RECORDED = 8
SOLVE_EVERY = 4
# phase 2's LK window past the bench's 16: the sparse quality scene's, not
# a divisor of 32 (the generic kernel's non-constant offsets)
GENERIC_WINDOW = 12


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
    tracker makes while `frame` equals `capture_frame` (any frame when
    None) and whose index, counted from install(), lies in `calls` (any
    when None); install() wraps ops/lk.py's name for it, remove()
    restores it."""

    def __init__(self, capture_frame=None, calls=None):
        self.capture_frame, self.keep = capture_frame, calls
        self.frame, self.n = -1, 0
        self.calls = []

    def install(self):
        from mcmtt_opticalflow_tpu_torch.ops import lk
        self._orig = lk.lk_level

        def capturing(*a, **k):
            if self.capture_frame in (None, self.frame) and \
                    (self.keep is None or self.n in self.keep):
                self.calls.append(([x.clone() for x in a], dict(k)))
            self.n += 1
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


def window_calls(frames, cfg):
    """The bench's backward call at each pyramid level with the LK window
    at GENERIC_WINDOW."""
    calls = list(bench_level_calls(frames, cfg))[:cfg.tracker2d
                                                 .lk_pyramid_levels]
    return [(args, dict(kw, window=GENERIC_WINDOW),
             f"{label} window={GENERIC_WINDOW}")
            for _, args, kw, label in calls]


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


class EagerCount:
    """Counts calls of the fused 3D program's eager body
    (Associator3D._rescore_and_solve) while active."""

    def __enter__(self):
        from mcmtt_opticalflow_tpu_torch.models.associator3d import \
            Associator3D
        self.cls, self.orig, self.calls = Associator3D, \
            Associator3D._rescore_and_solve, 0

        def counted(assoc, *a, **k):
            self.calls += 1
            return self.orig(assoc, *a, **k)
        Associator3D._rescore_and_solve = counted
        return self

    def __exit__(self, *exc):
        self.cls._rescore_and_solve = self.orig


def pool_mib(*pools):
    """MiB the CUDA caching allocator holds in the graph pools."""
    from mcmtt_opticalflow_tpu_torch.soak import graph_pool_bytes
    return graph_pool_bytes(pools) / 2**20


def static_bytes(prog):
    """Bytes of a FrameProgram's static buffers (uploads, key, fields)."""
    return sum(t.numel() * t.element_size()
               for t in (*prog.inputs, prog.key, *prog.fields))


def replays_per_frame(progs):
    return sorted({len(p.parts()) - (p.block is not None)
                   + p.blocks for p in progs.values()})


def _frame_ids(frames_json):
    return {f["frame"]: sorted(f["ids"]) for f in frames_json}


def _count_calls(mod, name):
    """Wrap mod.<name> with a call counter; returns (counts, restore)."""
    fn = getattr(mod, name)
    counts = {"n": 0}

    def wrapped(*a, **k):
        counts["n"] += 1
        return fn(*a, **k)
    setattr(mod, name, wrapped)
    return counts, lambda: setattr(mod, name, fn)


def kernel_runs(ev):
    """(batched LK, serial LK, JV) kernel runs that a KernelEvents session
    counted on the card."""
    return (ev.count("lk_level_kernel<false"),
            ev.count("lk_level_kernel<true"), ev.count("jv_assign_kernel"))


def solver_kernels():
    """The solver's kernels: (the module of the wrapper and its plain
    version, wrapper, CUDA kernel name)."""
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel, threefry_kernel
    return ((mwcp_kernel, "greedy_start", "greedy_start_kernel"),
            (mwcp_kernel, "bls_steps", "bls_steps_kernel"),
            (mwcp_kernel, "clique_weights", "clique_weight_kernel"),
            (threefry_kernel, "threefry_fields", "threefry_fields_kernel"))


def solver_kernel_runs(ev):
    """(greedy start, BLS, clique weight, field draw) kernel runs that a
    KernelEvents session counted on the card."""
    return tuple(ev.count(k) for *_, k in solver_kernels())


def solver_runs_expected(assocs):
    """The solver kernels' (greedy start, BLS, clique weight, field draw)
    runs on the card that the captured 3D programs of `assocs` made, and
    their wrappers' launches: per program the head's warm-up, its
    replays, and one replay before each iteration part's capture
    (FrameProgram.capture) run the greedy start and the clique weights;
    per iteration part its warm-up and its replays run the BLS; the draw
    part's warm-up and its replays run the field draw.  A wrapper counts
    each part's warm-up and recording."""
    return program_runs([p for assoc in assocs
                         for p in assoc._programs.values()])


def program_runs(progs):
    """solver_runs_expected of captured programs with a draw, a head and
    iteration parts: the associator's FrameProgram or the sharded solve's
    BlockProgram (parallel/solver_parallel.py)."""
    runs, wrapper = [0, 0, 0], [0, 0, 0]
    for p in progs:
        if p.head.graph is None:
            continue
        loops = [x for x in (p.block, p.rest) if x is not None]
        runs[0] += 1 + len(loops) + p.head.n_replays
        runs[1] += sum(1 + x.n_replays for x in loops)
        wrapper[0] += 2
        wrapper[1] += 2 * len(loops)
        if p.draw.graph is not None:
            runs[2] += 1 + p.draw.n_replays
            wrapper[2] += 2
    return ((runs[0], runs[1], runs[0], runs[2]),
            (wrapper[0], wrapper[1], wrapper[0], wrapper[2]))


def solver_launches():
    return tuple(getattr(m, w).launches for m, w, _ in solver_kernels())


def reset_solver_launches():
    for m, w, _ in solver_kernels():
        getattr(m, w).launches = 0


def phase_main_path(card, timed):
    """mcmtt_opticalflow_tpu_torch.bench.run_bench on the card: bench.py's
    protocol at its config and scene, the kernels the card runs counted
    from 0 by CUPTI (utils/kernel_events.py: graph replays' kernels one by
    one) and the wrappers' launches from 0, its CPU LK calls and eager 2D
    steps counted; its MOTA triple held
    against the CPU record (bench_reference.json: `jax`, the JAX engine;
    `jax_pallas`, the JAX engine on its Pallas LK kernel; `plain`, the
    port with the LK kernel's plain version), within MOTA_BOUND of the
    last two; its results
    equal, frame by frame, to `timed`, phase 3d's run of the same route
    with no counter.  The counter slows graph launches (CUPTI records
    their kernels), so the route's times are `timed`'s."""
    import numpy as np
    from mcmtt_opticalflow_tpu_torch import bench
    from mcmtt_opticalflow_tpu_torch.models import pipeline
    from mcmtt_opticalflow_tpu_torch.ops import hungarian, lk, lk_kernel
    from mcmtt_opticalflow_tpu_torch.utils.kernel_events import KernelEvents

    total = WARMUP + MEASURED
    # any plain version (LK, solver) that runs during the main path, and
    # the eager 2D steps: the program's capture makes two (its warm-up and
    # its recording), replays none
    counted = {(mod, name): _count_calls(mod, name) for mod, name in (
        (lk_kernel, "lk_level_reference"), (lk, "lk_track_points"),
        *[(m, f"{w}_reference") for m, w, _ in solver_kernels()],
        (pipeline, "tracker2d_step"))}
    eager = EagerCount()
    lk_kernel.lk_level.launches = lk_kernel.lk_level.serial_launches = 0
    hungarian.jv_assign.launches = 0
    reset_solver_launches()
    try:
        with eager, KernelEvents() as ev:
            run = bench.run_bench(MEASURED, "cuda")
    finally:
        for _, restore in counted.values():
            restore()
    cpu_calls = {name: n["n"] for (mod, name), (n, _) in counted.items()
                 if mod is not pipeline}
    steps2d = counted[(pipeline, "tracker2d_step")][0]
    wrapper = (lk_kernel.lk_level.launches,
               lk_kernel.lk_level.serial_launches,
               hungarian.jv_assign.launches)
    runs = kernel_runs(ev)
    prog2d = run.engine._progs2d[0]
    replays2d = prog2d.graph.n_replays
    assoc = run.engine.assoc
    progs = assoc._programs
    replays = sum(g.n_replays for p in progs.values() for g in p.parts())
    rec = run.record
    # the card runs 8 LK and 1 JV kernels a replay and in the capture's
    # warm-up; the wrappers see the capture's two eager calls only
    want_runs = expected_2d([run.engine])[0]
    want_wrapper = (8 * steps2d["n"], 0, steps2d["n"])
    log(f"main path: run_bench({MEASURED}, 'cuda'), {total} frames: 2D "
        f"program {replays2d} graph replays (expected {total}), "
        f"{steps2d['n']} eager tracker2d_step calls (expected 2: the "
        f"capture's warm-up and recording), capture "
        f"{prog2d.graph.capture_s:.3f} s, graph pool "
        f"{pool_mib(prog2d.graph.pool):.1f} MiB; kernels run on "
        f"the card (CUPTI): lk_level={runs[0]} (expected {want_runs[0]}: 8 "
        f"a replay and 8 in the warm-up), lk_level_serial={runs[1]}, "
        f"jv_assign={runs[2]} (expected {want_runs[2]}), "
        f"{ev.total} kernels in all, {ev.total / total:.0f} a frame; "
        f"wrapper launches lk_level={wrapper[0]} serial={wrapper[1]} "
        f"jv_assign={wrapper[2]} (expected {want_wrapper}: the capture's "
        f"two calls); CPU LK calls={cpu_calls}")
    if replays2d != total or steps2d["n"] != 2:
        fail(f"main path: the 2D step ran {replays2d} replays and "
             f"{steps2d['n']} eager calls (expected {total} and 2)")
    if runs != want_runs:
        fail(f"main path: the card ran (lk_level, lk_level_serial, "
             f"jv_assign) {runs} times, expected {want_runs}")
    if wrapper != want_wrapper:
        fail(f"main path: the wrappers launched (lk_level, "
             f"lk_level_serial, jv_assign) {wrapper} times, expected "
             f"{want_wrapper}")
    if any(cpu_calls.values()):
        fail(f"a plain version ran during the main path: {cpu_calls}")
    s_runs, s_wrapper = solver_kernel_runs(ev), solver_launches()
    want_s_runs, want_s_wrapper = solver_runs_expected([assoc])
    log(f"main path: solver kernels run on the card (CUPTI) greedy_start="
        f"{s_runs[0]} bls_steps={s_runs[1]} clique_weights={s_runs[2]} "
        f"threefry_fields={s_runs[3]} (expected {want_s_runs}: each "
        f"captured program's draw, head and iteration parts, their "
        f"warm-ups and replays), wrapper launches {s_wrapper} (expected "
        f"{want_s_wrapper}: the captures' two calls)")
    if s_runs != want_s_runs or s_wrapper != want_s_wrapper:
        fail(f"main path: the solver kernels ran {s_runs} times and their "
             f"wrappers launched {s_wrapper}, expected {want_s_runs} and "
             f"{want_s_wrapper}")
    capture_s = {str(k): round(p.capture_s, 3) for k, p in progs.items()}
    log(f"main path: fused 3D program: {replays} graph replays, "
        f"{eager.calls} eager-body calls; capture s per bucket (nr, nb, "
        f"iters) {json.dumps(capture_s)}; graph pool "
        f"{pool_mib(assoc._graph_pool(assoc.device)):.1f} MiB, "
        f"static buffers "
        f"{sum(static_bytes(p) for p in progs.values()) / 2**20:.1f} MiB; "
        f"{replays_per_frame(progs)} replays a frame")
    if replays <= 0 or eager.calls:
        fail(f"main path: {replays} graph replays and {eager.calls} eager "
             f"calls of the fused 3D program (expected > 0 and 0)")
    if rec["lk_route"] != "cuda" or rec["frames"] != MEASURED:
        fail(f"main path: unexpected record {rec}")
    for r in run.engine.results:
        pts = np.asarray(r.points)
        if len(r.ids) != len(pts) or (pts.size and (
                pts.shape[1] != 3 or not np.isfinite(pts).all())):
            fail(f"malformed result at frame {r.frame_idx}")
    same_results(timed, run, "main path (counted)", "phase 3d's run")
    log(f"main path: {rec['value']} frames/s median over "
        f"{len(run.per_frame)} frames under the CUPTI counter (phase 3d "
        f"{timed.record['value']} without it) on {card}")
    log(f"main path: per-frame s {[round(x, 4) for x in run.per_frame]}")
    log(f"main path: stage medians ms {json.dumps(rec['stage_ms'])}")
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
    for name in ("jax", "jax_pallas", "plain"):
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
    for name in ("plain", "jax_pallas"):
        gap = max(abs(c - p) for c, p in zip(card_mota, ref[name]["mota"]))
        log(f"main path: max |card - {name}| MOTA {gap:.4f} (bound "
            f"{MOTA_BOUND})")
        if gap > MOTA_BOUND:
            fail(f"the card's MOTA leaves the {name} CPU record by "
                 f"{gap:.4f} (bound {MOTA_BOUND})")
    counts = {"runs": runs, "wrapper": wrapper, "replays": replays2d,
              "solver_runs": s_runs, "solver_wrapper": s_wrapper}
    return counts, run


class _Eager2DRoute:
    """While active, every engine's 2D program runs its function eagerly
    (no graph: nothing is captured) and the assignment in it downloads
    the cost matrix and the masks, runs the plain JV on the host and
    uploads the matching: the route before the 2D graph.  Records every
    assignment's inputs (cloned) and its host seconds."""

    def __enter__(self):
        from mcmtt_opticalflow_tpu_torch.models import pipeline, tracker2d
        from mcmtt_opticalflow_tpu_torch.ops import hungarian
        self.inputs, self.host_s = [], []
        self.cls = pipeline.Tracker2DProgram
        self.orig = self.cls.__call__, self.cls.capture
        self.mod, self.orig_jv = tracker2d, tracker2d.solve_assignment_batch

        def call(prog, boxes, mask, frame_idx):
            prog.boxes.copy_(pipeline._staged(boxes, prog.device),
                             non_blocking=True)
            prog.mask.copy_(pipeline._staged(mask, prog.device),
                            non_blocking=True)
            prog.frame_idx.fill_(frame_idx)
            prog.graph.out = prog.graph.fn()
            return prog.graph.out

        def host_jv(cost, row_mask, col_mask):
            self.inputs.append((cost.clone(), row_mask.clone(),
                                col_mask.clone()))
            t0 = time.perf_counter()
            out = [x.to(cost.device) for x in hungarian.jv_assign_reference(
                cost, row_mask, col_mask)]
            self.host_s.append(time.perf_counter() - t0)
            return out
        self.cls.__call__, self.cls.capture = call, lambda prog: None
        tracker2d.solve_assignment_batch = host_jv
        return self

    def __exit__(self, *exc):
        self.cls.__call__, self.cls.capture = self.orig
        self.mod.solve_assignment_batch = self.orig_jv


STAGES_2D = ("tracker2d", "get2d", "hyp.solve", "hyp.collect", "upload")


def same_results(a, b, name_b, name_a):
    """Fail unless two bench runs gave the same ids and points on every
    frame."""
    import numpy as np
    if len(a.results) != len(b.results):
        fail(f"{name_b}: {len(b.results)} frames against {len(a.results)}")
    for x, y in zip(a.results, b.results):
        if x["frame"] != y["frame"] or x["ids"] != y["ids"] or \
                not np.array_equal(x["points"], y["points"]):
            fail(f"{name_b}: frame {x['frame']}'s results differ from "
                 f"{name_a}'s")


def phase_routes(card):
    """The bench protocol on both 2D routes in this call, no counter
    running: the graph route (the main path as a user runs it) and the
    eager 2D route (_Eager2DRoute); frames/s and stage medians of both,
    the host JV's ms a frame, ids and points equal on every frame; then
    the solver's threefry draw timed alone.  Records the LK calls of
    frame CAPTURE_FRAME (phase 3b), every frame's assignment inputs
    (phase 3f) and every solve's inputs (phase 11) on the eager route.
    Returns (the LK calls, the assignment inputs, the graph route's run,
    the solves)."""
    import numpy as np
    from mcmtt_opticalflow_tpu_torch import bench
    from mcmtt_opticalflow_tpu_torch.models.mwcp import threefry_fields
    from mcmtt_opticalflow_tpu_torch.ops.threefry_kernel import (
        field_work, threefry_fields_reference)
    from mcmtt_opticalflow_tpu_torch.utils import prng

    graph_run = bench.run_bench(MEASURED, "cuda")
    capture = LkCapture(CAPTURE_FRAME)
    capture.install()
    cfg = bench.bench_config()
    try:
        with _Eager2DRoute() as route, \
                SolveCapture(cfg.solver) as solves:
            run = bench.run_bench(
                MEASURED, "cuda",
                on_frame=lambda t: setattr(capture, "frame", t))
    finally:
        capture.remove()
    total = WARMUP + MEASURED
    if len(route.inputs) != total or len(capture.calls) != 8:
        fail(f"eager 2D route: {len(route.inputs)} assignments and "
             f"{len(capture.calls)} lk_level calls of frame {CAPTURE_FRAME}"
             f" recorded (expected {total} and 8)")
    same_results(graph_run, run, "eager 2D route", "the 2D graph route")
    for name, r in (("graph 2D, device JV", graph_run),
                    ("eager 2D, host JV", run)):
        rec = r.record
        called = {k: rec["stage_ms"].get(k) for k in STAGES_2D}
        mota = [rec[f"mota_w{w}"] for w in WINDOWS]
        log(f"2D routes: {name}: {rec['value']} frames/s, stage ms "
            f"{json.dumps(called)}, MOTA {mota} ({card})")
        log(f"2D routes: {name}: all stage medians ms "
            f"{json.dumps(rec['stage_ms'])}")
        log(f"2D routes: {name}: per-frame s "
            f"{[round(x, 4) for x in r.per_frame]}")
    jv_ms = 1e3 * np.asarray(route.host_s[WARMUP:])
    log(f"2D routes: eager route's host JV (download, numpy JV, upload) "
        f"median {float(np.median(jv_ms)):.3f} ms a frame (max "
        f"{float(jv_ms.max()):.3f}); ids and points equal to the graph "
        f"route's on all {len(run.results)} frames")

    # the solver's random fields of one bench frame, drawn alone: the
    # kernel route and the plain version
    r = bench.bench_config().solver.num_replicas + \
        bench.bench_config().assoc3d.k_best_size
    key = prng.split(prng.prng_key(0))[1].cuda()
    draw_ms = time_ms(lambda: threefry_fields(key, r, 1024, 150, "cuda"),
                      reps=10)
    plain_ms = time_ms(
        lambda: threefry_fields_reference(key, r, 1024, 150), reps=10)
    log(f"2D routes: threefry field draw (R={r}, V=1024, 150 iterations: "
        f"{field_work(r, 1024, 150)['numbers']} numbers) {draw_ms:.4f} ms "
        f"a frame by the kernel route, {plain_ms:.3f} ms by the plain "
        f"version (CUDA events with the host's calls, median of 10) on "
        f"{card}")
    return capture.calls, route.inputs, graph_run, solves.solves


def phase_eager_counted(card):
    """The eager 2D route once more, under the CUPTI counter as the main
    path is: every LK launch of this route passes through the wrapper, so
    the card's count of kernel runs must equal the wrapper's (the check
    of the counter), and the JV runs on the host (0 on the card)."""
    from mcmtt_opticalflow_tpu_torch import bench
    from mcmtt_opticalflow_tpu_torch.ops import hungarian, lk_kernel
    from mcmtt_opticalflow_tpu_torch.utils.kernel_events import KernelEvents

    lk_kernel.lk_level.launches = lk_kernel.lk_level.serial_launches = 0
    hungarian.jv_assign.launches = 0
    with _Eager2DRoute(), KernelEvents() as ev:
        run = bench.run_bench(MEASURED, "cuda")
    total = WARMUP + MEASURED
    runs = kernel_runs(ev)
    wrapper = (lk_kernel.lk_level.launches,
               lk_kernel.lk_level.serial_launches,
               hungarian.jv_assign.launches)
    log(f"eager 2D route, counted: kernels run on the card (CUPTI) "
        f"(lk_level, lk_level_serial, jv_assign) {runs}, wrapper launches "
        f"{wrapper} (expected both {(8 * total, 0, 0)}); {ev.total} kernels "
        f"in all, {ev.total / total:.0f} a frame; {run.record['value']} "
        f"frames/s under the counter ({card})")
    if runs != wrapper or runs != (8 * total, 0, 0):
        fail(f"eager 2D route: the card ran {runs} kernels, the wrappers "
             f"launched {wrapper}, expected {(8 * total, 0, 0)} both")


def _max_abs_err(pairs) -> float:
    """The largest |a - b| over pairs of tensors of one shape, 0 where
    they are equal (so equal infinities count 0)."""
    import torch
    err = 0.0
    for a, b in pairs:
        if a.numel():
            b = b.to(a.device)
            d = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
            err = max(err, float(d.max()))
    return err


def _bits_equal(a, b) -> bool:
    """Equal bit for bit (NaN and the sign of zero included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def phase_graph2d(cfg, sc, frames, card):
    """The 2D program as one CUDA graph against the eager step: a fresh
    pipelined engine over GRAPH_FRAMES bench frames; after each frame its
    state buffers and packed output equal an eager tracker2d_step on the
    card stepped alongside on the same inputs, bit for bit.  Every
    dispatch after the capture runs under set_sync_debug_mode("error");
    no eager 2D step follows the capture.  Then the host ms of a
    dispatch (in the pipeline, under the debug mode, and alone on an idle
    card) against an eager step's, and a replay's device ms against the
    eager step's ms to completion."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.models import pipeline
    from mcmtt_opticalflow_tpu_torch.models.tracker2d import tracker2d_step
    from mcmtt_opticalflow_tpu_torch.utils.tree import tree_leaves, tree_map

    eng = pipeline.TrackingEngine(cfg, sc.cameras, pipelined=True,
                                  device="cuda")
    prog = eng._progs2d[0]
    ref = tree_map(torch.clone, prog.state)
    cls = pipeline.Tracker2DProgram
    orig_call, orig_put = cls.__call__, cls.put_gray
    host_ms, steady = {"put_gray": [], "call": []}, {"on": False}

    def strict(fn, name):
        def wrapped(p, *a):
            t0 = time.perf_counter()
            if steady["on"]:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(p, *a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                if steady["on"]:
                    host_ms[name].append(1e3 * (time.perf_counter() - t0))
        return wrapped
    steps2d, restore = _count_calls(pipeline, "tracker2d_step")
    cls.__call__ = strict(orig_call, "call")
    cls.put_gray = strict(orig_put, "put_gray")
    compared = 0
    try:
        for t in range(GRAPH_FRAMES):
            steady["on"] = prog.graph.graph is not None
            eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
            if t == 0 and steps2d["n"] != 2:
                fail(f"2D graph: {steps2d['n']} eager steps at the capture")
            ref, out = tracker2d_step(
                ref, prog.gray_u8.float() * (1.0 / 255.0), prog.boxes,
                prog.mask, eng.cams, t, cfg.tracker2d)
            want = [pipeline._pack2d(out)] + tree_leaves(ref)
            got = [prog.graph.out] + tree_leaves(prog.state)
            for i, (g, w) in enumerate(zip(got, want)):
                if not _bits_equal(g, w):
                    fail(f"2D graph: frame {t}: the replayed "
                         f"{'pack' if i == 0 else f'state leaf {i - 1}'}"
                         f" differs from the eager step's")
            compared += 1
    finally:
        cls.__call__, cls.put_gray = orig_call, orig_put
        restore()
        torch.cuda.set_sync_debug_mode(0)
    while eng.flush() is not None:
        pass
    if steps2d["n"] != 2 or prog.graph.n_replays != GRAPH_FRAMES:
        fail(f"2D graph: {steps2d['n']} eager steps, "
             f"{prog.graph.n_replays} replays (expected 2 and "
             f"{GRAPH_FRAMES})")
    # timing on the last frame's buffers (the engine is done with them)
    torch.cuda.synchronize()
    host_in = [x.cpu().numpy() for x in (prog.gray_u8, prog.boxes,
                                         prog.mask)]
    idle_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.put_gray(host_in[0])
        prog(host_in[1], host_in[2], GRAPH_FRAMES)
        idle_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    gray = prog.gray_u8.float() * (1.0 / 255.0)
    eager_host, eager_wall = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker2d_step(ref, gray, prog.boxes, prog.mask, eng.cams,
                       GRAPH_FRAMES, cfg.tracker2d)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        eager_host.append(1e3 * (t1 - t0))
        eager_wall.append(1e3 * (time.perf_counter() - t0))
    replay_ms = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        prog.graph.graph.replay()
        b.record()
        b.synchronize()
        replay_ms.append(a.elapsed_time(b))
    med = lambda x: round(float(np.median(x)), 3)   # noqa: E731
    log(f"2D graph: {compared} frames, replayed state (every leaf) and "
        f"pack == the eager step's bit for bit; {GRAPH_FRAMES - 1} steady "
        f"dispatches under set_sync_debug_mode('error'); "
        f"{steps2d['n']} eager steps (the capture's); capture "
        f"{prog.graph.capture_s:.3f} s, graph pool "
        f"{pool_mib(prog.graph.pool):.1f} MiB ({card})")
    log(f"2D graph: dispatch host ms, medians: in the pipeline under the "
        f"debug mode, gray upload {med(host_ms['put_gray'])} and boxes + "
        f"mask + frame number + replay {med(host_ms['call'])}; alone on an "
        f"idle card (the same, 5 times) {med(idle_ms)}; against the eager "
        f"step's host ms {med(eager_host)}.  A replay's device ms "
        f"{med(replay_ms)} against the eager step's ms to completion "
        f"{med(eager_wall)} (CUDA events / host clock, median of 5; {card})")


def _uploads(host, dev):
    import numpy as np
    import torch
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev,
                                                         non_blocking=True)
            for x in host]


def _eager_body(assoc, host, key, iters):
    """The fused 3D program's eager body on the card from host arrays,
    uploaded as the JAX package places them (Associator3D._dev: on a mesh
    the row inputs split where they divide it), the columns whole on the
    associator's device."""
    from mcmtt_opticalflow_tpu_torch.models.associator3d import (
        _GRAPH_ROWS, _SPLIT_ARGS)
    t = [assoc._dev(x, i in _SPLIT_ARGS) for i, x in enumerate(host)]
    cols = tuple(assoc._dev(host[i]) for i in _GRAPH_ROWS)
    return assoc._rescore_and_solve(*t, key, iters, cols)


def _timed_ms(fn):
    """(host ms to return, wall ms to the card's completion) of fn()."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)


class _EagerRoute:
    """While active, every engine runs the fused 3D program's eager body
    in place of its captured program (the comparison run)."""

    def __enter__(self):
        from mcmtt_opticalflow_tpu_torch.models.associator3d import \
            Associator3D
        self.cls, self.orig = Associator3D, Associator3D._program

        def program(assoc, nr, nb, iters):
            return lambda host, key, field_source=None: _eager_body(
                assoc, host, key if field_source is None else field_source,
                iters)
        Associator3D._program = program
        return self

    def __exit__(self, *exc):
        self.cls._program = self.orig


def _events_ms(run, reps=5, before=None):
    """Device ms of what run() queues, between two CUDA events queued
    behind a ~10 ms sleep kernel (so the host's launch work falls outside
    them), median of `reps`; `before` runs ahead of each, outside the
    events."""
    import torch
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def _graph_ms(fn, reps=5, before=None):
    """Device ms of fn's kernels: fn captured as one CUDA graph, replayed
    between two CUDA events, median of `reps`; `before` runs ahead of
    each replay, outside the events."""
    from mcmtt_opticalflow_tpu_torch.utils.graphs import Graphed
    g = Graphed(fn, "cuda")
    g.capture()
    return _events_ms(g.graph.replay, reps, before)


def _block_us(st, f, cfg, blk):
    """A BLS block of `blk` iterations from the solve state `st`, timed two
    ways: as the captured program replays it (the adjacency's packing,
    the kernel, `it` advanced: one CUDA graph) on `st`, and the kernel
    alone (no packing, no graph) on a copy of it taken first.  Every run
    starts at iteration 0 (`it` zeroed ahead of it, outside the events)
    from the state the run before it left, after one warm-up run (the
    graph's capture runs one), so both time the same iterations from the
    same states.  Returns (graph, kernel alone) in µs an iteration."""
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel as mk
    b = _clone_state(st)
    graph = _graph_ms(lambda: mk.bls_steps(st, f, cfg, blk),
                      before=lambda: st.it.zero_())
    scratch = mk.bls_scratch(b)

    def alone():
        mk._launch_bls(b, f, cfg, blk, scratch)
    b.it.zero_()
    alone()
    kernel = _events_ms(alone, before=lambda: b.it.zero_())
    return 1e3 * graph / blk, 1e3 * kernel / blk


def _stage_ms(assoc, host, key, iters):
    """Device ms of each stage of the eager body on one frame's inputs,
    each stage's kernels captured and replayed as one graph."""
    from mcmtt_opticalflow_tpu_torch.models.associator3d import (
        FrameProgram, _compat_from, incompat_rows)
    from mcmtt_opticalflow_tpu_torch.models.costs import score_track_windows
    from mcmtt_opticalflow_tpu_torch.models.mwcp import (
        bls_result, bls_start, iters_padded, threefry_fields)
    from mcmtt_opticalflow_tpu_torch.ops.threefry_kernel import \
        threefry_fields_reference
    cfg, acfg = assoc._solver_cfg_fused, assoc.acfg
    r, vmax = cfg.num_replicas, cfg.max_vertices
    ip = iters_padded(cfg, iters)
    dev = assoc.device
    t = _uploads(host, dev)
    kd = key.to(dev)
    cols = (t[7], t[9], t[10])
    cols_f = (t[7], t[9].float(), t[10])
    nb = t[7].shape[0]
    f = threefry_fields(kd, r, vmax, ip, dev)
    _, weights, adj, valid = assoc._score_graph(*t[:12], cols)
    st = bls_start(weights, adj, valid, t[12], f, cfg, nb)
    blk = FrameProgram.BLOCK
    block = _block_us(st, f, cfg, blk)
    out = {
        "field draw": _graph_ms(
            lambda: threefry_fields(kd, r, vmax, ip, dev)),
        "field draw, plain version": _graph_ms(
            lambda: threefry_fields_reference(kd, r, vmax, ip)),
        "window scores": _graph_ms(lambda: score_track_windows(
            t[0].float(), t[1].float(), t[2], t[3].float(), t[4],
            assoc.cams, acfg)),
        "compatibility": _graph_ms(lambda: _compat_from(
            incompat_rows(*cols_f, cols_f, acfg), t[11])),
        "scoring part (window scores, weights, compatibility)": _graph_ms(
            lambda: assoc._score_graph(*t[:12], cols)),
        "greedy start (bls_start)": _graph_ms(
            lambda: bls_start(weights, adj, valid, t[12], f, cfg, nb)),
        # the block and its kernel alone, over the same iterations from
        # the same states (_block_us)
        f"BLS per iteration (a block of {blk})": block[0] / 1e3,
        f"BLS kernel alone per iteration (a block of {blk})": block[1] / 1e3,
        "K-best and packing": _graph_ms(
            lambda: assoc._pack_k_best(bls_result(st))),
    }
    return {k: round(v, 6) for k, v in out.items()}


def phase_graphs(cfg, sc, frames, card):
    """The captured fused 3D program against its eager body on the card:
    GRAPH_FRAMES bench frames through a pipelined engine, every program
    run's inputs and outputs recorded; the eager body on the same inputs
    and subkeys must give equal pack_a and pack_b bit for bit, over at
    least two buckets.  Then, on those inputs: the host ms of one
    dispatch, eager against replay (the engine's `hyp.dispatch`), and the
    wall ms to the card's completion; the device ms of each stage of the
    body; and the bench main path on the eager body (frames/s,
    `hyp.dispatch` and MOTA, against phase 3d's run on graphs)."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch import bench
    from mcmtt_opticalflow_tpu_torch.models.associator3d import FrameProgram
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine

    eng = TrackingEngine(cfg, sc.cameras, pipelined=True, device="cuda")
    calls = []
    orig = FrameProgram.__call__

    def record(prog, host, key, field_source=None):
        out = orig(prog, host, key, field_source)
        calls.append((prog.bucket, [np.array(x) for x in host], key.clone(),
                      tuple(o.clone() for o in out)))
        return out
    FrameProgram.__call__ = record
    try:
        _run_engine(eng, sc, frames, GRAPH_FRAMES)
    finally:
        FrameProgram.__call__ = orig
    torch.cuda.synchronize()
    assoc = eng.assoc
    buckets = sorted({c[0] for c in calls})
    for n, (bucket, host, key, out) in enumerate(calls):
        want = _eager_body(assoc, host, key, bucket[2])
        for name, g, w in zip(("pack_a", "pack_b"), out, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"graphs: the replayed {name} of solve {n} (bucket "
                     f"{bucket}) differs from the eager body's")
    log(f"graphs: {len(calls)} solves of {GRAPH_FRAMES} bench frames, "
        f"replayed pack_a and pack_b == the eager body's bit for bit, "
        f"buckets (nr, nb, iters) {buckets}; capture s "
        f"{[round(p.capture_s, 3) for p in assoc._programs.values()]}")
    if len(buckets) < 2:
        fail(f"graphs: compared {len(buckets)} bucket(s), expected >= 2")

    rows = {"eager": [], "replay": []}
    for bucket, host, key, _ in calls:
        rows["eager"].append(_timed_ms(
            lambda: _eager_body(assoc, host, key, bucket[2])))
        rows["replay"].append(_timed_ms(
            lambda: assoc._program(*bucket)(host, key)))
    med = {k: [round(float(np.median([x[i] for x in v])), 3)
               for i in (0, 1)] for k, v in rows.items()}
    log(f"graphs: one dispatch on the same {len(calls)} inputs, median host "
        f"ms (hyp.dispatch) eager {med['eager'][0]} replay "
        f"{med['replay'][0]}; wall ms to the card's completion eager "
        f"{med['eager'][1]} replay {med['replay'][1]} ({card})")
    bucket, host, key, _ = max(calls, key=lambda c: c[0])
    stages = _stage_ms(assoc, host, key, bucket[2])
    log(f"graphs: device ms per stage of the body, bucket {bucket} "
        f"(each stage replayed as one graph, CUDA events, median of 5; "
        f"{card}): {json.dumps(stages)}")

    with _EagerRoute(), EagerCount() as eager:
        run = bench.run_bench(MEASURED, "cuda")
    rec = run.record
    log(f"graphs: bench main path on the eager body ({eager.calls} eager "
        f"calls): {rec['value']} frames/s, hyp.dispatch "
        f"{rec['stage_ms'].get('hyp.dispatch')} ms, tracks_peak "
        f"{rec['tracks_peak']} ({card})")
    if eager.calls <= 0:
        fail("graphs: the eager-route bench run made no eager call")
    return rec, stages


def jv_case(rng, shape, ties):
    """One seeded assignment case: tests/test_torch_ops.py's tie-heavy
    generator (five values, 30% forbidden) or its random one (costs over
    five decades, 20% forbidden), 85% of rows and columns valid."""
    import numpy as np
    c, r, t = shape
    if ties:
        cost = rng.choice([0.0, 1.0, 2.0, 2.5, np.inf], (c, r, t),
                          p=[0.2, 0.2, 0.2, 0.1, 0.3])
    else:
        cost = rng.rand(c, r, t) * 10 ** rng.uniform(-2, 3)
        cost[rng.rand(c, r, t) < 0.2] = np.inf
    return (cost.astype(np.float32), rng.rand(c, r) < 0.85,
            rng.rand(c, t) < 0.85)


def jv_cases(n=100):
    """Seeded random assignment cases: `n` each of jv_case's random and
    tie-heavy generators at tests/test_torch_ops.py's shapes and the
    tracker's, and `n` with more rows than columns (the transposed
    solve), up to [2, 300, 100]."""
    import numpy as np
    rng = np.random.RandomState(0)
    square = [(3, 5, 7), (2, 6, 6), (4, 16, 32), (4, 32, 64), (4, 48, 64),
              (1, 1, 1), (3, 1, 9), (2, 128, 256)]
    tall = [(4, 8, 5), (4, 64, 48), (2, 70, 40), (3, 9, 1), (2, 300, 100)]
    out = []
    for kind, shapes in (("random", square), ("ties", square),
                         ("rows > columns", tall)):
        for k in range(n):
            ties = kind == "ties" or (kind != "random" and k % 2)
            out.append((kind, *jv_case(rng, shapes[k % len(shapes)], ties)))
    return out


# shapes an earlier JV kernel refused (its whole working matrix in shared
# memory: above a working side of ~240 cudaFuncSetAttribute failed)
JV_PAST_LIMIT = ((1, 256, 256), (1, 320, 320), (2, 400, 150),
                 (1, 12, 14000))


def jv_prepared(cost, row_mask, col_mask):
    """A zero-argument launch of the JV kernel on inputs made ready once
    (contiguous, the kernel's types, outputs and scratch allocated): no
    checks, no count."""
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import hungarian
    c, r, t = cost.shape
    ins = (cost.contiguous().float(), row_mask.contiguous().bool(),
           col_mask.contiguous().bool())
    outs = (torch.empty((c, r), dtype=torch.int32, device=cost.device),
            torch.empty((c, r), device=cost.device),
            hungarian.jv_scratch(c, r, t, cost.device))
    return lambda: hungarian._launch(*ins, *outs)


def jv_compare(cost, row_mask, col_mask, label):
    """One kernel launch against the plain version on the same inputs:
    col_of_row equal and match_cost equal bit for bit, or fail.  Returns
    (the plain version's matches, the largest |match_cost difference|)."""
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import hungarian
    col_k, mc_k = hungarian.jv_assign(cost, row_mask, col_mask)
    torch.cuda.synchronize()
    col_r, mc_r = hungarian.jv_assign_reference(cost, row_mask, col_mask)
    if not torch.equal(col_k.cpu(), col_r) or \
            not _bits_equal(mc_k.cpu(), mc_r):
        fail(f"jv_assign: the kernel differs from its plain version on "
             f"{label} {tuple(cost.shape)}")
    return int((col_r >= 0).sum()), _max_abs_err([(mc_k, mc_r)])


def _jv_timed(cases):
    """Per case (cost, row mask, col mask on the card): (device-only µs a
    launch, the serial Dijkstra steps of the slowest camera)."""
    from mcmtt_opticalflow_tpu_torch.ops import hungarian
    out = []
    for cost, rm, cm in cases:
        reps = 10 if cost.shape[1] * cost.shape[2] > 10000 else REPS
        out.append((device_us(jv_prepared(cost, rm, cm), reps=reps),
                    hungarian.jv_work(cost, rm, cm)["max_steps"]))
    return out


def phase_jv(recorded, card, cli_recorded=()):
    """The JV kernel on the card against its plain version on every
    recorded bench assignment, on jv_cases() and on JV_PAST_LIMIT's
    shapes; then per recorded frame its device-only µs (as phase 3b times
    the LK kernel), the wrapper's host µs per call, the plain version's
    ms, the serial Dijkstra steps and the bound
    (ops/hungarian.py::jv_work); the device-only ns a Dijkstra step on
    the bench's, the CLI's (`cli_recorded`) and the past-the-limit
    cases.  Returns the kernels-line summary."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import hungarian, lk_kernel

    matched, errs = zip(*[jv_compare(*x, f"bench frame {t}")
                          for t, x in enumerate(recorded)])
    errs = list(errs)
    kinds = {}
    for n, (kind, *case) in enumerate(jv_cases()):
        args = [torch.tensor(x, device="cuda") for x in case]
        errs.append(jv_compare(*args, f"case {n} ({kind})")[1])
        kinds[kind] = kinds.get(kind, 0) + 1
    rng = np.random.RandomState(1)
    past = []
    for shape in JV_PAST_LIMIT:
        for ties in (False, True):
            args = [torch.tensor(x, device="cuda")
                    for x in jv_case(rng, shape, ties)]
            errs.append(jv_compare(
                *args, f"{'ties' if ties else 'random'} case past the old "
                       f"limit")[1])
            past.append(args)
    for t, x in enumerate(cli_recorded):
        errs.append(jv_compare(*x, f"CLI frame {t}")[1])
    log(f"jv: kernel == plain version (col_of_row equal, match_cost bit "
        f"for bit) on all {len(recorded)} bench frames' "
        f"{list(recorded[0][0].shape)} assignments ({sum(matched)} "
        f"matches), all {len(cli_recorded)} CLI frames' "
        f"{list(cli_recorded[0][0].shape) if cli_recorded else []}, "
        f"{sum(kinds.values())} random cases {json.dumps(kinds)} and "
        f"{len(past)} cases past the old kernel's limit "
        f"{[list(x) for x in JV_PAST_LIMIT]} (layouts "
        f"{[hungarian.jv_layout(r, t) for _, r, t in JV_PAST_LIMIT]})")
    lib = lk_kernel.build()
    stream = torch.cuda.current_stream().cuda_stream
    noop = device_us(lambda: lib.lk_noop_launch(stream))
    rows = []
    for cost, rm, cm in recorded:
        dev = device_us(jv_prepared(cost, rm, cm))
        host = host_us(lambda: hungarian.jv_assign(cost, rm, cm))
        plain = time_ms(lambda: hungarian.jv_assign_reference(cost, rm, cm),
                        reps=5)
        work = hungarian.jv_work(cost, rm, cm)
        t_bytes = 1e6 * work["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e6 * work["flops"] / FP32_FLOPS_PER_S
        rows.append((dev, host, plain, t_bytes, t_ops, work["steps"],
                     work["max_steps"], work["bytes"], work["flops"]))
    a = np.asarray(rows, np.float64)
    mean = a.mean(0)
    bound = np.maximum(a[:, 3], a[:, 4])
    bound_by = "bytes" if mean[3] >= mean[4] else "operations"
    ns_step = 1e3 * mean[0] / mean[6]
    log(f"jv: per bench frame (1 launch, {len(rows)} frames; {card}): "
        f"device-only {mean[0]:.3f} us (min {a[:, 0].min():.3f}, max "
        f"{a[:, 0].max():.3f}), wrapper host {mean[1]:.3f} us/call, plain "
        f"(download + host JV) {mean[2]:.4f} ms; work {mean[7]:.0f} B, "
        f"{mean[8]:.0f} flop; bound {bound.mean():.5f} us ({bound_by}), "
        f"roofline share {bound.mean() / mean[0]:.5f}; serial Dijkstra "
        f"steps: {mean[5]:.1f} over the 4 cameras, {mean[6]:.1f} in the "
        f"slowest (max {a[:, 6].max():.0f}), {ns_step:.1f} ns a step of "
        f"the slowest camera; empty-kernel floor {noop:.3f} us; layout "
        f"{hungarian.jv_layout(*recorded[0][0].shape[1:])}")
    out = {"ms": mean[0] / 1e3, "plain_ms": mean[2],
           "bound_ms": bound.mean() / 1e3, "bound_by": bound_by,
           "device_us_per_launch": mean[0], "host_us_per_call": mean[1],
           "bound_us": bound.mean(), "serial_steps": mean[5],
           "serial_steps_slowest_camera": mean[6],
           "device_ns_per_step": ns_step, "max_abs_err": max(errs)}
    timed = {"cli": _jv_timed(cli_recorded), "past the old limit":
             _jv_timed(past)}
    for name, t in timed.items():
        if t:
            us, steps = np.asarray(t, np.float64).mean(0)
            log(f"jv: {name} ({len(t)} cases; {card}): device-only "
                f"{us:.3f} us a launch, {steps:.1f} serial steps in the "
                f"slowest camera, {1e3 * us / steps:.1f} ns a step")
    if timed["cli"]:
        us, steps = np.asarray(timed["cli"], np.float64).mean(0)
        out["device_us_per_launch_cli"] = us
        out["device_ns_per_step_cli"] = 1e3 * us / steps
    out["device_ns_per_step_past_old_limit"] = {
        f"{list(x[0].shape)}{' ties' if k % 2 else ''}": 1e3 * us / steps
        for k, (x, (us, steps)) in enumerate(zip(past,
                                                 timed["past the old "
                                                       "limit"]))}
    return out


class SolveCapture:
    """While active, records (cloned) the solver inputs of every captured
    3D program call (models/associator3d.py::FrameProgram): the graph
    (weights, adjacency, validity), the warm starts, the random fields,
    the greedy bound (the bucket's graph rows), the solver configuration
    (`solver_cfg` with the program's replica count), the K-best size
    (the replicas beyond solver_cfg's, one a carried hypothesis) and the
    subkey the fields were drawn from; the head's outputs, the fields and
    the key are the program's own buffers, so they are cloned after each
    call, before the next."""

    def __init__(self, solver_cfg):
        self.solver_cfg, self.solves = solver_cfg, []

    def __enter__(self):
        import dataclasses
        from mcmtt_opticalflow_tpu_torch.models.associator3d import \
            FrameProgram
        from mcmtt_opticalflow_tpu_torch.models.mwcp import MwcpFields
        self.cls, self.orig = FrameProgram, FrameProgram.__call__

        def call(prog, host, key, field_source=None):
            out = self.orig(prog, host, key, field_source)
            st = prog.head.out[1]
            f = MwcpFields(*[x.clone() for x in prog.fields])
            self.solves.append({
                "weights": st.weights.clone(), "adj": st.adj.clone(),
                "valid": st.valid.clone(), "init": prog.inputs[12].clone(),
                "fields": f, "key": prog.key.clone(),
                "bound": prog.bucket[1],
                "k": f.noise.shape[0] - self.solver_cfg.num_replicas,
                "cfg": dataclasses.replace(
                    self.solver_cfg, num_replicas=f.noise.shape[0])})
            return out
        FrameProgram.__call__ = call
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig


def _clone_state(st):
    return type(st)(*[x.clone() for x in st])


# the BLS state that its decisions write (its float scores, fbest and the
# ring's, carry the sums' rounding)
BLS_DECISIONS = ("in_c", "tabu", "best", "cp", "wcnt", "l_left",
                 "use_directed", "sol_masks", "sol_next")


def _ascending_sum(w, mask):
    """The weights of `mask`'s members added in ascending order from 0 in
    float32, as the solver's kernels sum a clique (numpy)."""
    import numpy as np
    s = np.float32(0.0)
    for c in np.flatnonzero(mask):
        s = np.float32(s + w[c])
    return s


def _kernel_sums(w, adj, in_c):
    """The BLS kernel's float32 sums for one replica, members ascending
    (csrc/mwcp_bls.cu): the clique weight fc and every vertex's weight sum
    over its adjacent members (numpy)."""
    import numpy as np
    nbr = np.zeros(len(w), np.float32)
    for c in np.flatnonzero(in_c):
        nbr = np.where(adj[:, c], nbr + w[c], nbr).astype(np.float32)
    return _ascending_sum(w, in_c), nbr


def _record_flips(a0, b0, r, score_k, score_p, mask):
    """The record's tests whose outcome differs between the kernel's state
    a0 and the plain version's b0 for replica r inserting `mask` with
    scores score_k / score_p: (test, (kernel operands), (plain
    operands))."""
    import numpy as np
    out = []
    if (score_k > 0) != (score_p > 0):
        out.append(("score > 0", (score_k, 0.0), (score_p, 0.0)))
    ring = a0.sol_masks[r].cpu().numpy()
    sk = a0.sol_scores[r].cpu().numpy()
    sp = b0.sol_scores[r].cpu().numpy()
    for s in range(len(sk)):
        if np.array_equal(ring[s], mask):
            dk = abs(np.float32(sk[s] - score_k)) < np.float32(1e-5)
            dp = abs(np.float32(sp[s] - score_p)) < np.float32(1e-5)
            if dk != dp:
                out.append((f"|ring score {s} - score| < 1e-5",
                            (sk[s], score_k), (sp[s], score_p)))
    return out


def _iteration_flips(a0, b0, cfg, r):
    """The comparisons of replica r's next BLS iteration that the
    summation order can decide, each whose outcome differs between the
    kernel's state a0 and the plain version's b0 (both before the
    iteration, their decisions equal): (comparison, (kernel operands),
    (plain operands)).  The kernel's sums are `_kernel_sums`; the plain
    version's are its own torch.sum and product on the card."""
    import numpy as np
    import torch
    w = a0.weights.cpu().numpy()
    adj = a0.adj.cpu().numpy()
    in_c = a0.in_c[r].cpu().numpy()
    fc_k, nbr_k = _kernel_sums(w, adj, in_c)
    in_w = torch.where(b0.in_c, b0.weights, 0.0)
    fc_p = np.float32(torch.sum(in_w, -1)[r].item())
    nbr_p = (in_w @ b0.adj.to(torch.float32).T)[r].cpu().numpy()
    out = []
    fb_k = np.float32(a0.fbest[r].item())
    fb_p = np.float32(b0.fbest[r].item())
    if (fc_k > fb_k) != (fc_p > fb_p):
        out.append(("fc > fbest", (fc_k, fb_k), (fc_p, fb_p)))
    out += _record_flips(a0, b0, r, fc_k, fc_p, in_c)
    alpha = np.float32(cfg.alpha_s if int(a0.wcnt[r]) == 0 else cfg.alpha_r)
    th_k, th_p = np.float32(alpha * fc_k), np.float32(alpha * fc_p)
    live = (a0.valid.cpu().numpy() & ~in_c
            & (a0.tabu[r].cpu().numpy() > int(a0.it)))
    for v in np.flatnonzero(live & ((nbr_k >= th_k) != (nbr_p >= th_p))):
        out.append((f"nbr_w_in_c[{v}] >= alpha * fc", (nbr_k[v], th_k),
                    (nbr_p[v], th_p)))
    return out


def _parted(a, b):
    """[R] bool (on b's device): replicas whose decisions differ between
    two states."""
    import torch
    out = torch.zeros(b.in_c.shape[0], dtype=torch.bool,
                      device=b.in_c.device)
    for name in BLS_DECISIONS:
        x, y = getattr(a, name).to(b.in_c.device), getattr(b, name)
        out |= (x != y).reshape(x.shape[0], -1).any(-1)
    return out


def _first_parting(sa, sb, fa, fb, cfg, iters, final=True):
    """The BLS kernel from the state sa on the fields fa and its plain
    version from sb on fb (on their own device) in lockstep, one
    iteration at a time, then with `final` the final record: (the
    iteration whose decisions part first, -1 for the final record, the
    parting replicas and their flipped comparisons), or None when no
    decision parts."""
    from mcmtt_opticalflow_tpu_torch.models.mwcp import bls_result
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel as mk
    a, b = _clone_state(sa), _clone_state(sb)
    for i in range(iters + final):
        a0, b0 = _clone_state(a), _clone_state(b)
        if i < iters:
            mk.bls_steps(a, fa, cfg, 1)
            mk.bls_steps_reference(b, fb, cfg, 1)
        else:
            bls_result(a)
            bls_result(b)
        parted = _parted(a, b)
        if parted.any():
            rows = parted.nonzero().flatten().tolist()
            if i < iters:
                flips = {r: _iteration_flips(a0, b0, cfg, r) for r in rows}
            else:
                flips = {r: _record_flips(
                    a0, b0, r, a0.fbest[r].item(), b0.fbest[r].item(),
                    a0.best[r].cpu().numpy()) for r in rows}
            return (int(a0.it) if i < iters else -1), rows, flips
    return None


LOCKSTEP_CHUNK = 50         # iterations between the lockstep's comparisons


def _lockstep(st0, f, cfg, iters):
    """The BLS kernel and its plain version from st0 on the fields f, in
    chunks of LOCKSTEP_CHUNK iterations, their decisions compared after
    each; the first chunk that parts is run again one iteration at a time
    from its start (_first_parting), and with no chunk parted the final
    record is compared.  Returns (the kernel's state, the plain
    version's, the first parting or None)."""
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel as mk
    sk, sp = _clone_state(st0), _clone_state(st0)
    part = None
    for c0 in range(0, iters, LOCKSTEP_CHUNK):
        n = min(LOCKSTEP_CHUNK, iters - c0)
        if part is None:
            a, b = _clone_state(sk), _clone_state(sp)
        mk.bls_steps(sk, f, cfg, n)
        mk.bls_steps_reference(sp, f, cfg, n)
        if part is None and _parted(sk, sp).any():
            part = _first_parting(a, b, f, f, cfg, n, final=False)
            if part is None:
                fail(f"mwcp: iterations {c0}-{c0 + n - 1} part when run "
                     f"together and not one at a time: a run differs from "
                     f"its rerun")
    if part is None:
        part = _first_parting(sk, sp, f, f, cfg, 0)
    return sk, sp, part


def explain_parting(label, part):
    """Print where the kernel and the plain version part (the first step
    whose decisions differ, its replicas, the comparisons that flipped
    with their operands) and fail when a replica parts with no flipped
    comparison, or at one whose plain operands lie more than 1e-5
    relative apart: a fault, not the sums' rounding."""
    i, parted, flips = part
    where = "the final record" if i < 0 else f"iteration {i}"
    for r in parted:
        shown = [(c, [float(x) for x in k], [float(x) for x in p])
                 for c, k, p in flips[r]]
        log(f"{label}: replica {r} parts at {where}: (comparison, kernel "
            f"operands, plain operands) {shown}")
        if not flips[r]:
            fail(f"{label}: replica {r} parts at {where} and no "
                 f"rounding-decided comparison flipped: a fault")
        for c, _, (x, y) in flips[r]:
            if _rel(x, y) > 1e-5:
                fail(f"{label}: {c} flipped with plain operands {x} and "
                     f"{y}, {_rel(x, y):.3e} apart (over 1e-5 relative: a "
                     f"fault, not rounding)")


def _rel(x, y):
    return abs(float(x) - float(y)) / max(abs(float(x)), abs(float(y)),
                                         1e-30)


def _check_k_best(kb, kb_plain, w, adj, valid, label):
    """Every K-best entry a clique of valid vertices whose score is its
    weight sum within 1e-4 (relative, at least absolute), no clique twice;
    the top score at least 0.99 x the plain version's.  Returns the top
    scores."""
    import numpy as np
    masks, scores = (x.cpu().numpy() for x in kb)
    w64 = w.cpu().numpy().astype(np.float64)
    a, va = adj.cpu().numpy(), valid.cpu().numpy()
    live = np.flatnonzero(scores > NEG_SCORE / 2)
    if len({masks[j].tobytes() for j in live}) != len(live):
        fail(f"mwcp: {label}: the K-best holds a clique twice")
    for j in live:
        idx = np.flatnonzero(masks[j])
        sub = a[np.ix_(idx, idx)] | np.eye(len(idx), dtype=bool)
        if not (len(idx) and va[idx].all() and sub.all()):
            fail(f"mwcp: {label}: K-best entry {j} is not a clique of valid "
                 f"vertices")
        tot = w64[idx].sum()
        if abs(scores[j] - tot) > 1e-4 * max(1.0, abs(tot)):
            fail(f"mwcp: {label}: K-best entry {j} scores {scores[j]} "
                 f"against its weight sum {tot}")
    top, top_p = float(scores[0]), float(kb_plain[1][0])
    if top_p > 0 and top < 0.99 * top_p:
        fail(f"mwcp: {label}: the kernel's top score {top} is below 0.99 x "
             f"the plain version's {top_p}")
    return top, top_p


def _mwcp_check(solves, name):
    """The solver's kernels against their plain versions on recorded
    solves; see phase_mwcp.  Returns (the largest |score difference| of
    the solves equal up to rounding, the largest |clique weight
    difference|, the largest |greedy start mask difference|)."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.models.mwcp import (
        bls_result, bls_start, device_k_best, replica_orders)
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel as mk

    n_eq = n_round = rows = 0
    err, ratio, clique_err, greedy_err = 0.0, [], 0.0, 0.0
    for n, s in enumerate(solves):
        label = f"{name} solve {n}"
        w, adj, valid, f, cfg = (s["weights"], s["adj"], s["valid"],
                                 s["fields"], s["cfg"])
        orders = replica_orders(w, valid, f.noise)
        greedy = mk.greedy_start(w, adj, valid, orders, s["bound"])
        greedy_p = mk.greedy_start_reference(w, adj, valid, orders,
                                             s["bound"])
        if not torch.equal(greedy, greedy_p):
            fail(f"mwcp: {label}: the greedy kernel differs from its plain "
                 f"version")
        greedy_err = max(greedy_err, _max_abs_err([(greedy, greedy_p)]))
        rows += greedy.shape[0]
        st0 = bls_start(w, adj, valid, s["init"], f, cfg, s["bound"])
        # the start scores: the clique-weight kernel's ascending sums, bit
        # for bit, and the plain version's within the orders' rounding
        got = mk.clique_weights(st0.in_c, w)
        w_np, in_np = w.cpu().numpy(), st0.in_c.cpu().numpy()
        want = [_ascending_sum(w_np, m) for m in in_np]
        if not np.array_equal(got.cpu().numpy(), np.asarray(want,
                                                            np.float32)):
            fail(f"mwcp: {label}: the clique-weight kernel differs from an "
                 f"ascending float32 sum")
        plain = mk.clique_weights_reference(st0.in_c, w)
        rel = float(((got - plain).abs() / plain.abs().clamp(min=1e-30))
                    .max())
        if rel > 1e-5:
            fail(f"mwcp: {label}: clique weights {rel:.3e} relative from "
                 f"the plain version")
        clique_err = max(clique_err, float((got - plain).abs().max()))
        sk, sp, part = _lockstep(st0, f, cfg, f.g_dir.shape[0])
        kb = device_k_best(bls_result(sk), s["k"])
        kb_p = device_k_best(bls_result(sp), s["k"])
        top, top_p = _check_k_best(kb, kb_p, w, adj, valid, label)
        ratio.append(top / top_p if top_p > 0 else 1.0)
        if torch.equal(kb[0], kb_p[0]) and torch.equal(kb[1], kb_p[1]):
            n_eq += 1
            continue
        if part is None:
            # no decision parted: the rings hold the same masks, their
            # scores the sums' rounding
            if not torch.equal(sk.sol_masks, sp.sol_masks):
                fail(f"mwcp: {label}: the rings differ with no decision "
                     f"parted")
            live = sp.sol_scores > NEG_SCORE / 2
            d = (sk.sol_scores - sp.sol_scores)[live].abs()
            rel = float((d / sp.sol_scores[live].abs().clamp(min=1e-30))
                        .max()) if d.numel() else 0.0
            log(f"mwcp: {label}: K-best differs, no decision parted; ring "
                f"scores within {rel:.3e} relative (summation order)")
            if rel > 1e-5:
                fail(f"mwcp: {label}: scores differ by {rel} relative")
            n_round += 1
            err = max(err, float(d.max()) if d.numel() else 0.0)
            continue
        explain_parting(f"mwcp: {label}", part)
    log(f"mwcp: {name}: {len(solves)} recorded solves, {rows} greedy "
        f"replicas bit-equal to the plain version, their start scores "
        f"equal to ascending float32 sums (largest |difference| from "
        f"torch.sum {clique_err:.3e}); BLS K-best masks and "
        f"scores equal on {n_eq}, equal up to the sums' rounding (no "
        f"decision parted) on {n_round}, parted within rounding on "
        f"{len(solves) - n_eq - n_round}; kernel / plain top score min "
        f"{min(ratio):.6f} mean {sum(ratio) / len(ratio):.6f}")
    return err, clique_err, greedy_err


def _mwcp_times(solves, card, name="bench", plain_too=True):
    """Per recorded solve: each kernel's device-only µs (behind a sleep
    kernel, median of 3, as phase 3b), its wrapper's host µs per call and
    the bound from greedy_work / bls_work / clique_work; the library call
    torch.sum(torch.where(...)) beside the clique weights, timed alike;
    on every PLAIN_EVERY-th solve the plain versions' ms
    (with `plain_too`) and a BLOCK-iteration BLS block as the captured
    program replays it and its kernel alone (_block_us, phase 3c's
    measure).  Returns the kernels-line summaries (means over the
    solves)."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.models.associator3d import FrameProgram
    from mcmtt_opticalflow_tpu_torch.models.mwcp import (bls_start,
                                                         replica_orders)
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel as mk

    lib = lk_kernel.build()
    stream = torch.cuda.current_stream().cuda_stream
    noop = device_us(lambda: lib.lk_noop_launch(stream))
    g_rows, b_rows, c_rows, lib_us = [], [], [], []
    plain = {"greedy": [], "bls": [], "clique": []}
    block_us = []
    for n, s in enumerate(solves):
        w, adj, valid, f, cfg, bound = (s["weights"], s["adj"], s["valid"],
                                        s["fields"], s["cfg"], s["bound"])
        r, v = f.noise.shape
        iters = f.g_dir.shape[0]
        orders = replica_orders(w, valid, f.noise)
        out = torch.empty((r, v), dtype=torch.bool, device=w.device)
        gs = mk.greedy_scratch(v, w.device)
        gw = mk.greedy_work(w, adj, valid, orders, bound)

        def greedy():
            mk._launch_greedy(w, adj, valid, orders, bound, out, gs)
        g_rows.append((
            device_us(greedy),
            host_us(lambda: mk.greedy_start(w, adj, valid, orders, bound)),
            0.0, 1e6 * gw["bound_s"], gw["steps"], gw["max_steps"],
            gw["bytes"], gw["ops"], gw["bound_by"] == "bytes"))
        st = bls_start(w, adj, valid, s["init"], f, cfg, bound)
        scores = torch.empty(r, device=w.device)
        cw = mk.clique_work(st.in_c, w)
        lib_us.append(device_us(
            lambda: torch.sum(torch.where(st.in_c, w, 0.0), -1)))
        c_rows.append((
            device_us(lambda: mk._launch_clique(st.in_c, w, scores)),
            host_us(lambda: mk.clique_weights(st.in_c, w)),
            0.0, 1e6 * cw["bound_s"], cw["steps"], cw["max_steps"],
            cw["bytes"], cw["ops"], cw["bound_by"] == "bytes"))
        bw = mk.bls_work(st, f, cfg, iters)
        run, calls, ref, blk = (_clone_state(st) for _ in range(4))
        scratch = mk.bls_scratch(run)
        b_rows.append((
            device_us(lambda: mk._launch_bls(run, f, cfg, iters, scratch),
                      reps=10),
            host_us(lambda: mk.bls_steps(calls, f, cfg, FrameProgram.BLOCK),
                    reps=20),
            0.0, 1e6 * bw["bound_s"], iters, bw["bytes"], bw["ops"],
            bw["bound_by"] == "bytes"))
        if n % PLAIN_EVERY == 0:
            block_us.append(_block_us(blk, f, cfg, FrameProgram.BLOCK))
        if plain_too and n % PLAIN_EVERY == 0:   # eager plain versions: slow

            def plain_solve():
                ref.it.zero_()
                mk.bls_steps_reference(ref, f, cfg, iters)
            plain["greedy"].append(time_ms(
                lambda: mk.greedy_start_reference(w, adj, valid, orders,
                                                  bound), reps=3))
            plain["bls"].append(time_ms(plain_solve, reps=2))
            plain["clique"].append(time_ms(
                lambda: mk.clique_weights_reference(st.in_c, w), reps=5))
    g, b, c = (np.asarray(x, np.float64) for x in (g_rows, b_rows, c_rows))
    gm, bm, cm = g.mean(0), b.mean(0), c.mean(0)
    for m, k in ((gm, "greedy"), (bm, "bls"), (cm, "clique")):
        m[2] = float(np.mean(plain[k])) if plain_too else float("nan")
    iters = bm[4]
    lay = mk.bls_layout(v, solves[0]["cfg"].solutions_per_replica)
    out_bls = {
        "ms": bm[0] / 1e3, "plain_ms": bm[2], "bound_ms": bm[3] / 1e3,
        "bound_by": "bytes" if bm[7] >= 0.5 else "operations",
        "device_us_per_launch": bm[0],
        "device_us_per_iteration": bm[0] / iters,
        "graph_block_us_per_iteration": float(np.mean(block_us, 0)[0]),
        "kernel_block_us_per_iteration": float(np.mean(block_us, 0)[1]),
        "host_us_per_call": bm[1], "bound_us": bm[3], "serial_steps": iters,
        "layout": lay}
    g_by = "bytes" if gm[8] >= 0.5 else "operations"
    out_greedy = {
        "ms": gm[0] / 1e3, "plain_ms": gm[2], "bound_ms": gm[3] / 1e3,
        "bound_by": g_by, "device_us_per_launch": gm[0],
        "host_us_per_call": gm[1], "bound_us": gm[3], "serial_steps": gm[4],
        "serial_steps_largest_clique": gm[5],
        "device_us_per_round": gm[0] / gm[5]}
    log(f"mwcp: greedy_start per {name} solve ({len(g)} solves, 1 launch, "
        f"[{r}, {v}], layout {mk.greedy_layout(v)}; {card}): device-only "
        f"{gm[0]:.3f} us (min {g[:, 0].min():.3f}, max {g[:, 0].max():.3f})"
        f", wrapper host {gm[1]:.3f} us/call, plain {gm[2]:.4f} ms; work "
        f"{gm[6]:.0f} B, {gm[7]:.0f} ops; bound {gm[3]:.5f} us ({g_by}), "
        f"roofline share {gm[3] / gm[0]:.5f}; serial rounds {gm[4]:.1f} "
        f"over the replicas, {gm[5]:.1f} in the largest clique "
        f"({gm[0] / gm[5]:.4f} us a round of it); empty-kernel floor "
        f"{noop:.3f} us")
    c_by = "bytes" if cm[8] >= 0.5 else "operations"
    lib_mean = float(np.mean(lib_us))
    plain_c = f"plain {cm[2]:.4f} ms; " if plain_too else ""
    log(f"mwcp: clique_weights per {name} solve ({len(c)} solves, 1 "
        f"launch, [{r}, {v}]; {card}): device-only {cm[0]:.3f} us (min "
        f"{c[:, 0].min():.3f}, max {c[:, 0].max():.3f}; empty-kernel floor "
        f"{noop:.3f}), "
        f"wrapper host {cm[1]:.3f} us/call, {plain_c}library call "
        f"torch.sum(torch.where(masks, weights, 0.0), -1) device-only "
        f"{lib_mean:.3f} us ({lib_mean / cm[0]:.2f}x the kernel); work "
        f"{cm[6]:.0f} B, {cm[7]:.0f} ops; bound {cm[3]:.5f} us ({c_by}), "
        f"roofline share {cm[3] / cm[0]:.5f}; serial additions {cm[5]:.1f} "
        f"in the largest clique")
    out_clique = {
        "ms": cm[0] / 1e3, "plain_ms": cm[2], "bound_ms": cm[3] / 1e3,
        "bound_by": c_by, "device_us_per_launch": cm[0],
        "host_us_per_call": cm[1], "bound_us": cm[3], "serial_steps": cm[5],
        "library_ms": lib_mean / 1e3}
    if not plain_too:
        log(f"mwcp: bls_steps per {name} solve ({len(b)} solves, "
            f"{iters:.0f} iterations in 1 launch, R={r}, V={v}, layout "
            f"{lay}; {card}): device-only {bm[0]:.3f} us "
            f"({bm[0] / iters:.4f} us an iteration; min "
            f"{b[:, 0].min() / iters:.4f}, max {b[:, 0].max() / iters:.4f});"
            f" a {FrameProgram.BLOCK}-iteration block as a graph "
            f"{out_bls['graph_block_us_per_iteration']:.4f} us an iteration,"
            f" its kernel alone "
            f"{out_bls['kernel_block_us_per_iteration']:.4f}; wrapper host "
            f"{bm[1]:.3f} us/call; bound {bm[3]:.4f} us "
            f"({out_bls['bound_by']}), roofline share {bm[3] / bm[0]:.6f}")
        return {"greedy_start": out_greedy, "bls_steps": out_bls,
                "clique_weights": out_clique}
    b_by = "bytes" if bm[7] >= 0.5 else "operations"
    log(f"mwcp: bls_steps per bench solve ({len(b)} solves, {iters:.0f} "
        f"iterations in 1 launch, R={r}, V={v}; {card}): device-only "
        f"{bm[0]:.3f} us ({bm[0] / iters:.4f} us an iteration; min "
        f"{b[:, 0].min() / iters:.4f}, max {b[:, 0].max() / iters:.4f}), "
        f"wrapper host {bm[1]:.3f} us/call, plain {bm[2]:.4f} ms "
        f"({bm[2] / iters:.5f} ms an iteration); work {bm[5]:.0f} B, "
        f"{bm[6]:.0f} ops; bound {bm[3]:.4f} us ({b_by}; "
        f"{bm[3] / iters:.6f} us an iteration), roofline share "
        f"{bm[3] / bm[0]:.6f}; serial steps {iters:.0f}; layout {lay}; a "
        f"{FrameProgram.BLOCK}-iteration block as a graph "
        f"{out_bls['graph_block_us_per_iteration']:.4f} us an iteration, "
        f"its kernel alone {out_bls['kernel_block_us_per_iteration']:.4f}")
    return {"greedy_start": out_greedy, "bls_steps": out_bls,
            "clique_weights": out_clique}


# the synthetic solves past the shared-memory layouts: (V, valid)
LARGE_SOLVES = ((6144, 6000), (16400, 16000))


def _large_solve_check(v, n, card):
    """A synthetic solve at V vertices (n valid, R=4, S=16, 60 iterations,
    integer weights: every sum exact in any order): its greedy start (the
    kernel, in bls_start) equal to the plain greedy's; from it the BLS
    kernel (a 50- and a 10-iteration launch) against its plain version,
    every BlsState tensor bit for bit."""
    import dataclasses
    import torch
    from mcmtt_opticalflow_tpu_torch.config import SolverConfig
    from mcmtt_opticalflow_tpu_torch.models.mwcp import (bls_start,
                                                         replica_orders,
                                                         threefry_fields)
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel as mk
    from mcmtt_opticalflow_tpu_torch.utils import prng
    g = torch.Generator(device="cuda").manual_seed(v)
    w = torch.floor(torch.rand(v, generator=g, device="cuda") * 30)
    up = torch.triu(torch.rand((v, v), generator=g, device="cuda") < 0.5, 1)
    adj = up | up.T
    del up
    valid = torch.arange(v, device="cuda") < n
    adj &= valid[:, None] & valid[None, :]
    cfg = dataclasses.replace(SolverConfig(), num_replicas=4,
                              max_vertices=v, solutions_per_replica=16)
    f = threefry_fields(prng.prng_key(v), 4, v, 60, "cuda")
    st = bls_start(w, adj, valid, torch.zeros((1, v), dtype=torch.bool,
                                              device="cuda"), f, cfg, v)
    start = mk.greedy_start_reference(w, adj, valid,
                                      replica_orders(w, valid, f.noise), v)
    if not torch.equal(st.in_c, start):
        fail(f"mwcp: synthetic solve V={v}: the greedy start differs from "
             f"the plain greedy's")
    ref = _clone_state(st)
    t0 = time.perf_counter()
    for k in (50, 10):
        mk.bls_steps(st, f, cfg, k)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    mk.bls_steps_reference(ref, f, cfg, 60)
    bad = [name for name, a, b in zip(st._fields, st, ref)
           if not _bits_equal(a, b)]
    moved = int((st.tabu != 0).sum())
    log(f"mwcp: synthetic solve V={v} (n={n}, R=4, S=16, 60 iterations, "
        f"integer weights; layout {mk.bls_layout(v, 16)}): the kernel's "
        f"BlsState {'bit-equal to' if not bad else 'DIFFERS from'} the "
        f"plain version's ({moved} tabu stamps set, clique sizes "
        f"{st.in_c.sum(-1).tolist()}, {kernel_s:.3f} s with its launches' "
        f"host work; {card})")
    if bad:
        fail(f"mwcp: synthetic solve V={v}: {bad} differ from the plain "
             f"version")
    if moved == 0:
        fail(f"mwcp: synthetic solve V={v}: no vertex ever left a clique")


# the greedy start in each of its layouts (mwcp_kernel.greedy_layout):
# V, valid vertices (the plain loop's length), replicas, symmetric, tier.
# V=40000 lies past an earlier kernel's shared-memory limit (6 V bytes: it
# failed above V ~ 38,700)
GREEDY_CASES = ((40000, 256, 4, True, 2), (6144, 1500, 4, True, 1),
                (1100, 1000, 8, True, 0), (1024, 900, 8, False, 0))


def _greedy_checks(card):
    """The greedy kernel against its plain version, in_c equal, on
    GREEDY_CASES (dense random adjacency, integer weights, the valid
    vertices spread over V, bound min(V, valid)): tier 2 (V=40000), tier
    1 (V=6144), tier 0 past the register bit sets (V=1100) and in them
    on an adjacency that is not symmetric (V=1024), where the kernel
    still reads adj[candidate][member] as the plain version does."""
    import torch
    from mcmtt_opticalflow_tpu_torch.models.mwcp import NEG
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel as mk
    for v, n, r, sym, tier in GREEDY_CASES:
        lay = mk.greedy_layout(v)
        if lay["tier"] != tier:
            fail(f"mwcp: greedy start V={v}: layout {lay}, expected tier "
                 f"{tier}")
        g = torch.Generator(device="cuda").manual_seed(v)
        adj = torch.randint(0, 10, (v, v), generator=g, device="cuda",
                            dtype=torch.uint8) < 8
        if sym:
            adj = torch.triu(adj, 1)
            adj |= adj.T.clone()
        w = torch.floor(torch.rand(v, generator=g, device="cuda") * 30)
        valid = torch.zeros(v, dtype=torch.bool, device="cuda")
        valid[torch.randperm(v, generator=g, device="cuda")[:n]] = True
        noise = torch.rand((r, v), generator=g, device="cuda") * 9
        noise[0] = 0
        orders = torch.argsort(-torch.where(valid, w + noise, NEG), dim=-1,
                               stable=True).contiguous()
        bound = n if v > 1024 else v
        got = mk.greedy_start(w, adj, valid, orders, bound)
        torch.cuda.synchronize()
        want = mk.greedy_start_reference(w, adj, valid, orders, bound)
        same = torch.equal(got, want)
        log(f"mwcp: greedy start V={v} ({n} valid, R={r}, bound {bound}, "
            f"{'symmetric' if sym else 'not symmetric'} adjacency; layout "
            f"{lay}): kernel {'==' if same else 'DIFFERS from'} plain "
            f"version, clique sizes {got.sum(-1).tolist()} ({card})")
        if not same:
            fail(f"mwcp: greedy start V={v}: the kernel differs from its "
                 f"plain version")
        del adj
        torch.cuda.empty_cache()


# the clique-weight kernel past the recorded shapes: (R, V, member
# density); V not a multiple of 16 takes its byte-by-byte loads, V above
# 1024 its chunks
CLIQUE_CASES = ((1, 33, 0.3), (7, 1000, 0.1), (4, 6144, 0.02),
                (3, 16400, 0.01))


def _clique_checks(card):
    """The clique-weight kernel against ascending float32 sums bit for bit
    on CLIQUE_CASES (random masks and weights); each case's device-only µs
    beside the library call's."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import mwcp_kernel as mk
    rng = np.random.RandomState(11)
    for r, v, dens in CLIQUE_CASES:
        w = (rng.randn(v) * 50).astype(np.float32)
        masks = rng.rand(r, v) < dens
        want = np.asarray([_ascending_sum(w, m) for m in masks], np.float32)
        mt, wt = torch.from_numpy(masks).cuda(), torch.from_numpy(w).cuda()
        got = mk.clique_weights(mt, wt)
        same = np.array_equal(got.cpu().numpy(), want)
        out = torch.empty(r, device="cuda")
        us = device_us(lambda: mk._launch_clique(mt, wt, out))
        lib_us = device_us(lambda: torch.sum(torch.where(mt, wt, 0.0), -1))
        log(f"mwcp: clique weights [{r}, {v}] ({int(masks.sum())} members): "
            f"kernel {'==' if same else 'DIFFERS from'} ascending float32 "
            f"sums; device-only {us:.3f} us, library call {lib_us:.3f} us "
            f"({card})")
        if not same:
            fail(f"mwcp: clique weights [{r}, {v}]: the kernel differs from "
                 f"an ascending float32 sum")


# the field draw's odd shape (r, v, iters_pad): nothing a multiple of 4
DRAW_ODD = (5, 1000, 7)
# the opcodes of the draw loops that issue to the integer ALU pipe (IMAD
# issues to the FMA pipe)
ALU_OPCODES = ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "VIADD", "I2FP")


def threefry_sass_counts():
    """The draw kernel's instructions a number, counted in the SASS of the
    built library (`cuobjdump -sass`): its five draw loops (each a
    backward branch; in the fields' order g_dir, g_rnd, noise, u_dir,
    u_ten), each body on its 16-byte-store path (the element-by-element
    stores after the vector store's branch left out) over the 4 numbers
    it draws, the mean of the two loops of a kind.  Returns {"gumbel",
    "gumbel_alu", "uniform", "uniform_alu", "loops": [instructions a loop
    body], "loops_alu": [those of the integer ALU pipe]}."""
    import re
    import subprocess
    from mcmtt_opticalflow_tpu_torch.ops import threefry_kernel as tk
    from mcmtt_opticalflow_tpu_torch.ops.nvcc_build import nvcc
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", tk.build()._name],
                          capture_output=True, text=True, check=True).stdout
    ins = [(int(a, 16), t.split()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]

    def opcode(words):
        return words[1 if words[0].startswith("@") else 0].split(".")[0]

    def target(words):
        return int(words[-1], 16) if opcode(words) == "BRA" else None
    loops = [(target(w), a) for a, w in ins
             if target(w) is not None and target(w) < a]
    if len(loops) != 5:
        fail(f"threefry: {len(loops)} loops in the draw kernel's SASS, "
             f"expected 5 (one a field)")
    bodies = []
    for lo, hi in loops:
        body = [(a, w) for a, w in ins if lo <= a <= hi]
        vec = next(i for i, (_, w) in enumerate(body)
                   if any(x.startswith("STG.E.128") for x in w))
        skip = next(((a + 16, target(w)) for a, w in body[vec:]
                     if target(w) is not None and target(w) > a), (0, 0))
        bodies.append([w for a, w in body if not skip[0] <= a < skip[1]])
    n = [len(b) for b in bodies]
    alu = [sum(opcode(w) in ALU_OPCODES for w in b) for b in bodies]
    # the two loops of a kind differ by a few instructions of scheduling:
    # their mean, a number being one of the 4 a body draws
    return {"gumbel": (n[0] + n[1]) / 8, "gumbel_alu": (alu[0] + alu[1]) / 8,
            "uniform": (n[3] + n[4]) / 8,
            "uniform_alu": (alu[3] + alu[4]) / 8, "loops": n,
            "loops_alu": alu}


def _threefry_bound_inputs(card):
    """The draw's bound constants (threefry_kernel.py) against the built
    kernel's SASS (threefry_sass_counts), the card's SM count and its
    maximum SM clock (nvidia-smi); fails when one differs."""
    import subprocess
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import threefry_kernel as tk
    counts = threefry_sass_counts()
    module = {"gumbel": tk.GUMBEL_INSTRUCTIONS,
              "gumbel_alu": tk.GUMBEL_ALU_INSTRUCTIONS,
              "uniform": tk.UNIFORM_INSTRUCTIONS,
              "uniform_alu": tk.UNIFORM_ALU_INSTRUCTIONS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    log(f"threefry: SASS (cuobjdump -sass) instructions a number: "
        f"{json.dumps(counts)} (threefry_kernel.py: {json.dumps(module)}); "
        f"{sms} SMs (module {tk.SMS}), max SM clock {mhz:g} MHz (module "
        f"{tk.SM_CLOCK_HZ / 1e6:g}) ({card})")
    if any(counts[k] != v for k, v in module.items()) or sms != tk.SMS or \
            mhz * 1e6 != tk.SM_CLOCK_HZ:
        fail("threefry: the draw's bound constants in threefry_kernel.py "
             "differ from the built kernel's SASS or the card")


def _draw_times(r, v, ip, card, label):
    """The field draw at [r, v, ip] from a fixed subkey: the kernel's
    device-only µs (a prepared launch into fixed buffers, timed as phase
    3b), the wrapper's host µs per call, the plain version's ms (CUDA
    events, median of 5) and the bound (threefry_kernel.field_work)."""
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import threefry_kernel as tk
    from mcmtt_opticalflow_tpu_torch.utils import prng
    key = prng.split(prng.prng_key(r * v + ip))[1].cuda()
    out = tuple(torch.empty(x, device="cuda")
                for x in tk.field_shapes(r, v, ip))
    dev = device_us(lambda: tk._launch(key, r, v, ip, out), reps=20)
    host = host_us(lambda: tk.threefry_fields(key, r, v, ip, out), reps=20)
    plain = time_ms(lambda: tk.threefry_fields_reference(key, r, v, ip),
                    reps=5)
    work = tk.field_work(r, v, ip)
    bound = 1e6 * work["bound_s"]
    log(f"threefry: {label} draw [{r}, {v}, {ip}] ({work['numbers']} "
        f"numbers, {work['bytes']} B, {work['instructions']:.0f} "
        f"instructions, {work['alu_instructions']:.0f} of them integer "
        f"ALU): device-only {dev:.3f} us, plain version {plain:.3f} ms "
        f"({1e3 * plain / dev:.0f}x), wrapper host {host:.3f} us/call; "
        f"bound {bound:.3f} us ({work['bound_by']}: issue "
        f"{1e6 * work['issue_s']:.3f} us, integer ALU "
        f"{1e6 * work['alu_s']:.3f} us, bytes {1e6 * work['bytes_s']:.3f} "
        f"us), share of the bound {bound / dev:.4f} ({card})")
    return {"device_us": dev, "host_us": host, "plain_ms": plain,
            "bound_us": bound, "bound_by": work["bound_by"],
            "numbers": work["numbers"]}


def _threefry_check(solves, name, shapes):
    """The field draw from the subkey of every recorded solve against its
    plain version and the fields the captured program drew, bit for bit
    on every element of the five fields, or fail; counts the solves by
    shape [r, v, iters_pad] into `shapes`.  Returns the largest
    |kernel - plain version|."""
    from mcmtt_opticalflow_tpu_torch.ops import threefry_kernel as tk
    err = 0.0
    for n, s in enumerate(solves):
        ip, r, v = s["fields"].g_dir.shape
        got = tk.threefry_fields(s["key"], r, v, ip)
        plain = tk.threefry_fields_reference(s["key"], r, v, ip)
        bad = [f for f, g, p, rec in zip(tk.FIELDS, got, plain, s["fields"])
               if not (_bits_equal(g, p) and _bits_equal(g, rec))]
        if bad:
            fail(f"threefry: {name} solve {n} [{r}, {v}, {ip}]: the "
                 f"kernel's {bad} differ from the plain version's or the "
                 f"program's")
        err = max(err, _max_abs_err(zip(got, plain)))
        shape = str([r, v, ip])
        shapes[shape] = shapes.get(shape, 0) + 1
    return err


def phase_threefry(bench_solves, cli_solves, card):
    """The solver's field draw (ops/threefry_kernel.py) against its plain
    version on the card, bit for bit on every element of all five fields:
    from the subkey of every recorded bench solve ([38, 1024, 150]) and
    CLI solve ([18, 256, 2000]), where both must also equal the fields
    the captured program drew for that solve, and at DRAW_ODD from a
    fixed subkey into buffers one element off 16-byte alignment.  Then
    the bench's and the CLI's draw timed (_draw_times).  Returns the
    kernels-line summary."""
    import math
    import torch
    from mcmtt_opticalflow_tpu_torch.ops import threefry_kernel as tk
    from mcmtt_opticalflow_tpu_torch.utils import prng
    shapes = {}
    err = max(_threefry_check(solves, name, shapes)
              for name, solves in (("bench", bench_solves),
                                   ("cli", cli_solves)))
    r, v, ip = DRAW_ODD
    key = prng.split(prng.prng_key(13))[1].cuda()
    bufs = [torch.full((math.prod(x) + 1,), 7.0, device="cuda")
            for x in tk.field_shapes(r, v, ip)]
    out = [b[1:].view(x) for b, x in zip(bufs, tk.field_shapes(r, v, ip))]
    tk.threefry_fields(key, r, v, ip, out)
    plain = tk.threefry_fields_reference(key, r, v, ip)
    if not all(_bits_equal(g, p) for g, p in zip(out, plain)):
        fail(f"threefry: the kernel differs from the plain version at "
             f"{list(DRAW_ODD)} (unaligned buffers)")
    err = max(err, _max_abs_err(zip(out, plain)))
    log(f"threefry: kernel == plain version bit for bit on every element "
        f"of the five fields, and == the captured program's fields, for "
        f"the recorded solves' subkeys (shape: solves) {shapes}; and at "
        f"{list(DRAW_ODD)} into unaligned buffers ({card})")
    _threefry_bound_inputs(card)
    bench = _draw_times(38, 1024, 150, card, "bench")
    cli = _draw_times(18, 256, 2000, card, "cli")
    return {"ms": bench["device_us"] / 1e3, "plain_ms": bench["plain_ms"],
            "bound_ms": bench["bound_us"] / 1e3,
            "bound_by": bench["bound_by"], "max_abs_err": err,
            "device_us_per_launch": bench["device_us"],
            "host_us_per_call": bench["host_us"],
            "bound_us": bench["bound_us"], "numbers": bench["numbers"],
            "device_us_per_launch_cli": cli["device_us"],
            "plain_ms_cli": cli["plain_ms"], "bound_us_cli": cli["bound_us"],
            "numbers_cli": cli["numbers"]}


def phase_mwcp(bench_solves, cli_solves, card, graph_stages):
    """The solver's kernels (ops/mwcp_kernel.py) on the card against their
    plain versions, on the recorded solves of the bench main path (phase
    3d) and of the CLI (phase 10): the greedy kernel bit-equal on every
    replica; the BLS kernel from the same start and fields, its K-best
    masks and scores equal, or where not, the first iteration whose
    decisions part and the comparisons that flipped with their operands,
    which must lie within 1e-5 relative (the summation order); every
    K-best entry a clique of valid vertices scoring its weight sum, the
    top score >= 0.99 x the plain version's, no clique twice; the start
    scores of the clique-weight kernel equal to ascending float32 sums.
    Then synthetic solves past the shared-memory layouts (LARGE_SOLVES)
    bit-equal to the plain version, the greedy start's _greedy_checks,
    and the bench and CLI solves timed; the BLS kernel's µs an iteration beside
    phase 3c's (`graph_stages`).  Returns the kernels-line summaries by
    kernel name."""
    from mcmtt_opticalflow_tpu_torch.models.associator3d import FrameProgram
    if not bench_solves or not cli_solves:
        fail(f"mwcp: {len(bench_solves)} bench and {len(cli_solves)} CLI "
             f"solves recorded")
    err_b, cerr_b, gerr_b = _mwcp_check(bench_solves, "bench")
    err_c, cerr_c, gerr_c = _mwcp_check(cli_solves, "cli")
    for v, n in LARGE_SOLVES:
        _large_solve_check(v, n, card)
    _greedy_checks(card)
    _clique_checks(card)
    out = _mwcp_times(bench_solves, card)
    cli_out = _mwcp_times(cli_solves, card, "cli", plain_too=False)
    cli = cli_out["bls_steps"]
    greedy, greedy_cli = out["greedy_start"], cli_out["greedy_start"]
    greedy["max_abs_err"] = max(gerr_b, gerr_c)
    for k in ("device_us_per_launch", "device_us_per_round"):
        greedy[f"{k}_cli"] = greedy_cli[k]
    bls = out["bls_steps"]
    bls["max_abs_err"] = max(err_b, err_c)
    bls["device_us_per_iteration_cli"] = cli["device_us_per_iteration"]
    for k in ("graph_block_us_per_iteration",
              "kernel_block_us_per_iteration"):
        bls[f"{k}_cli"] = cli[k]
    bls["layout_cli"] = cli["layout"]
    out["clique_weights"]["max_abs_err"] = max(cerr_b, cerr_c)
    for k in ("device_us_per_launch", "library_ms"):
        out["clique_weights"][f"{k}_cli"] = cli_out["clique_weights"][k]
    blk = [k for k in graph_stages if k.startswith("BLS per iteration")][0]
    alone = [k for k in graph_stages if k.startswith("BLS kernel alone")][0]
    g3c, a3c = 1e3 * graph_stages[blk], 1e3 * graph_stages[alone]
    per_it = bls["device_us_per_iteration"]
    g_rec = bls["graph_block_us_per_iteration"]
    a_rec = bls["kernel_block_us_per_iteration"]
    log(f"mwcp: bls_steps device-only us an iteration ({card}): the "
        f"{len(bench_solves)} recorded bench solves, 150 iterations in one "
        f"launch {per_it:.4f}; a {FrameProgram.BLOCK}-iteration block on "
        f"every {PLAIN_EVERY}th, as a graph {g_rec:.4f} and its kernel "
        f"alone {a_rec:.4f} (the packing and graph {g_rec - a_rec:+.4f}); "
        f"phase 3c's one frame, as a graph {g3c:.4f} and its kernel alone "
        f"{a3c:.4f} (the packing and graph {g3c - a3c:+.4f}; that frame's "
        f"kernel against the recorded solves' {a3c - a_rec:+.4f}); CLI "
        f"{bls['device_us_per_iteration_cli']:.4f}, as a block "
        f"{bls['graph_block_us_per_iteration_cli']:.4f}, its kernel alone "
        f"{bls['kernel_block_us_per_iteration_cli']:.4f}")
    return out


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
    frame with 48 boxes must equal host_rgb_histogram exactly.  A
    solve_mwcp_batch instance whose masks differ is held to phase 11's
    rule instead: the card's BLS kernel and the CPU's plain version, in
    lockstep, part at a comparison the sums' order flipped (operands
    within 1e-5 relative), and its K-best entries are cliques."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.geometry import (
        back_projection_line, camera_position, nview_ground_reconstruction,
        nview_point_reconstruction, stack_cameras, world_to_image)
    from mcmtt_opticalflow_tpu_torch.models.costs import (
        enter_probability, exit_cost, tracklet_connectivity)
    from mcmtt_opticalflow_tpu_torch.models.mwcp import (
        MwcpFields, bls_start, collect_k_best, device_k_best,
        solve_mwcp_batch, threefry_fields)
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
    # the card's BLS kernel sums in another order than the CPU's plain
    # version (ops/csrc/mwcp_bls.cu): an instance whose masks differ is
    # held to the mwcp phase's rule, the replicas parting at a comparison
    # that the order flipped, its operands within 1e-5 relative
    same = [i for i in range(b) if all(
        torch.equal(getattr(res["cuda"], f)[i].cpu(),
                    getattr(res["cpu"], f)[i])
        for f in ("best_mask", "sol_masks"))]
    for i in sorted(set(range(b)) - set(same)):
        st, fs = {}, {}
        for dev in ("cuda", "cpu"):
            t = [torch.tensor(x[i], device=dev) for x in (weights, adj,
                                                           valid, init)]
            fs[dev] = CpuDrawn(prng.prng_key(40 + i)).draw(
                scfg.num_replicas, v, 90, dev)
            st[dev] = bls_start(*t, fs[dev], scfg, v)
        part = _first_parting(st["cuda"], st["cpu"], fs["cuda"], fs["cpu"],
                              scfg, 90)
        if part is None:
            fail(f"api solve_mwcp_batch instance {i}: card and CPU masks "
                 f"differ with no decision parted")
        explain_parting(f"api solve_mwcp_batch instance {i} (card kernel, "
                        f"CPU plain)", part)
        one = [device_k_best(type(r)(*[x[i] for x in r]), 10)
               for r in (res["cuda"], res["cpu"])]
        _check_k_best(one[0], one[1], torch.tensor(weights[i]),
                      torch.tensor(adj[i]), torch.tensor(valid[i]),
                      f"api solve_mwcp_batch instance {i}")
    log(f"api: solve_mwcp_batch: {len(same)} of {b} instances equal on the "
        f"card and the CPU, the rest parted within the sums' rounding")
    for f in res["cuda"]._fields:
        exact = f in ("best_mask", "sol_masks")
        worst[f"solve_mwcp_batch.{f}"] = _hold(
            f"solve_mwcp_batch.{f}", getattr(res["cuda"], f)[same],
            getattr(res["cpu"], f)[same], atol=1e-4, exact=exact)
    for i in same:
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


def _steady_frame_s(eng, sc, frames):
    """Median process_frame wall s of a pipelined engine over MEASURED
    frames after WARMUP frames and precompile(), as the bench measures,
    and the median ms of each stage over those frames."""
    import numpy as np
    import torch
    for t in range(WARMUP):
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
    eng.precompile()
    torch.cuda.synchronize()
    timer = eng.assoc.timer
    timer.reset()
    walls = []
    for t in range(WARMUP, WARMUP + MEASURED):
        t0 = time.perf_counter()
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
        walls.append(time.perf_counter() - t0)
    stages = {n: 1e3 * float(np.median(timer.samples[n]))
              for n in timer.totals}
    while eng.flush() is not None:
        pass
    torch.cuda.synchronize()
    return float(np.median(walls)), stages


def phase_mesh(cfg, sc, frames, card, cards=1):
    """The bench configuration for MESH_FRAMES frames without a mesh and
    on make_mesh(devices=[cuda:0] * 4) (cam 4 x block 1: four camera
    groups of one camera, each a 2D program, one after another on the
    card; the fused 3D program's rows split in 4 chunks, a row part
    each): equal ids, points within 1 mm.  Along the way, after every
    frame each group's replayed state buffers and pack equal an eager
    tracker2d_step on the card on the same inputs, bit for bit; every
    mesh 3D program call's outputs equal the eager body on the same
    uploads (Associator3D._rescore_and_solve), bit for bit; every
    dispatch of a captured program runs under
    set_sync_debug_mode("error"); each group replays once a frame, each
    row part once a solve, no eager 2D step or 3D body runs but the
    captures', and the wrappers count only the captures' calls.  Then,
    no counter running: the dispatch host ms of the mesh 3D replay set
    against the eager mesh body's and the one-card program's, and of the
    four 2D replays against four eager steps, on the same inputs; the
    median per-frame wall time of the pipelined engine over MEASURED
    frames after WARMUP frames and precompile(), with the mesh and
    without, in turns.  Then the sharded solve (phase_sharded) on
    [cuda:0] * 2.  With cards=4 the mesh's four entries are four distinct
    cards (cuda:0-3): the same checks and times, the cross-device copies
    and one graph pool a card included, and the sharded solve over
    cuda:0 and cuda:1.  Returns the mesh run's results
    and 3D replays (the multiprocess phase's references)."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.models import pipeline
    from mcmtt_opticalflow_tpu_torch.models.associator3d import FrameProgram
    from mcmtt_opticalflow_tpu_torch.models.tracker2d import tracker2d_step
    from mcmtt_opticalflow_tpu_torch.ops import hungarian, lk_kernel
    from mcmtt_opticalflow_tpu_torch.parallel import make_mesh
    from mcmtt_opticalflow_tpu_torch.parallel.multihost_sim import run_solve
    from mcmtt_opticalflow_tpu_torch.utils.tree import tree_leaves, tree_map

    tag = "mesh" if cards == 1 else f"mesh over {cards} cards"
    card0 = torch.device("cuda", 0)
    plain = pipeline.TrackingEngine(cfg, sc.cameras, pipelined=True,
                                    device="cuda")
    t0 = time.perf_counter()
    ra = _run_engine(plain, sc, frames, MESH_FRAMES)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    mesh = make_mesh(devices=[card0] * 4 if cards == 1 else
                     [torch.device("cuda", i) for i in range(cards)])
    eng = pipeline.TrackingEngine(cfg, sc.cameras, pipelined=True, mesh=mesh)
    progs2d = eng._progs2d
    if mesh.shape != {"cam": 4, "block": 1} or len(progs2d) != 4:
        fail(f"{tag}: expected 4 camera groups, got {mesh.shape}")
    group_cams = eng._split(eng.cams)
    refs = [tree_map(torch.clone, p.state) for p in progs2d]

    # the captured programs' dispatches under the sync debug mode; the 3D
    # calls recorded (bucket, host arrays, subkey, outputs)
    calls, steady = [], {"on": False}
    cls2d = pipeline.Tracker2DProgram
    orig = (cls2d.__call__, cls2d.put_gray, FrameProgram.__call__)

    def strict(fn, captured):
        def wrapped(p, *a):
            if captured(p):
                torch.cuda.set_sync_debug_mode("error")
                steady["on"] = True
            try:
                return fn(p, *a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return wrapped

    def record(prog, host, key, field_source=None):
        out = strict(orig[2], lambda p: True)(prog, host, key, field_source)
        calls.append((prog.bucket, [np.array(x) for x in host],
                      key.clone(), tuple(o.clone() for o in out)))
        return out
    lk_kernel.lk_level.launches = hungarian.jv_assign.launches = 0
    reset_solver_launches()
    steps2d, restore = _count_calls(pipeline, "tracker2d_step")
    cls2d.__call__ = strict(orig[0], lambda p: p.graph.graph is not None)
    cls2d.put_gray = strict(orig[1], lambda p: p.graph.graph is not None)
    FrameProgram.__call__ = record
    rb, ref_launches = [], [0, 0]       # the eager references' launches
    t0 = time.perf_counter()
    try:
        with EagerCount() as eager:
            for t in range(MESH_FRAMES):
                r = eng.process_frame(frames[t], sc.detections[t],
                                      frame_idx=t)
                rb += [] if r is None else [r]
                for g, p in enumerate(progs2d):
                    before = (lk_kernel.lk_level.launches,
                              hungarian.jv_assign.launches)
                    refs[g], out = tracker2d_step(
                        refs[g], p.gray_u8.float() * (1.0 / 255.0), p.boxes,
                        p.mask, group_cams[g], t, cfg.tracker2d)
                    ref_launches[0] += lk_kernel.lk_level.launches - before[0]
                    ref_launches[1] += hungarian.jv_assign.launches - \
                        before[1]
                    want = [pipeline._pack2d(out)] + tree_leaves(refs[g])
                    got = [p.graph.out] + tree_leaves(p.state)
                    if not all(map(_bits_equal, got, want)):
                        fail(f"{tag}: frame {t}: camera group {g}'s replayed "
                             f"pack or state differs from the eager step's")
            while (r := eng.flush()) is not None:
                rb.append(r)
        torch.cuda.synchronize()
    finally:
        cls2d.__call__, cls2d.put_gray, FrameProgram.__call__ = orig
        torch.cuda.set_sync_debug_mode(0)
        restore()
    wall = time.perf_counter() - t0
    launches = (lk_kernel.lk_level.launches - ref_launches[0],
                hungarian.jv_assign.launches - ref_launches[1])
    s_launches = solver_launches()
    assoc = eng.assoc
    progs = list(assoc._programs.values())
    replays2d = [p.graph.n_replays for p in progs2d]
    heads = sum(p.head.n_replays for p in progs)
    rows = sum(r.n_replays for p in progs for r in p.rows)
    _, want_s_wrapper = solver_runs_expected([assoc])
    if len(ra) != len(rb) or not ra:
        fail(f"{tag}: {len(ra)} results without the mesh, {len(rb)} with it")
    d_pts, n_obj = 0.0, 0
    for a, b in zip(ra, rb):
        if a.frame_idx != b.frame_idx or a.ids != b.ids:
            fail(f"{tag}: ids differ at frame {a.frame_idx}: {a.ids} vs "
                 f"{b.ids}")
        if len(a.ids):
            d_pts = max(d_pts, float(np.abs(np.asarray(a.points)
                                            - np.asarray(b.points)).max()))
        n_obj += len(a.ids)
    log(f"{tag}: {mesh} engine == engine without a mesh over {MESH_FRAMES} "
        f"frames ({n_obj} tracked objects, max |d point| {d_pts:.3e} mm); "
        f"every group's replayed 2D state and pack == the eager step's bit "
        f"for bit every frame; dispatches under set_sync_debug_mode"
        f"('error'): {steady['on']}; 2D replays per group {replays2d} "
        f"(expected {MESH_FRAMES} each), eager tracker2d_step calls "
        f"{steps2d['n']} (expected 8: each capture's two); 3D head replays "
        f"{heads}, row-part replays {rows} (expected 4 a solve), eager-body "
        f"calls {eager.calls}; wrapper launches lk_level={launches[0]} "
        f"jv_assign={launches[1]} (expected 64 and 8: the captures' calls), "
        f"solver {s_launches} (expected {want_s_wrapper}); {wall:.2f} s "
        f"against {wall_plain:.2f} s without the mesh, captures included")
    if d_pts > 1.0:
        fail(f"{tag}: points differ by {d_pts} mm (limit 1.0)")
    if replays2d != [MESH_FRAMES] * 4 or steps2d["n"] != 8 or \
            launches != (64, 8) or not steady["on"]:
        fail(f"{tag}: 2D replays {replays2d}, eager steps {steps2d['n']}, "
             f"wrapper launches {launches}, expected {[MESH_FRAMES] * 4}, "
             f"8 and (64, 8)")
    if eager.calls or heads != len(calls) or not calls or rows != 4 * heads \
            or s_launches != want_s_wrapper:
        fail(f"{tag}: {eager.calls} eager-body calls, {heads} head and "
             f"{rows} row-part replays for {len(calls)} 3D program calls; "
             f"solver wrappers {s_launches}, expected {want_s_wrapper}")

    # the 3D replays against the eager body on the same uploads
    buckets = sorted({c[0] for c in calls})
    for n, (bucket, host, key, out) in enumerate(calls):
        want = _eager_body(assoc, host, key, bucket[2])
        for name, g, w in zip(("pack_a", "pack_b"), out, want):
            if not _bits_equal(g, w):
                fail(f"{tag}: the replayed {name} of solve {n} (bucket "
                     f"{bucket}) differs from the eager mesh body's")
    log(f"{tag}: {len(calls)} mesh 3D program calls, buckets (nr, nb, iters) "
        f"{buckets}, replayed pack_a and pack_b == the eager mesh body's on "
        f"the same uploads bit for bit; capture s per bucket "
        f"{[round(p.capture_s, 3) for p in progs]}; graph pool "
        f"{pool_mib(assoc._graph_pool(card0)):.1f} MiB")

    # dispatch host ms on the same inputs, no counter running
    for bucket in buckets:                  # captured here, not timed
        plain.assoc._program(*bucket)
    rows_ms = {"mesh replay": [], "mesh eager": [], "one-card replay": []}
    for bucket, host, key, _ in calls:
        rows_ms["mesh replay"].append(_timed_ms(
            lambda: assoc._program(*bucket)(host, key)))
        rows_ms["mesh eager"].append(_timed_ms(
            lambda: _eager_body(assoc, host, key, bucket[2])))
        rows_ms["one-card replay"].append(_timed_ms(
            lambda: plain.assoc._program(*bucket)(host, key)))
    med3 = {k: [round(float(np.median([x[i] for x in v])), 3)
                for i in (0, 1)] for k, v in rows_ms.items()}
    gray = [p.gray_u8.cpu().numpy() for p in progs2d]
    boxes = [p.boxes.cpu().numpy() for p in progs2d]
    mask = [p.mask.cpu().numpy() for p in progs2d]
    whole = [np.concatenate(x) for x in (gray, boxes, mask)]
    t2 = MESH_FRAMES

    def replays():
        for p, *x in zip(progs2d, gray, boxes, mask):
            p.put_gray(x[0])
            p(x[1], x[2], t2)

    def eager_steps():
        for g, p in enumerate(progs2d):
            tracker2d_step(refs[g], p.gray_u8.float() * (1.0 / 255.0),
                           p.boxes, p.mask, group_cams[g], t2,
                           cfg.tracker2d)

    def one_card():
        plain._progs2d[0].put_gray(whole[0])
        plain._progs2d[0](whole[1], whole[2], t2)
    med2 = {}
    for name, fn in (("2D replays", replays), ("eager steps", eager_steps),
                     ("one-card replay", one_card)):
        med2[name] = [round(float(np.median([x[i] for x in [
            _timed_ms(fn) for _ in range(5)]])), 3) for i in (0, 1)]
    log(f"{tag}: dispatch, median [host ms to return, wall ms to the card's "
        f"completion] on the same inputs: 3D over the {len(calls)} recorded "
        f"calls {json.dumps(med3)}; 2D over the four groups (5 times) "
        f"{json.dumps(med2)} ({card})")

    # the steady state, in turns
    walls, stages = {"no mesh": [], "mesh": []}, {"no mesh": [], "mesh": []}
    for name in ("no mesh", "mesh", "mesh", "no mesh"):
        e = pipeline.TrackingEngine(
            cfg, sc.cameras, pipelined=True,
            **({"mesh": mesh} if name == "mesh" else {"device": "cuda"}))
        wall_s, stage_ms = _steady_frame_s(e, sc, frames)
        walls[name].append(wall_s)
        stages[name].append(stage_ms)
    fps = {k: [round(1.0 / s, 3) for s in v] for k, v in walls.items()}
    med = {k: {n: float(np.median([st.get(n, 0.0) for st in v]))
               for n in set().union(*v)} for k, v in stages.items()}
    apart = sorted(med["mesh"], key=lambda n: -abs(
        med["mesh"][n] - med["no mesh"].get(n, 0.0)))[:8]
    far = {n: [round(med["mesh"][n], 3), round(med["no mesh"].get(n, 0.0), 3)]
           for n in apart}
    log(f"{tag}: steady state, pipelined, {MEASURED} frames after "
        f"{WARMUP} of warm-up and precompile(), in turns (no mesh, mesh, "
        f"mesh, no mesh): median per-frame wall s {json.dumps(walls)}, "
        f"frames/s {json.dumps(fps)} ({card}); the stage medians ms "
        f"furthest apart, [mesh, no mesh] (medians of the two runs each) "
        f"{json.dumps(far)}")

    phase_sharded(tag, [card0] * 2 if cards == 1 else
                  [torch.device("cuda", i) for i in range(2)], card)
    return rb, wall, heads


def sharded_instance(devices):
    """The sharded solve's bench instance (multihost_sim's: V=1024, 700
    valid, R=38, 150 iterations) on a 1 x len(devices) mesh: (mesh, the
    four inputs on its home device, config, iterations, key)."""
    import torch
    from mcmtt_opticalflow_tpu_torch.parallel import make_mesh
    from mcmtt_opticalflow_tpu_torch.parallel.multihost_sim import \
        _solve_instance
    from mcmtt_opticalflow_tpu_torch.utils import prng
    mesh = make_mesh(num_cam_shards=1, devices=devices)
    *ins, scfg, iters = _solve_instance(True)
    return (mesh, [torch.tensor(x, device=mesh.home) for x in ins], scfg,
            iters, prng.prng_key(3))


def sharded_programs(mesh, ins, scfg, iters):
    """The block programs (parallel/solver_parallel.py) of that instance
    on the mesh's blocks."""
    from mcmtt_opticalflow_tpu_torch.models.mwcp import iters_padded
    from mcmtt_opticalflow_tpu_torch.parallel import (block_sharding,
                                                      solver_parallel)
    devices = block_sharding(mesh).devices
    shape = (ins[0].shape[0], scfg.num_replicas, tuple(ins[3].shape),
             iters_padded(scfg, iters), scfg)
    return [solver_parallel.programs[(b, str(d), *shape)]
            for b, d in enumerate(devices)]


def phase_sharded(tag, devices, card):
    """solve_mwcp_sharded at V=1024 (700 valid), R=38, 150 iterations
    over 2 blocks on `devices`: the captured per-block programs
    (parallel/solver_parallel.py::BlockProgram, made at the first call)
    against the per-block solve_mwcp calls plus the global argmax
    (multihost_sim.run_solve) and against the eager per-block form
    (_solve_mwcp_sharded_eager), bit for bit: the best mask and score and
    every replica's mask and score.  Then, no counter running: the
    programs' capture s, the graph pools' MiB, the dispatch [host ms to
    return, wall ms to completion] of a captured and an eager call
    (medians of 5) and the device ms of one replay of every block's
    parts (behind a sleep kernel, as device_us)."""
    import numpy as np
    import torch
    from mcmtt_opticalflow_tpu_torch.parallel import solver_parallel
    from mcmtt_opticalflow_tpu_torch.parallel.multihost_sim import run_solve
    from mcmtt_opticalflow_tpu_torch.parallel.solver_parallel import (
        _solve_mwcp_sharded_eager, solve_mwcp_sharded)
    mesh, ins, scfg, iters, key = sharded_instance(devices)
    reset_solver_launches()
    s = run_solve(mesh, bench=True, reps=1)
    launches = solver_launches()
    got = solve_mwcp_sharded(*ins, key, mesh, scfg, iters)
    want = _solve_mwcp_sharded_eager(*ins, key, mesh, scfg, iters)
    same = all(map(_bits_equal, got, want))
    progs = sharded_programs(mesh, ins, scfg, iters)

    def captured():
        solve_mwcp_sharded(*ins, key, mesh, scfg, iters)

    def eager():
        _solve_mwcp_sharded_eager(*ins, key, mesh, scfg, iters)

    def replay():
        for p in progs:
            p.draw()
            p.head()
            for _ in range(p.blocks):
                p.block()
            if p.rest is not None:
                p.rest()
            p.tail()
    ms = {name: [round(float(np.median([x[i] for x in [
        _timed_ms(fn) for _ in range(5)]])), 3) for i in (0, 1)]
        for name, fn in (("captured", captured), ("eager", eager))}
    replay_ms = device_us(replay, reps=5) / 1e3
    log(f"{tag}: solve_mwcp_sharded V=1024 (700 valid) R=38 {iters} "
        f"iterations over {mesh}, as captured block programs (parts "
        f"{[len(p.parts()) for p in progs]}, {progs[0].blocks} "
        f"{solver_parallel.BLOCK}-iteration block replays each): best "
        f"{s['best_score']:.4f}, a clique of {len(s['best_mask'])}: "
        f"{s['clique']}; == the per-block solve_mwcp calls + argmax: "
        f"{s['equals_per_block']}; == the eager per-block form bit for "
        f"bit (best mask and score, every replica's mask and score): "
        f"{same}; capture s {[round(p.capture_s, 3) for p in progs]}; "
        f"graph pools {pool_mib(*solver_parallel.graph_pools()):.1f} MiB; "
        f"dispatch [host ms, wall ms] {json.dumps(ms)}; one replay of "
        f"every block's parts {replay_ms:.4f} device ms; solver wrapper "
        f"launches {launches} (the captures' calls and run_solve's eager "
        f"references) ({card})")
    if not (s["equals_per_block"] and s["clique"] and same):
        fail(f"{tag}: solve_mwcp_sharded differs from its per-block "
             f"solves")
    return {"dispatch_ms": ms, "replay_device_ms": replay_ms,
            "capture_s": [p.capture_s for p in progs]}


def phase_mesh_counted(cfg, sc, frames, mesh_results):
    """The mesh run of phase_mesh once more, on a fresh engine under the
    CUPTI counter (after every timed phase): the card runs 8 LK and 1 JV
    kernels a 2D replay and in each group's capture warm-up, and the
    solver's kernels as the captured 3D programs' parts prescribe
    (solver_runs_expected); the ids equal phase_mesh's.  Then one call of
    the sharded solve's block programs that phase_mesh made, counted the
    same way: per block a draw, a greedy start, a clique weight and 3 BLS
    kernels at 150 iterations (program_runs).  Returns the kernel runs
    (LK, JV, solver, the sharded solve's solver)."""
    import torch
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu_torch.parallel import make_mesh
    from mcmtt_opticalflow_tpu_torch.utils.kernel_events import KernelEvents

    eng = TrackingEngine(cfg, sc.cameras, pipelined=True,
                         mesh=make_mesh(devices=[torch.device("cuda", 0)]
                                        * 4))
    with EagerCount() as eager, KernelEvents() as ev:
        rb = _run_engine(eng, sc, frames, MESH_FRAMES)
    runs, s_runs = kernel_runs(ev), solver_kernel_runs(ev)
    replays2d = [p.graph.n_replays for p in eng._progs2d]
    want = (8 * sum(r + 1 for r in replays2d), 0,
            sum(r + 1 for r in replays2d))
    want_s, _ = solver_runs_expected([eng.assoc])
    log(f"mesh, counted: kernels run on the card (CUPTI) (lk_level, "
        f"lk_level_serial, jv_assign) {runs} (expected {want}: 8 and 1 a "
        f"group's replay, {replays2d}, and its capture's warm-up), solver "
        f"kernels {s_runs} (expected {want_s}: each captured 3D program's "
        f"draw, head and iteration parts, warm-ups and replays); "
        f"{ev.total} kernels in all, {eager.calls} eager-body calls")
    if runs != want or s_runs != want_s or eager.calls:
        fail(f"mesh, counted: the card ran {runs} and {s_runs} kernels, "
             f"expected {want} and {want_s}")
    if [(r.frame_idx, r.ids) for r in rb] != \
            [(r.frame_idx, r.ids) for r in mesh_results]:
        fail("mesh, counted: the ids differ from the mesh phase's run")
    return runs[0], runs[2], s_runs, phase_sharded_counted()


def phase_sharded_counted():
    """One call of the sharded solve's block programs that phase_sharded
    made on [cuda:0] * 2, under the CUPTI counter: the solver's kernels
    the card runs equal those the programs' replays prescribe
    (program_runs), per block a draw, a greedy start, a clique weight and
    one BLS kernel a block of iterations.  Returns the runs (greedy
    start, BLS, clique weight, field draw)."""
    import torch
    from mcmtt_opticalflow_tpu_torch.parallel.solver_parallel import \
        solve_mwcp_sharded
    from mcmtt_opticalflow_tpu_torch.utils.kernel_events import KernelEvents
    mesh, ins, scfg, iters, key = sharded_instance(
        [torch.device("cuda", 0)] * 2)
    progs = sharded_programs(mesh, ins, scfg, iters)
    before, _ = program_runs(progs)
    with KernelEvents() as ev:
        solve_mwcp_sharded(*ins, key, mesh, scfg, iters)
        torch.cuda.synchronize()
    sharded = solver_kernel_runs(ev)
    after, _ = program_runs(progs)
    want = tuple(a - b for a, b in zip(after, before))
    per_block = (1, progs[0].blocks + (progs[0].rest is not None), 1, 1)
    log(f"mesh, counted: solve_mwcp_sharded's captured block programs, "
        f"one call: solver kernels on the card (CUPTI) (greedy start, BLS, "
        f"clique weights, field draw) {sharded} (expected {want} from the "
        f"programs' replays: per block {per_block}, {len(progs)} blocks); "
        f"{ev.total} kernels in all")
    if sharded != want or want != tuple(len(progs) * n for n in per_block):
        fail(f"mesh, counted: the sharded solve ran the solver kernels "
             f"{sharded} times, expected {want}")
    return sharded


def phase_multiprocess(mesh_results, mesh_wall, mesh_heads, card):
    """parallel/multihost_sim.py --bench in two processes on the one card,
    each holding two cuda:0 entries of the global cam 4 x block 1 mesh.
    They join by gloo: NCCL refuses two ranks on one GPU, and gloo
    stages the collectives' data through the host.  Each process replays
    its two camera groups' 2D programs (one replay each a frame) and the
    row parts of its two chunks of the fused 3D program, joins the rows
    by an all-gather, and replays the rest of the 3D program whole: both
    must give phase_mesh's mesh-run ids frame by frame, points within 1
    mm, and as many 3D replays as that run and as each other.  The
    wrappers count only the captures' calls (16 LK and 2 JV a group).
    Each process counts on the card (CUPTI, around its frames) the
    kernels the card runs for it: 8 LK and 1 JV a 2D replay and a
    capture's warm-up, and solver kernels equal to the other process's
    (main holds them against the one-process mesh run's, counted later).
    Their solve over a 1 x 4 mesh (two blocks each) must equal its
    per-block solves plus the argmax, the same in both.  Each process is
    killed at MP_LIMIT_S.  Returns the LK, JV, greedy start, BLS, clique
    weight and field draw kernel runs that the card counted for both
    processes, and those of the solver's kernels in one process."""
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
    launches = [0] * (2 + len(solver_kernels()))
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
        rep, k_runs = eng["replays"], eng["kernel_runs"]
        if k_runs is None:
            fail(f"multiprocess: process {pid} counted no kernels on the "
                 f"card")
        runs = tuple(k_runs[k] for k in ("lk_level", "jv_assign",
                                         *(w for _, w, _ in
                                           solver_kernels())))
        steps = sum(rep["2d"]) + len(rep["2d"])
        log(f"multiprocess: process {pid} ({res['mesh']}): camera groups "
            f"{eng['groups_here']}, blocks {solver['blocks_here']}; ids == "
            f"the mesh run over {MESH_FRAMES} frames, max |d point| "
            f"{d_pts:.3e} mm; graph replays {json.dumps(rep)} (2D: "
            f"{MESH_FRAMES} a group; 3D head: {mesh_heads}, as the "
            f"one-process mesh run; rows: 2 a solve); kernels run on the "
            f"card for it (CUPTI) (LK, JV, greedy_start, bls_steps, "
            f"clique_weights, threefry_fields) {runs} (LK and JV expected "
            f"{8 * steps} and {steps}: 8 and 1 a 2D replay and a capture's "
            f"warm-up; serial LK {k_runs['lk_level_serial']}, expected 0); "
            f"wrapper launches lk_level="
            f"{eng['lk_launches']} jv_assign={eng['jv_launches']} (expected "
            f"32 and 4: the captures' calls), solver "
            f"{tuple(eng['solver_launches'])}; engine {eng['wall_s']:.2f} s "
            f"under the CUPTI counter against {mesh_wall:.2f} s for the "
            f"one-process mesh run without it; "
            f"median {1e3 * coll:.3f} ms a frame in {n_coll:g} "
            f"collectives; solve best "
            f"{solver['best_score']:.4f}, equals its per-block solves: "
            f"{solver['equals_per_block']} (captured: "
            f"{solver['block_programs']} block programs), "
            f"{solver['mesh_s']:.3f} s sharded against "
            f"{solver['one_s']:.3f} s for one block")
        if d_pts > 1.0:
            fail(f"multiprocess: points differ by {d_pts} mm (limit 1.0)")
        if rep["2d"] != [MESH_FRAMES] * 2 or rep["head"] != mesh_heads or \
                rep["rows"] != 2 * rep["head"] or rep != \
                outs[0][3]["engine"]["replays"]:
            fail(f"multiprocess: process {pid} replayed {rep}, expected "
                 f"{MESH_FRAMES} a 2D program, {mesh_heads} 3D heads and "
                 f"two row parts a head, as process 0")
        if runs[:2] != (8 * steps, steps) or k_runs["lk_level_serial"]:
            fail(f"multiprocess: the card ran the LK, serial LK and JV "
                 f"kernels {runs[0]}, {k_runs['lk_level_serial']} and "
                 f"{runs[1]} times for process {pid}, expected "
                 f"{8 * steps}, 0 and {steps}")
        if runs[2:] != tuple(outs[0][3]["engine"]["kernel_runs"][w]
                             for _, w, _ in solver_kernels()):
            fail(f"multiprocess: the card ran the solver kernels "
                 f"{runs[2:]} times for process {pid}, not as for process "
                 f"0")
        if (eng["lk_launches"], eng["jv_launches"]) != (32, 4):
            fail(f"multiprocess: process {pid}'s wrappers launched the LK "
                 f"kernel {eng['lk_launches']} and the JV kernel "
                 f"{eng['jv_launches']} times, expected 32 and 4")
        if solver["block_programs"] != len(solver["blocks_here"]):
            fail(f"multiprocess: process {pid} made "
                 f"{solver['block_programs']} block programs for its "
                 f"blocks {solver['blocks_here']}")
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
        wrappers = tuple(eng["solver_launches"])
        if wrappers != tuple(outs[0][3]["engine"]["solver_launches"]) or \
                not all(wrappers):
            fail(f"multiprocess: process {pid}'s solver wrappers launched "
                 f"{wrappers} times (expected > 0, as process 0)")
        for k, n in enumerate(runs):
            launches[k] += n
    report.pop("frames")
    log(f"multiprocess: scaling_report {json.dumps(report)} on {card}; both "
        f"processes in {wall:.1f} s")
    return launches, runs[2:]


def expected_2d(engines):
    """The kernel runs on the card that the engines' 2D programs made, and
    their wrappers' launches, as (LK, serial LK, JV): a capture passes
    the step through the wrappers twice (the warm-up, which runs, and
    the recording, which does not; levels x backtrack_interval LK calls
    and one JV a step) and each replay runs the step's kernels once.
    Phase 3, the CLI counted and 13 counted hold the runs against
    CUPTI."""
    runs, wrapper = [0, 0, 0], [0, 0, 0]
    for eng in engines:
        t2 = eng.cfg.tracker2d
        lk_step = t2.lk_pyramid_levels * t2.backtrack_interval
        graph = eng._progs2d[0].graph
        captured = graph.graph is not None
        steps = graph.n_replays + captured
        runs[0] += lk_step * steps
        runs[2] += steps
        wrapper[0] += 2 * lk_step * captured
        wrapper[2] += 2 * captured
    return tuple(runs), tuple(wrapper)


def _derived_runs(eng, label):
    """The kernel runs on the card that `eng`'s graphs made since the
    wrappers were counted from 0 before it was built, derived from the
    wrappers' counts and the replays (expected_2d; the solver's kernels
    as solver_runs_expected); fails unless the wrappers saw exactly the
    captures' calls.  Returns ((LK, serial LK, JV), solver runs)."""
    from mcmtt_opticalflow_tpu_torch.ops import hungarian, lk_kernel
    runs, want = expected_2d([eng])
    wrapper = (lk_kernel.lk_level.launches,
               lk_kernel.lk_level.serial_launches,
               hungarian.jv_assign.launches)
    s_runs, s_wrapper = solver_runs_expected([eng.assoc])
    if wrapper != want or solver_launches() != s_wrapper:
        fail(f"{label}: the wrappers launched {wrapper} (LK, serial, JV) "
             f"and {solver_launches()} solver kernels, expected {want} and "
             f"{s_wrapper}: the captures' calls")
    return runs, s_runs


def reset_launches():
    from mcmtt_opticalflow_tpu_torch.ops import hungarian, lk_kernel
    lk_kernel.lk_level.launches = lk_kernel.lk_level.serial_launches = 0
    hungarian.jv_assign.launches = 0
    reset_solver_launches()


def _finite_results(run, label):
    import numpy as np
    for t, (ids, pts) in enumerate(run.results):
        if len(ids) != len(pts) or not np.isfinite(pts).all():
            fail(f"{label}: malformed result at frame {t}")


def _first_ids_parting(run, ref_ids):
    """The first frame whose 3D ids after the run differ from the CPU
    record's (quality_reference.json), or None."""
    return next((t for t, (ids, _) in enumerate(run.results)
                 if sorted(ids) != sorted(ref_ids[t])), None)


QUALITY_KEYS = ("mota", "recall", "precision", "most_tracked", "most_lost",
                "id_switches")


def _quality_lines(label, run, ref, card):
    """The card's CLEAR-MOT numbers per window beside the CPU record's."""
    for w, e in sorted(run.evals.items()):
        cpu = ref["evals"][str(w)]
        log(f"{label}: w{w} card " + " ".join(
            f"{k}={getattr(e, k):.4f}" if isinstance(getattr(e, k), float)
            else f"{k}={getattr(e, k)}" for k in QUALITY_KEYS)
            + " | CPU " + " ".join(
            f"{k}={cpu[k]:.4f}" if isinstance(cpu[k], float)
            else f"{k}={cpu[k]}" for k in QUALITY_KEYS) + f" ({card})")
    log(f"{label}: tracks_peak={run.tracks_peak} (CPU {ref['tracks_peak']}) "
        f"pool_dropped={run.pool_dropped} (CPU {ref['pool_dropped']}); "
        f"first frame whose 3D ids leave the CPU record: "
        f"{_first_ids_parting(run, ref['ids'])} (of {len(ref['ids'])})")


def _gate_lines(label, gates, held):
    """Logs every gate with its margin; fails on a gate in `held` that
    does not hold.  Returns the names of the printed-only gates that do
    not hold."""
    loose = []
    for name, (ok, value, threshold, margin) in gates.items():
        kind = "held" if name in held else "printed, not held"
        log(f"{label}: gate {name}: {value} against {threshold}, margin "
            f"{margin:+.4f} -> {'pass' if ok else 'FAIL'} ({kind})")
        if not ok:
            if name in held:
                fail(f"{label}: the gate {name} fails on the card "
                     f"({value} against {threshold})")
            loose.append(name)
    return loose


# the density gates chip_smoke fails on: the MOTA floor and containment;
# the window steps are printed (their CPU margin, 0.0009 MOTA, is less
# than one event, and the card's rounding parts ids from the CPU's)
DENSITY_HELD = ("mota_w6 > 0.6", "tracks_peak <= 2000",
                "pool_dropped <= 100")


def _record_route(run, solver_cfg, lk_calls=None):
    """`run()` on the eager 2D route (_Eager2DRoute: the same kernels
    eagerly, the assignment's inputs recorded), its LK calls whose index
    lies in `lk_calls` (all when None) and its solves (SolveCapture, at
    `solver_cfg`) recorded.  Returns (run()'s result, the LK calls, the
    assignment inputs, the solves)."""
    capture = LkCapture(calls=lk_calls)
    capture.install()
    try:
        with _Eager2DRoute() as route, SolveCapture(solver_cfg) as solves:
            out = run()
    finally:
        capture.remove()
    return out, capture.calls, route.inputs, solves.solves


def _recorded_kernels(label, card, lk_calls=None, jv_inputs=None,
                      solves=None):
    """Every kernel of a path against its plain version on the path's own
    recorded inputs, at the limits phases 2, 3f, 11 and 12 hold: each LK
    call with an active slot (compare), each assignment bit for bit
    (jv_compare), each solve's greedy start, start clique weights and BLS
    (_mwcp_check) and its field draw (_threefry_check); None where the
    run recorded none of a kind, and a failure where it was to record
    some and has none.  Returns the largest |kernel - plain version| by
    kernel name."""
    for kind, x in (("LK calls", lk_calls), ("assignments", jv_inputs),
                    ("solves", solves)):
        if x is not None and not len(x):
            fail(f"{label}: no {kind} recorded")
    err = {}
    if lk_calls is not None:
        active = [(a, k) for a, k in lk_calls if bool(a[5].any())]
        if not active:
            fail(f"{label}: no recorded LK call has an active slot")
        d = [compare(a, k, "batched", f"{label} lk_level call {n}")[0]
             for n, (a, k) in enumerate(active)]
        shapes = sorted({(tuple(a[0].shape), a[3].shape[0], k["window"],
                          k["iters"]) for a, k in active})
        err["lk_level"] = max(d)
        log(f"{label}: lk_level kernel == plain version on the "
            f"{len(active)} of {len(lk_calls)} recorded calls with an active "
            f"slot ([C, H, W], N, window, iterations: {shapes}); max "
            f"|d tracked| {err['lk_level']:.3e} px ({card})")
    if jv_inputs is not None:
        err["jv_assign"] = max(jv_compare(*x, f"{label} assignment {n}")[1]
                               for n, x in enumerate(jv_inputs))
        log(f"{label}: jv_assign kernel == plain version (col_of_row equal, "
            f"match_cost bit for bit) on all {len(jv_inputs)} recorded "
            f"{list(jv_inputs[0][0].shape)} assignments ({card})")
    if solves is not None:
        (err["bls_steps"], err["clique_weights"],
         err["greedy_start"]) = _mwcp_check(solves, label)
        shapes = {}
        err["threefry_fields"] = _threefry_check(solves, label, shapes)
        log(f"{label}: threefry_fields kernel == plain version and == the "
            f"captured program's fields bit for bit on the recorded "
            f"solves (shape: solves) {shapes} ({card})")
    return err


def same_fixture_results(a, b, label):
    """Fail unless two quality runs gave the same ids and points on every
    frame."""
    import numpy as np
    if len(a.results) != len(b.results) or any(
            x[0] != y[0] or not np.array_equal(x[1], y[1])
            for x, y in zip(a.results, b.results)):
        fail(f"{label}: the ids or points differ from the graph route's")


def phase_quality(card):
    """13. quality: the JAX package's quality gates and its soak on the
    card, after every timed phase and before any CUPTI session.  The soak
    (soak.soak_run, SOAK_FRAMES frames, SOAK_PEOPLE people: its seven
    checks, buckets, memory, RSS, graph pool, steady frames/s), then the
    sparse fixture (every gate of tests/test_quality_regression.py) and
    the density fixture (the MOTA floor, containment, each window's MOTA
    within MOTA_BOUND of the CPU record; the window steps printed), each
    beside the port's CPU record (quality_reference.json).  Every kernel
    against its plain version on these paths' own inputs
    (_recorded_kernels): the fixtures' solves, recorded in the gated
    runs; the sparse fixture's LK calls and assignments, recorded in a
    second run on the eager 2D route, whose ids and points must equal
    the gated run's; a short soak's (SOAK_RECORD_FRAMES frames on the
    eager route) last SOAK_RECORDED frames' LK calls and assignments and
    every SOLVE_EVERY-th solve.  Returns each path's kernel runs, derived
    (_derived_runs), the fixtures' ids and the soak's population
    numbers, and the largest |kernel - plain version| by kernel."""
    import gc
    import torch
    from mcmtt_opticalflow_tpu_torch import config, quality, soak

    t_phase = time.perf_counter()
    with open(quality.REFERENCE) as f:
        ref = json.load(f)
    runs, ids, errs = {}, {}, []
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    out, eng = soak.soak_run(SOAK_FRAMES, SOAK_PEOPLE, verbose=False,
                             device="cuda")
    runs["soak"] = _derived_runs(eng, "quality soak")
    del eng
    summary = {k: v for k, v in out.items()
               if k not in ("device_samples", "buckets", "checks")}
    ids["soak"] = {k: out[k] for k in SOAK_POPULATION}
    log(f"quality soak: {SOAK_FRAMES} frames, {SOAK_PEOPLE} people on "
        f"{card}: {json.dumps(summary)}")
    log(f"quality soak: device samples {json.dumps(out['device_samples'])}")
    log(f"quality soak: buckets (nr, nb, iters) first met at frame, "
        f"capture s: {json.dumps(out['buckets'])}")
    log(f"quality soak: allocated MiB q2/q4 medians "
        f"{out['allocated_mib_q2_med']} / {out['allocated_mib_q4_med']} "
        f"(at start {out['allocated_mib_at_start']}), reserved "
        f"{out['reserved_mib_q2_med']} / {out['reserved_mib_q4_med']}, "
        f"pinned host {out['pinned_mib_q2_med']} / "
        f"{out['pinned_mib_q4_med']}, RSS {out['rss_mib_q2_med']} / "
        f"{out['rss_mib_q4_med']}; graph "
        f"pools {out['graph_pool_mib']} MiB; steady {out['steady_fps']} "
        f"frames/s (frame ms first/mid/last 50 "
        f"{out['frame_ms_first50_med']} / {out['frame_ms_mid50_med']} / "
        f"{out['frame_ms_last50_med']}); wall {out['wall_s']} s ({card})")
    log(f"quality soak: kernel runs (derived; 13 counted holds them against "
        f"CUPTI) LK/serial/JV {runs['soak'][0]}, solver {runs['soak'][1]}")
    log(f"quality soak: checks {json.dumps(out['checks'])}")
    failed = [k for k, ok in out["checks"].items() if not ok]
    if failed or len(out["checks"]) != 7:
        fail(f"quality soak: checks {failed} fail on the card "
             f"({json.dumps(out['checks'])})")
    t2 = soak.soak_config().tracker2d
    per_frame = t2.lk_pyramid_levels * t2.backtrack_interval
    _, lk_calls, jv_in, solves = _record_route(
        lambda: soak.soak_run(SOAK_RECORD_FRAMES, SOAK_PEOPLE,
                              verbose=False, device="cuda"),
        soak.soak_config().solver,
        range(per_frame * (SOAK_RECORD_FRAMES - SOAK_RECORDED),
              per_frame * SOAK_RECORD_FRAMES))
    errs.append(_recorded_kernels(
        f"quality soak recorded ({SOAK_RECORD_FRAMES} frames, eager 2D "
        f"route)", card, lk_calls, jv_in[-SOAK_RECORDED:],
        solves[::SOLVE_EVERY]))
    del lk_calls, jv_in, solves

    for name, fixture, fixture_cfg in (
            ("sparse", quality.sparse_fixture, quality.sparse_config),
            ("density", quality.density_fixture, quality.density_config)):
        label = f"quality {name}"
        solver_cfg = fixture_cfg(config).solver
        reset_launches()
        t0 = time.perf_counter()
        with SolveCapture(solver_cfg) as solves:
            run = fixture(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[f"quality_{name}"] = _derived_runs(run.engine, label)
        ids[name] = [ids_ for ids_, _ in run.results]
        _finite_results(run, label)
        _quality_lines(label, run, ref[name], card)
        lk_jv, solver = runs[f"quality_{name}"]
        log(f"{label}: {wall:.1f} s (every solve recorded); buckets (nr, "
            f"nb, iters) {sorted(run.engine.assoc._programs)}; kernel runs "
            f"(derived) LK/serial/JV {lk_jv}, solver {solver}")
        if name == "sparse":
            gates = quality.sparse_gates(run)
            _gate_lines(label, gates, held=gates)
            eager, lk_calls, jv_in, _ = _record_route(
                lambda: fixture(device="cuda"), solver_cfg)
            same_fixture_results(run, eager, f"{label} (eager 2D route)")
            errs.append(_recorded_kernels(
                f"{label} recorded (eager 2D route, ids and points equal "
                f"to the graph route's)", card, lk_calls, jv_in))
            del eager, lk_calls, jv_in
        else:
            loose = _gate_lines(label, quality.density_gates(run),
                                DENSITY_HELD)
            if loose:
                log(f"{label}: window-step gates {loose} do not hold on "
                    f"the card; its 3D ids first leave the CPU record at "
                    f"frame {_first_ids_parting(run, ref[name]['ids'])}")
            gap = max(abs(run.evals[w].mota
                          - ref[name]["evals"][str(w)]["mota"])
                      for w in run.evals)
            log(f"{label}: max |card - CPU| MOTA {gap:.4f} (bound "
                f"{MOTA_BOUND})")
            if gap > MOTA_BOUND:
                fail(f"{label}: the card's MOTA leaves the CPU record by "
                     f"{gap:.4f} (bound {MOTA_BOUND})")
        errs.append(_recorded_kernels(f"{label} recorded (graph route)",
                                      card, solves=solves.solves))
        del run, solves
    worst = {}
    for e in errs:
        for k, v in e.items():
            worst[k] = max(worst.get(k, 0.0), v)
    log(f"quality: phase {time.perf_counter() - t_phase:.1f} s, every "
        f"kernel == its plain version on the paths' inputs (largest "
        f"|kernel - plain| {json.dumps(worst)}) ({card})")
    return runs, ids, worst


# the soak's summary numbers that 13 counted holds equal to phase 13's
SOAK_POPULATION = ("registry_q2_med", "registry_q4_med", "buf_mb_q2_med",
                   "buf_mb_q4_med", "vis_map_max", "live_peak")


def phase_quality_counted(card, derived, ids):
    """13 counted: the soak and both quality fixtures again under the
    CUPTI counter, after every timed phase: the kernels the card ran
    equal the runs derived from this run's wrappers and replays
    (_derived_runs) and phase 13's, and the fixtures' ids (the soak's
    population numbers) equal phase 13's run.  Returns the counted runs
    per path: the kernels line's launches."""
    from mcmtt_opticalflow_tpu_torch import quality, soak
    from mcmtt_opticalflow_tpu_torch.utils.kernel_events import KernelEvents

    def soak_run():
        out, eng = soak.soak_run(SOAK_FRAMES, SOAK_PEOPLE, verbose=False,
                                 device="cuda")
        return out, eng, {k: out[k] for k in SOAK_POPULATION}

    def fixture_run(fixture):
        run = fixture(device="cuda")
        return run, run.engine, [ids_ for ids_, _ in run.results]

    counted = {}
    for path, go in (("soak", soak_run),
                     ("quality_sparse",
                      lambda: fixture_run(quality.sparse_fixture)),
                     ("quality_density",
                      lambda: fixture_run(quality.density_fixture))):
        label = f"{path.replace('_', ' ')} counted"
        reset_launches()
        t0 = time.perf_counter()
        with KernelEvents() as ev:
            _, eng, same = go()
        wall = time.perf_counter() - t0
        got = (kernel_runs(ev), solver_kernel_runs(ev))
        want = _derived_runs(eng, label)
        log(f"{label}: kernels run on the card (CUPTI) LK/serial/JV "
            f"{got[0]}, solver {got[1]} (expected {want}; phase 13's "
            f"derived {derived[path]}); {wall:.1f} s under the counter "
            f"({card})")
        if got != want or got != derived[path]:
            fail(f"{label}: the card ran {got}, expected {want}")
        name = path.split("_")[-1]
        if same != ids[name]:
            fail(f"{label}: the results differ from phase 13's run "
                 f"({same} against {ids[name]})" if name == "soak" else
                 f"{label}: the ids differ from phase 13's run")
        counted[path] = got
        del eng
    return counted


def phase_profile(cfg, sc, frames):
    """profile_trace around PROFILE_FRAMES steady frames of the bench main
    path (a fresh pipelined engine, warmed up for WARMUP frames, then its
    fused program precompiled as the bench does): the
    device's busy share over the window, device ms per frame, the top 5
    kernels, and the count of lk_level_kernel events (8 per frame) and of
    jv_assign_kernel events (1 per frame), all inside 2D graph replays,
    and of the solver's three kernels' events
    (one a 3D head replay, one a replay of an iteration part, plus the
    warm-ups of a bucket first met in the window): the 2D wrappers
    launch nothing in the window."""
    import tempfile
    import torch
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu_torch.ops import hungarian, lk_kernel
    from mcmtt_opticalflow_tpu_torch.utils import profile_trace
    from mcmtt_opticalflow_tpu_torch.utils.timing import summarize_trace

    eng = TrackingEngine(cfg, sc.cameras, pipelined=True, device="cuda")
    for t in range(WARMUP):
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
    eng.precompile()            # as the bench does: no capture in the window
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        lk_kernel.lk_level.launches = hungarian.jv_assign.launches = 0
        reset_solver_launches()
        before = solver_runs_expected([eng.assoc])
        t0 = time.perf_counter()
        with profile_trace(logdir):
            for t in range(WARMUP, WARMUP + PROFILE_FRAMES):
                eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
        wall = time.perf_counter() - t0
        launches = lk_kernel.lk_level.launches
        jv_launches = hungarian.jv_assign.launches
        s_launches = solver_launches()
        s = summarize_trace(logdir)
    after = solver_runs_expected([eng.assoc])
    want_s, want_s_wrapper = (tuple(y - x for x, y in zip(b, a))
                              for b, a in zip(before, after))
    n_lk = sum(c for k, c in s.kernel_counts.items()
               if "lk_level_kernel" in k)
    n_jv = sum(c for k, c in s.kernel_counts.items()
               if "jv_assign_kernel" in k)
    n_solver = tuple(sum(c for k, c in s.kernel_counts.items() if part in k)
                     for *_, part in solver_kernels())
    top = [(k[:60], round(ms, 4), c) for k, ms, c in s.top_kernels]
    log(f"profile: {PROFILE_FRAMES} steady bench frames under "
        f"torch.profiler ({wall:.2f} s): device busy share "
        f"{s.busy_share:.4f} of the window, {s.device_ms / PROFILE_FRAMES:.3f}"
        f" device ms per frame, {sum(s.kernel_counts.values())} kernel "
        f"events, lk_level_kernel events={n_lk} (expected "
        f"{8 * PROFILE_FRAMES}), jv_assign_kernel events={n_jv} (expected "
        f"{PROFILE_FRAMES}), wrapper launches {launches} and {jv_launches} "
        f"(expected 0: graph replays only); top 5 kernels (name, ms, "
        f"count) {json.dumps(top)}")
    if not s.kernel_counts or s.busy_share <= 0.0:
        fail("profile: the trace holds no device activity")
    if n_lk != 8 * PROFILE_FRAMES or n_jv != PROFILE_FRAMES:
        fail(f"profile: {n_lk} lk_level_kernel and {n_jv} jv_assign_kernel "
             f"events in the trace, expected {8 * PROFILE_FRAMES} and "
             f"{PROFILE_FRAMES}")
    log(f"profile: greedy_start_kernel, bls_steps_kernel, "
        f"clique_weight_kernel, threefry_fields_kernel events {n_solver} "
        f"(expected {want_s}: the window's 3D draw, head and iteration-part "
        f"replays, and the warm-ups of any capture in it), wrapper "
        f"launches {s_launches} (expected {want_s_wrapper}: those "
        f"captures' calls)")
    if launches or jv_launches or s_launches != want_s_wrapper:
        fail(f"profile: the wrappers launched {launches} LK, {jv_launches} "
             f"JV and {s_launches} solver kernels in a window of replays")
    if n_solver != want_s or not all(want_s):
        fail(f"profile: {n_solver} solver kernel events in the trace, "
             f"expected {want_s} (> 0)")
    return n_lk, n_jv, n_solver


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


def phase_cli(card, counted, record_jv=False):
    """`python -m mcmtt_opticalflow_tpu_torch.main <parameters.txt>` in
    process on the bench scene in the reference layout, at the default
    EngineConfig; the only cut is the sequence length.  `counted`: the
    kernels the card runs are counted by CUPTI (which slows graph
    launches: the CLI's times come from a run with counted=False), the
    wrappers' launches beside them either way; the timed run records
    every solve's inputs (phase 11).  `record_jv`: the 2D step runs on
    the eager route (_Eager2DRoute) to record every frame's assignment
    inputs (phase 3f), returned as {"jv_inputs"} after the CLEAR-MOT
    table, with none of the graph route's checks."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    from mcmtt_opticalflow_tpu_torch import main as cli
    from mcmtt_opticalflow_tpu_torch.config import EngineConfig
    from mcmtt_opticalflow_tpu_torch.data import images
    from mcmtt_opticalflow_tpu_torch.eval import experiment
    from mcmtt_opticalflow_tpu_torch.bench import bench_scene
    from mcmtt_opticalflow_tpu_torch.models import pipeline
    from mcmtt_opticalflow_tpu_torch.ops import hungarian, lk, lk_kernel
    from mcmtt_opticalflow_tpu_torch.utils.kernel_events import KernelEvents

    sc, frames = bench_scene(CLI_FRAMES)
    route = _Eager2DRoute() if record_jv else contextlib.nullcontext()
    engines, per_frame, sweeps, missing = [], [], [], []
    cpu_calls = {"lk_level_reference": 0, "lk_track_points": 0,
                 **{f"{w}_reference": 0 for _, w, _ in solver_kernels()}}

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
                counting("lk_track_points", lk.lk_track_points)),
               *[(m, f"{w}_reference",
                  counting(f"{w}_reference", getattr(m, f"{w}_reference")))
                 for m, w, _ in solver_kernels()]]
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
        hungarian.jv_assign.launches = 0
        reset_solver_launches()
        solves = SolveCapture(EngineConfig().solver)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), route, \
                    (KernelEvents() if counted else solves) as ev:
                cli.main()
        finally:
            sys.argv = argv
            for mod, name, _ in patches:
                setattr(mod, name, orig[name])
        wall = time.perf_counter() - t0
    if record_jv:
        if "== K=10 repeat=0" not in out.getvalue() or \
                len(route.inputs) != CLI_FRAMES:
            fail(f"cli (eager 2D route): {len(route.inputs)} assignments "
                 f"recorded (expected {CLI_FRAMES}) or no CLEAR-MOT table")
        log(f"cli (eager 2D route): {CLI_FRAMES} frames in {wall:.1f} s, "
            f"every frame's {list(route.inputs[0][0].shape)} assignment "
            f"recorded")
        return {"jv_inputs": route.inputs}
    wrapper = (lk_kernel.lk_level.launches,
               lk_kernel.lk_level.serial_launches,
               hungarian.jv_assign.launches)
    name = "cli (counted)" if counted else "cli"
    runs = kernel_runs(ev) if counted else None
    table = out.getvalue()
    for line in table.splitlines():
        log(f"{name}| {line}")
    t2 = EngineConfig().tracker2d
    lk_per_frame = t2.lk_pyramid_levels * t2.backtrack_interval
    replays = sum(e._progs2d[0].graph.n_replays for e in engines)
    want_runs, want_wrapper = expected_2d(engines)
    on_card = (f"kernels run on the card (CUPTI) lk_level={runs[0]} "
               f"(expected {want_runs[0]}: {lk_per_frame} a replay and in "
               f"each capture's warm-up), lk_level_serial={runs[1]}, "
               f"jv_assign={runs[2]} (expected {want_runs[2]}), {ev.total} "
               f"kernels in all; " if counted else "")
    log(f"{name}: {len(engines)} engine(s) on "
        f"{sorted({str(e.device) for e in engines})}, {replays} 2D graph "
        f"replays (expected {CLI_FRAMES}); {on_card}wrapper launches "
        f"{wrapper} (expected {want_wrapper}: the captures' two calls); "
        f"plain-version calls={cpu_calls}, frames without an image="
        f"{len(missing)}")
    if not engines or any(e.device.type != "cuda" for e in engines):
        fail(f"{name}: an engine did not run on the card")
    if replays != CLI_FRAMES or wrapper != want_wrapper or \
            (counted and runs != want_runs):
        fail(f"{name}: expected {CLI_FRAMES} 2D replays, kernel runs "
             f"{want_runs} and wrapper launches {want_wrapper}, got "
             f"{replays}, {runs} and {wrapper}")
    if any(cpu_calls.values()):
        fail(f"{name}: a plain version ran: {cpu_calls}")
    s_runs = solver_kernel_runs(ev) if counted else None
    s_wrapper = solver_launches()
    want_s_runs, want_s_wrapper = solver_runs_expected(
        [e.assoc for e in engines])
    log(f"{name}: solver " + (f"kernels run on the card (CUPTI) "
                              f"(greedy_start, bls_steps, clique_weights, "
                              f"threefry_fields) "
                              f"{s_runs} "
                              f"(expected {want_s_runs}), " if counted
                              else "") +
        f"wrapper launches {s_wrapper} (expected {want_s_wrapper}); "
        f"{0 if counted else len(solves.solves)} solves recorded")
    if s_wrapper != want_s_wrapper or (counted and s_runs != want_s_runs):
        fail(f"{name}: solver kernel runs {s_runs} and wrapper launches "
             f"{s_wrapper}, expected {want_s_runs} and {want_s_wrapper}")
    if missing:
        fail(f"{name}: FrameSource fell back to flat gray for {missing[:3]}")
    if "== K=10 repeat=0" not in table or table.count("window=") != 11:
        fail(f"{name}: the CLEAR-MOT table was not printed")
    (res,), = sweeps
    mota = {f"mota_w{w}": res.per_window[w].mota for w in WINDOWS}
    if not all(np.isfinite(list(mota.values()))) or mota["mota_w0"] <= 0.5:
        fail(f"{name}: MOTA out of range: {mota}")
    timer = engines[0].assoc.timer
    stage_ms = {st: round(1e3 * sorted(timer.samples[st])
                          [timer.counts[st] // 2], 3)
                for st in sorted(timer.totals,
                                 key=lambda n: -timer.totals[n])
                if not st.startswith("_")}
    log(f"{name}: {CLI_FRAMES} frames in {wall:.1f} s on {card}, k_sweep "
        f"{res.fps:.4f} frames/s, median process_frame "
        f"{float(np.median(per_frame)):.4f} s")
    log(f"{name}: per-frame s {[round(x, 4) for x in per_frame]}")
    log(f"{name}: stage medians ms {json.dumps(stage_ms)}")
    log(f"{name}: pool_dropped={engines[0].assoc.pool_dropped_total} "
        f"{json.dumps(mota)}")
    return {"runs": runs, "wrapper": wrapper, "replays": replays,
            "solver_runs": s_runs, "solver_wrapper": s_wrapper,
            "solves": solves.solves}


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
        from concurrent.futures import ThreadPoolExecutor
        from mcmtt_opticalflow_tpu_torch.bench import (bench_config,
                                                       bench_scene)
        from mcmtt_opticalflow_tpu_torch.ops import (hungarian, lk_kernel,
                                                     mwcp_kernel,
                                                     threefry_kernel)
        from mcmtt_opticalflow_tpu_torch.ops.nvcc_build import build_library
        from mcmtt_opticalflow_tpu_torch.utils import kernel_events
    except ImportError as e:
        fail(f"run from the repository root: {e}")
    t_start = time.perf_counter()
    card = card_line()
    log(card)          # name, power limit — as nvidia-smi prints them
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # one nvcc for each source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        for job in [pool.submit(lk_kernel.build),
                    pool.submit(hungarian.build),
                    pool.submit(mwcp_kernel.build),
                    pool.submit(threefry_kernel.build),
                    pool.submit(kernel_events.build)]:
            job.result()
    log(f"build: lk_level.cu (batched + serial kernels), jv_assign.cu, "
        f"mwcp_bls.cu (greedy start, BLS, clique weights), "
        f"threefry_fields.cu (the field draw) and the CUPTI kernel counter "
        f"(kernel_events.cpp) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for source in ("lk_level.cu", "jv_assign.cu", "mwcp_bls.cu",
                   "threefry_fields.cu"):
        for line in build_library(source)[2].splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {line.strip()}")

    cfg = bench_config()
    sc, frames = bench_scene(WARMUP + MEASURED)
    d_tr, _ = check_kernel(frames, cfg, "batched",
                           extra=[unaligned_call(frames, cfg),
                                  *window_calls(frames, cfg)])
    call_ms, _ = time_kernel(frames, cfg, "batched")
    paths, jv_paths, solver_paths = {}, {}, {}
    # every timed phase runs before the first CUPTI session (the main
    # path's count), which slows graph launches for the rest of the process
    calls, jv_inputs, graph_run, bench_solves = phase_routes(card)
    phase_graph2d(cfg, sc, frames, card)
    cli_jv = phase_cli(card, counted=False, record_jv=True)["jv_inputs"]
    jv = phase_jv(jv_inputs, card, cli_jv)
    graph_rec = graph_run.record
    eager_rec, graph_stages = phase_graphs(cfg, sc, frames, card)
    mota = [[r[f"mota_w{w}"] for w in WINDOWS] for r in (graph_rec,
                                                         eager_rec)]
    log(f"graphs: frames/s {graph_rec['value']} on graphs (phase 3d) "
        f"against {eager_rec['value']} on the eager body; hyp.dispatch ms "
        f"{graph_rec['stage_ms'].get('hyp.dispatch')} against "
        f"{eager_rec['stage_ms'].get('hyp.dispatch')}; MOTA {mota[0]} "
        f"against {mota[1]} ({card})")
    if mota[0] != mota[1]:
        fail("graphs: the eager body's bench MOTA differs from the graphs'")
    real = phase_real_inputs(calls)
    phase_modes_agree(cfg, sc, frames)
    phase_cpu_reference()
    s_launches, s_tr, s_call_ms, _ = phase_serial(frames, cfg)
    phase_api(cfg, sc, frames)
    paths["lk_track_pyramid"] = phase_lk_track_pyramid(frames)
    mesh_results, mesh_wall, mesh_heads = phase_mesh(cfg, sc, frames, card)
    if torch.cuda.device_count() >= 4:
        phase_mesh(cfg, sc, frames, card, cards=4)
    else:
        log(f"mesh over 4 cards: not run ({torch.cuda.device_count()} "
            f"card(s) visible)")
    mp_launches, mp_solver_one = phase_multiprocess(mesh_results, mesh_wall,
                                                    mesh_heads, card)
    paths["multiprocess"], jv_paths["multiprocess"], *mp_solver = \
        mp_launches
    solver_paths["multiprocess"] = tuple(mp_solver)
    cli_solves = phase_cli(card, counted=False)["solves"]
    solver_summary = phase_mwcp(bench_solves, cli_solves, card,
                                graph_stages)
    solver_summary["threefry_fields"] = phase_threefry(bench_solves,
                                                       cli_solves, card)
    del bench_solves, cli_solves
    quality_runs, quality_ids, quality_errs = phase_quality(card)
    d_tr = max(d_tr, quality_errs["lk_level"])
    jv["max_abs_err"] = max(jv["max_abs_err"], quality_errs["jv_assign"])
    for kname, summary in solver_summary.items():
        summary["max_abs_err"] = max(summary["max_abs_err"],
                                     quality_errs[kname])
    paths["profile"], jv_paths["profile"], solver_paths["profile"] = \
        phase_profile(cfg, sc, frames)
    main_counts, _ = phase_main_path(card, graph_run)
    paths["main"], _, jv_paths["main"] = main_counts["runs"]
    solver_paths["main"] = main_counts["solver_runs"]
    phase_eager_counted(card)
    paths["mesh"], jv_paths["mesh"], solver_paths["mesh"], \
        solver_paths["sharded_solve"] = phase_mesh_counted(
            cfg, sc, frames, mesh_results)
    # each process replays the 3D program's home parts whole, as the
    # one-process mesh run does
    if mp_solver_one != solver_paths["mesh"]:
        fail(f"multiprocess: the card ran the solver kernels "
             f"{mp_solver_one} times for each process, against "
             f"{solver_paths['mesh']} for the one-process mesh run")
    cli_counts = phase_cli(card, counted=True)
    paths["cli"], _, jv_paths["cli"] = cli_counts["runs"]
    solver_paths["cli"] = cli_counts["solver_runs"]
    for path, ((lk_runs, _, jv_runs), s_runs) in phase_quality_counted(
            card, quality_runs, quality_ids).items():
        paths[path], jv_paths[path], solver_paths[path] = (lk_runs,
                                                           jv_runs, s_runs)
    torch.cuda.synchronize()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    src = "mcmtt_opticalflow_tpu_torch/ops/csrc/lk_level.cu"
    # the wrappers' launches (eager calls and graph recordings) and the 2D
    # graph's replays of the paths whose kernels the card counted
    graphed = {name: {"wrapper_launches": {"main": main_counts["wrapper"][i],
                                           "cli": cli_counts["wrapper"][i]},
                      "graph_replays_2d": {"main": main_counts["replays"],
                                           "cli": cli_counts["replays"]}}
               for i, name in ((0, "lk_level"), (2, "jv_assign"))}
    kernels = []
    for kname, variant, line, n, err, call, by_path in (
            ("lk_level", "batched", 250, paths["main"], d_tr, call_ms,
             paths),
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
            "launches_by_path": by_path, **graphed.get(kname, {})})
    kernels.append({
        "name": "jv_assign", "route": "cuda",
        "source": "mcmtt_opticalflow_tpu_torch/ops/csrc/jv_assign.cu",
        "replaces": "mcmtt_opticalflow_tpu/ops/hungarian.py:54",
        "launches": jv_paths["main"], "library_ms": None, **jv,
        "launches_by_path": jv_paths, **graphed["jv_assign"]})
    # the JAX lines each replaces: the greedy fori_loop, the BLS
    # while_loop, the start score's sum, the loop's field draws
    for i, ((_, kname, _), line, src) in enumerate(zip(
            solver_kernels(), (48, 324, 143, 280),
            ("mwcp_bls.cu",) * 3 + ("threefry_fields.cu",))):
        by_path = {k: v[i] for k, v in solver_paths.items()}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"mcmtt_opticalflow_tpu_torch/ops/csrc/{src}",
            "replaces": f"mcmtt_opticalflow_tpu/models/mwcp.py:{line}",
            "launches": by_path["main"], "library_ms": None,
            **solver_summary[kname], "launches_by_path": by_path,
            "wrapper_launches": {"main": main_counts["solver_wrapper"][i],
                                 "cli": cli_counts["solver_wrapper"][i]}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
