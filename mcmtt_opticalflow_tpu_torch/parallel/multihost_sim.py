"""The port's cross-process path in several processes (the counterpart of
scripts/multihost_sim.py, on torch.distributed).

Each process:

  1. joins the process group (parallel/launch.py::init),
  2. builds the global ('cam', 'block') mesh over every process's local
     devices and checks that it spans all the processes,
  3. runs the replica-sharded solve with blocks in every process (the
     block bests cross processes by all-gather), checks that the pick is
     a clique with score > 0 and that it equals the blocks' own
     solve_mwcp calls plus the argmax, made here in one process,
  4. fetches a value split over every mesh device and checks it whole,
  5. steps TrackingEngine(pipelined=True) on the global mesh for
     --engine-frames frames,
  6. process 0 writes parallel/launch.py::scaling_report (the solve's
     rates) plus processes, local_devices, solver_best_score,
     engine_track_results and each frame's ids and points to --out;

and every process prints its own results as one line `RESULT {json}`,
so that a caller can hold the processes against each other and against
a run in one process.  Any failed check exits non-zero.

    python -m mcmtt_opticalflow_tpu_torch.parallel.multihost_sim \\
        --coordinator localhost:PORT --num-processes 2 --process-id {0,1} \\
        [--local-devices cpu,cpu,cpu,cpu] [--backend gloo] --out report.json

`spawn` starts all the processes on this host and collects their results
(tests/test_torch_multiprocess.py, chip_smoke.py).

Without --bench: the small CPU scene of scripts/multihost_sim.py (one
camera per 'cam' row, 128x96, 3 people) and its solve (V=64, R=2, 80
iterations) on the global mesh.  --bench: the bench configuration and
the first frames of the bench scene (mcmtt_opticalflow_tpu_torch/
bench.py, 37 frames) with the solver's fields
drawn on the host from seed 1, as chip_smoke.py's mesh phase runs them,
and the solve of that phase (V=1024, 700 valid, R=38, 150 iterations)
over a mesh of one 'cam' row.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 3
_MODULE = "mcmtt_opticalflow_tpu_torch.parallel.multihost_sim"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_all(num_processes, args, workdir, limit_s):
    """One attempt of `spawn`: [(returncode, stdout, stderr)]."""
    port = _free_port()
    procs, logs = [], []
    try:
        for pid in range(num_processes):
            cmd = [sys.executable, "-m", _MODULE,
                   "--coordinator", f"localhost:{port}",
                   "--num-processes", str(num_processes),
                   "--process-id", str(pid), *args]
            if pid == 0:
                cmd += ["--out", os.path.join(workdir, "report.json")]
            # output to files: a full pipe would stall a process
            logs.append([open(os.path.join(workdir, f"{pid}.{k}"), "w+")
                         for k in ("out", "err")])
            procs.append(subprocess.Popen(cmd, cwd=_ROOT, stdout=logs[-1][0],
                                          stderr=logs[-1][1]))
        deadline = time.monotonic() + limit_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:                 # a partner failed, or time is up
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for p, files in zip(procs, logs):
        text = []
        for f in files:
            f.seek(0)
            text.append(f.read())
            f.close()
        outs.append((p.returncode, *text))
    return outs


def spawn(num_processes: int, args, workdir: str, limit_s: float):
    """Run this module in `num_processes` processes on this host (a free
    localhost port; process 0 writes workdir/report.json), each with the
    extra command-line `args`.  Every process is killed at `limit_s`, and
    all of them as soon as one fails.  Tries a second port once when the
    first was taken.  Returns (the report or None, per process
    (returncode, stdout, stderr, its RESULT dict or None))."""
    outs = _start_all(num_processes, args, workdir, limit_s)
    if any(rc != 0 and "address already in use" in err.lower()
           for rc, _, err in outs):
        outs = _start_all(num_processes, args, workdir, limit_s)
    results = []
    for rc, out, err in outs:
        line = next((l for l in out.splitlines() if l.startswith("RESULT ")),
                    None)
        results.append((rc, out, err, None if line is None
                        else json.loads(line[len("RESULT "):])))
    path = os.path.join(workdir, "report.json")
    report = None
    if os.path.exists(path):
        with open(path) as f:
            report = json.load(f)
    return report, results


def _solve_instance(bench: bool):
    """(weights, adj, valid, init, SolverConfig, iterations) as numpy."""
    from mcmtt_opticalflow_tpu_torch.config import SolverConfig
    if bench:
        rng = np.random.RandomState(2)
        v, nv = 1024, 700
        scfg = SolverConfig(num_replicas=8 + 30, max_vertices=v,
                            solutions_per_replica=16)
        weights = np.zeros(v, np.float32)
        weights[:nv] = rng.rand(nv) * 10
        up = np.triu(rng.rand(v, v) < 0.5, 1)
        valid = np.arange(v) < nv
        adj = (up | up.T) & valid[:, None] & valid[None, :]
        return weights, adj, valid, np.zeros(v, bool), scfg, 150
    scfg = SolverConfig(num_replicas=2, max_vertices=64,
                        solutions_per_replica=4)
    rng = np.random.RandomState(7)
    v = scfg.max_vertices
    weights = rng.rand(v).astype(np.float32)
    up = np.triu(rng.rand(v, v) < 0.5, 1)
    return (weights, up | up.T, np.ones(v, bool), np.zeros(v, bool), scfg,
            80)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def run_solve(mesh, bench: bool, reps: int = REPS) -> dict:
    """The sharded solve on `mesh`, checked against the per-block solves
    made here, and its time against one solve_mwcp call (means over
    `reps` calls after the first)."""
    from mcmtt_opticalflow_tpu_torch.models.mwcp import solve_mwcp
    from mcmtt_opticalflow_tpu_torch.parallel import (block_sharding,
                                                      solve_mwcp_sharded)
    from mcmtt_opticalflow_tpu_torch.utils import prng
    weights, adj, valid, init, scfg, iters = _solve_instance(bench)
    home = mesh.home
    ins = [torch.tensor(x, device=home) for x in (weights, adj, valid, init)]
    nblock = mesh.shape["block"]

    key = prng.prng_key(3)

    def sharded():
        out = solve_mwcp_sharded(*ins, key, mesh, scfg, iters=iters)
        _sync(home)
        return out

    got = sharded()
    blocks = [solve_mwcp(*ins, k, scfg, iters)
              for k in prng.split(key, nblock)]
    best = torch.stack([r.best_score.max() for r in blocks])
    b = int(torch.argmax(best))
    want = blocks[b].best_mask[int(torch.argmax(blocks[b].best_score))]
    same = (torch.equal(got[0], want) and float(got[1]) == float(best[b])
            and torch.equal(got[2], torch.cat([r.best_mask for r in blocks]))
            and torch.equal(got[3], torch.cat([r.best_score
                                               for r in blocks])))
    members = np.flatnonzero(got[0].cpu().numpy())
    clique = bool(adj[np.ix_(members, members)].sum()
                  == len(members) * (len(members) - 1))
    t0 = time.perf_counter()
    for _ in range(reps):
        sharded()
    mesh_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        solve_mwcp(*ins, key, scfg, iters)
        _sync(home)
    one_s = (time.perf_counter() - t0) / reps
    return {"mesh": repr(mesh), "best_score": float(got[1]),
            "best_mask": members.tolist(),
            "all_masks_sha256": _digest(got[2]),
            "all_scores_sha256": _digest(got[3]), "clique": clique,
            "equals_per_block": same,
            "blocks_here": [b for b, ok in
                            enumerate(block_sharding(mesh).local) if ok],
            "mesh_s": mesh_s, "one_s": one_s}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_fetch(mesh) -> bool:
    """A tree of a value split over every mesh device and a tensor comes
    back whole from a fetch in every process."""
    from mcmtt_opticalflow_tpu_torch.parallel.mesh import (device_sharding,
                                                           fetch)
    whole = torch.arange(mesh.size * 6, dtype=torch.float32).reshape(-1, 3)
    split = device_sharding(mesh).split(whole)
    out = fetch((split, (whole[:2].to(mesh.home),)))
    return bool(np.array_equal(out[0], whole.numpy())
                and np.array_equal(out[1][0], whole[:2].numpy()))


def run_engine(mesh, bench: bool, frames_n: int, make_fields=None) -> dict:
    """TrackingEngine(pipelined=True) on `mesh` for `frames_n` frames:
    each frame's ids and points, the wall time, the time spent in
    cross-process collectives and their count per process_frame / flush
    call, and the LK kernel launches this process made.  The solver draws
    from the associator's key, which every process derives alike from the
    seed; `make_fields(cfg)`, when given, makes a field source to draw
    from instead."""
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu_torch.ops import lk_kernel
    from mcmtt_opticalflow_tpu_torch.parallel import mesh as mesh_mod

    if bench:
        from mcmtt_opticalflow_tpu_torch.bench import (bench_config,
                                                       bench_scene)
        cfg = bench_config()
        sc, frames = bench_scene()
    else:
        from mcmtt_opticalflow_tpu_torch.config import (EngineConfig,
                                                        SolverConfig,
                                                        Tracker2DConfig)
        from mcmtt_opticalflow_tpu_torch.data import make_scenario
        num_cams = mesh.shape["cam"]
        w, h = 128, 96
        sc = make_scenario(num_cameras=num_cams, num_frames=frames_n,
                           num_people=3, image_size=(w, h), arena=3000.0,
                           seed=0)
        frames = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255)
                  .astype(np.uint8) for t in range(frames_n)]
        cfg = EngineConfig(
            num_cameras=num_cams, image_width=w, image_height=h,
            tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                                      max_features=16, lk_window=8,
                                      lk_pyramid_levels=2, lk_iterations=4),
            solver=SolverConfig(num_replicas=2, max_vertices=64,
                                solutions_per_replica=4, max_iterations=60))
    eng = TrackingEngine(cfg, sc.cameras, pipelined=True, mesh=mesh)
    if make_fields is not None:
        eng.assoc.field_source = make_fields(cfg)

    # time spent in, and count of, the collectives of each process_frame
    # / flush call
    spent = [0.0, 0]
    gather = mesh_mod.all_gather_host

    def timed(obj):
        t0 = time.perf_counter()
        try:
            return gather(obj)
        finally:
            spent[0] += time.perf_counter() - t0
            spent[1] += 1

    mesh_mod.all_gather_host = timed
    per_call, count_per_call, results = [], [], []
    lk_kernel.lk_level.launches = 0
    t0 = time.perf_counter()
    try:
        t = 0
        while True:               # the frames, then flush() until None
            spent[:] = [0.0, 0]
            if t < frames_n:
                r = eng.process_frame(frames[t], sc.detections[t],
                                      frame_idx=t)
            else:
                r = eng.flush()
                if r is None:
                    break
            per_call.append(spent[0])
            count_per_call.append(spent[1])
            t += 1
            if r is not None:
                results.append(r)
        _sync(eng.device)
    finally:
        mesh_mod.all_gather_host = gather
    wall = time.perf_counter() - t0
    return {"frames": [{"frame": r.frame_idx, "ids": [int(i) for i in r.ids],
                        "points": np.asarray(r.points, np.float64).tolist()}
                       for r in results],
            "wall_s": wall, "lk_launches": lk_kernel.lk_level.launches,
            "collective_s_per_call": per_call,
            "collectives_per_call": count_per_call,
            "groups_here": [g for g, s in enumerate(eng.state2d_groups)
                            if s is not None]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", default=None,
                    help="comma-separated torch devices of this process "
                         "(default: its own CUDA card)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl with a card, else gloo")
    ap.add_argument("--out", default=None)
    ap.add_argument("--engine-frames", type=int, default=3)
    ap.add_argument("--bench", action="store_true")
    args = ap.parse_args(argv)

    from mcmtt_opticalflow_tpu_torch.parallel import launch
    from mcmtt_opticalflow_tpu_torch.parallel.mesh import make_mesh

    local = None if args.local_devices is None else [
        torch.device(d) for d in args.local_devices.split(",")]
    if local and all(d.type == "cpu" for d in local):
        torch.set_num_threads(2)
    launch.init(args.coordinator, num_processes=args.num_processes,
                process_id=args.process_id, backend=args.backend)
    try:
        mesh = launch.global_mesh(local_devices=local)
        if mesh.processes != list(range(args.num_processes)):
            raise SystemExit(f"the mesh spans processes {mesh.processes}")
        solve_mesh = mesh if not args.bench else make_mesh(
            1, list(mesh.devices.flat), mesh.owners.ravel(),
            mesh.process_index)
        solver = run_solve(solve_mesh, args.bench)
        if not (solver["clique"] and solver["best_score"] > 0.0
                and solver["equals_per_block"]):
            raise SystemExit(f"sharded solve failed its checks: {solver}")
        fetch_ok = check_fetch(mesh)
        if not fetch_ok:
            raise SystemExit("a cross-process fetch was not whole")
        engine = run_engine(mesh, args.bench, args.engine_frames)
        n_results = sum(len(f["ids"]) for f in engine["frames"])
        if n_results == 0:
            raise SystemExit("the engine produced no tracks on the mesh")
        if args.process_id == 0 and args.out:
            report = launch.scaling_report(mesh, 1.0 / solver["one_s"],
                                           1.0 / solver["mesh_s"])
            report.update(processes=args.num_processes,
                          local_devices=int((mesh.owners
                                             == mesh.process_index).sum()),
                          solver_best_score=solver["best_score"],
                          engine_track_results=n_results,
                          frames=engine["frames"])
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        print("RESULT " + json.dumps({
            "process": args.process_id, "mesh": repr(mesh),
            "solver": solver, "fetch_ok": fetch_ok, "engine": engine}),
            flush=True)
        print(f"process {args.process_id}: ok mesh={mesh.shape} "
              f"score={solver['best_score']:.3f} engine_results={n_results}",
              flush=True)
    finally:
        launch.shutdown()


if __name__ == "__main__":
    main()
