"""The repository's long-sequence stability soak (scripts/soak.py) for the
port: its scenario, configuration, pipelined engine, loop and checks,
built with the port's modules.

    python -m mcmtt_opticalflow_tpu_torch.soak [frames] [people] [--json]
        [--device cuda|cpu]

drives a synthetic sequence (default 320 frames, 16 people, 3 cameras at
320x240) through `TrackingEngine(pipelined=True)` and checks what only a
long run shows: trim_front, the registry's garbage collection, vis-id
recycling and a frame time that does not drift:

  - fps_stable: median frame time of the last 50 frames within 20% of the
    middle 50 (the first ~100 frames still ramp the track population);
  - registry_flat / buffers_flat: registry size and per-track buffer
    bytes plateau (median of the last quarter <= 1.5x the second
    quarter's);
  - vis_ids_bounded: the display-id map never exceeds the live-track
    high-water mark.

On the card it also samples the device state: allocated and reserved
bytes, the pinned host bytes the caching host allocator holds (the
staging of uploads and downloads) and the process's resident host memory
(VmRSS) every 16 frames, and after every frame the captured 3D buckets
(one set of CUDA graphs per bucket, made when first met) and the
reserved bytes.  Three more checks hold there:

  - device_memory_flat: the median of the allocated bytes over the last
    quarter <= 1.5x the second quarter's (counted above those allocated
    when the soak began, so that a caller's own tensors do not dilute
    it), and the reserved bytes rise after the half only in a frame that
    captured a new bucket;
  - captures_settle: no bucket is first met in the last quarter;
  - pinned_memory_flat: the median of the pinned host bytes over the last
    quarter <= 1.5x the second quarter's (a download the host code kept a
    view of held its pinned block: one a frame, for the engine's life).

Off the card those keys are absent.  It prints one JSON line (and, without
--json, a progress line every 64 frames) and exits 0 exactly when every
check passes.  The card is the default; the CPU only runs when asked
for."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from mcmtt_opticalflow_tpu_torch.config import (Associator3DConfig,
                                                EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario

SAMPLE_EVERY = 16           # frames between device-state samples
MIB = 2.0 ** 20


def soak_config(num_cameras: int = 3,
                image_size=(320, 240)) -> EngineConfig:
    """scripts/soak.py's EngineConfig."""
    return EngineConfig(
        num_cameras=num_cameras, image_width=image_size[0],
        image_height=image_size[1],
        tracker2d=Tracker2DConfig(lk_pyramid_levels=2, lk_iterations=6,
                                  max_detections=32, max_trackers=48,
                                  max_features=16, lk_window=8),
        assoc3d=Associator3DConfig(k_best_size=10),
        solver=SolverConfig(num_replicas=4, max_vertices=512,
                            max_iterations=100))


def rss_bytes() -> int:
    """The process's resident host memory (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def graph_pool_bytes(pools) -> int:
    """Bytes the CUDA caching allocator holds in the graph pools `pools`."""
    import torch
    ids = {tuple(p) for p in pools if p is not None}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["segment_pool_id"] in ids)


def _last_quarter(n: int) -> int:
    """The first frame of an n-frame run's last quarter (its last ceil(n/4)
    frames, as the registry check's slice)."""
    return n + (-n) // 4


def _quarters(frames, values, n):
    """The values sampled at frames in the second quarter [n/4, n/2) and
    in the last quarter of an n-frame run."""
    q2 = [v for f, v in zip(frames, values) if n // 4 <= f < n // 2]
    q4 = [v for f, v in zip(frames, values) if f >= _last_quarter(n)]
    return q2, q4


def device_state(start_mib, samples, reserved, buckets, num_frames):
    """The card's summary keys and its three checks (module docstring) from
    the soak's samples: start_mib, the MiB allocated when it began;
    samples, every SAMPLE_EVERY frames {"frame", "allocated_mib",
    "reserved_mib", "pinned_mib", "rss_mib"}; reserved, the bytes
    reserved after each frame; buckets, {"bucket", "frame", "capture_s"}
    as each was first met.  Returns (keys, checks)."""
    frames = [s["frame"] for s in samples]
    med = {}
    for key in ("allocated_mib", "reserved_mib", "pinned_mib", "rss_mib"):
        q2, q4 = _quarters(frames, [s[key] for s in samples], num_frames)
        med[key] = (float(np.median(q2)), float(np.median(q4)))
    own = [m - start_mib for m in med["allocated_mib"]]
    capture_frames = {b["frame"] for b in buckets}
    rises = [t for t in range(max(num_frames // 2, 1), len(reserved))
             if reserved[t] > reserved[t - 1]]
    keys = {
        "allocated_mib_at_start": round(start_mib, 2),
        "device_samples": samples,
        "buckets": buckets,
        **{f"{k[:-4]}_mib_q{q}_med": round(med[k][i], 2)
           for k in med for i, q in ((0, 2), (1, 4))},
        "reserved_rises_after_half": rises,
    }
    checks = {
        "device_memory_flat": bool(
            own[1] <= 1.5 * own[0]
            and all(t in capture_frames for t in rises)),
        "captures_settle": bool(all(b["frame"] < _last_quarter(num_frames)
                                    for b in buckets)),
        "pinned_memory_flat": bool(med["pinned_mib"][1]
                                   <= 1.5 * med["pinned_mib"][0]),
    }
    return keys, checks


def run_soak(num_frames=320, num_people=16, image_size=(320, 240),
             num_cameras=3, verbose=True, device=None):
    """scripts/soak.py's run_soak on the port: the card by default (raises
    without one), or device="cpu".  Returns the summary: the JAX script's
    keys and `checks`, and on the card the device state (module
    docstring)."""
    return soak_run(num_frames, num_people, image_size, num_cameras,
                    verbose, device)[0]


def soak_run(num_frames=320, num_people=16, image_size=(320, 240),
             num_cameras=3, verbose=True, device=None):
    """run_soak's (summary, engine after its flush)."""
    import torch
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    sc = make_scenario(num_cameras=num_cameras, num_frames=num_frames,
                       num_people=num_people, image_size=image_size,
                       arena=7000.0, noise_px=1.0, fp_rate=0.10,
                       fn_rate=0.05, seed=3)
    start_mib = (torch.cuda.memory_allocated(device) / MIB if on_card
                 else 0.0)
    eng = TrackingEngine(soak_config(num_cameras, image_size), sc.cameras,
                         pipelined=True, device=device)

    frame_ms = []
    reg_sizes = []
    buf_bytes = []
    vis_sizes = []
    live_peak = 0
    samples, reserved, buckets = [], [], []
    seen = set()

    def new_buckets(t):
        for key, prog in eng.assoc._programs.items():
            if key not in seen:
                seen.add(key)
                buckets.append({"bucket": list(key), "frame": t,
                                "capture_s": round(prog.capture_s, 4)})
    t_all = time.perf_counter()
    for t in range(num_frames):
        f = (np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5).astype(
            np.uint8)
        t0 = time.perf_counter()
        eng.process_frame(f, sc.detections[t], frame_idx=t)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        a = eng.assoc
        reg_sizes.append(len(a.registry.tracks))
        vis_sizes.append(len(a.vis_id_map))
        live = len(a.active_tracks) + len(a.paused_tracks)
        live_peak = max(live_peak, live)
        if on_card:
            new_buckets(t)
            reserved.append(torch.cuda.memory_reserved(device))
            if t % SAMPLE_EVERY == 0:
                samples.append({
                    "frame": t,
                    "allocated_mib": round(
                        torch.cuda.memory_allocated(device) / MIB, 2),
                    "reserved_mib": round(reserved[-1] / MIB, 2),
                    "pinned_mib": round(torch.cuda.host_memory_stats()
                                        ["allocated_bytes.current"] / MIB, 2),
                    "rss_mib": round(rss_bytes() / MIB, 2)})
        if t % 64 == 0:
            buf_bytes.append(sum(
                tr.points.nbytes + tr.raw_points.nbytes + tr.smoothed.nbytes
                for tr in a.registry.tracks.values()))
            if verbose:
                print(f"frame {t}: {frame_ms[-1]:.0f} ms, "
                      f"registry {reg_sizes[-1]}, "
                      f"bufMB {buf_bytes[-1] / 1e6:.1f}, "
                      f"vis {vis_sizes[-1]}", flush=True)
    while eng.flush() is not None:
        pass
    if on_card:
        new_buckets(num_frames)       # met while draining the tail
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t_all

    # drop compile-heavy head: first 16 frames
    meas = frame_ms[16:]
    q2 = reg_sizes[len(reg_sizes) // 4:len(reg_sizes) // 2]
    q4 = reg_sizes[-len(reg_sizes) // 4:]
    first50 = float(np.median(meas[:50]))
    mid50 = float(np.median(
        meas[len(meas) // 2 - 25:len(meas) // 2 + 25]))
    last50 = float(np.median(meas[-50:]))
    bufs_q2 = buf_bytes[1:max(2, len(buf_bytes) // 2)]
    bufs_q4 = buf_bytes[-max(1, len(buf_bytes) // 4):]
    out = {
        "frames": num_frames,
        "people": num_people,
        "wall_s": round(wall, 1),
        "fps": round(num_frames / wall, 2),
        "frame_ms_first50_med": round(first50, 1),
        "frame_ms_mid50_med": round(mid50, 1),
        "frame_ms_last50_med": round(last50, 1),
        "registry_q2_med": float(np.median(q2)),
        "registry_q4_med": float(np.median(q4)),
        "buf_mb_q2_med": round(float(np.median(bufs_q2)) / 1e6, 2),
        "buf_mb_q4_med": round(float(np.median(bufs_q4)) / 1e6, 2),
        "vis_map_max": max(vis_sizes),
        "live_peak": live_peak,
    }
    checks = {
        # steady-state vs steady-state: the first ~100 frames still ramp
        # the track population from an empty registry, so drift measures
        # against the MIDDLE of the run
        "fps_stable": bool(last50 <= 1.2 * mid50),
        "registry_flat": bool(np.median(q4)
                              <= 1.5 * max(np.median(q2), 64)),
        "buffers_flat": bool(np.median(bufs_q4)
                             <= 1.5 * max(np.median(bufs_q2), 1e6)),
        "vis_ids_bounded": bool(max(vis_sizes) <= live_peak),
    }
    if on_card:
        # steady frames/s: the measured frames of the second half, past
        # the population's ramp
        out["steady_fps"] = round(
            1e3 / float(np.median(meas[len(meas) // 2:])), 3)
        keys, dev_checks = device_state(start_mib, samples, reserved,
                                        buckets, num_frames)
        pools = [p.graph.pool for p in eng._progs2d if p is not None]
        pools += list(eng.assoc._graph_pools.values())
        out.update(device=torch.cuda.get_device_name(device), **keys,
                   graph_pool_mib=round(graph_pool_bytes(pools) / MIB, 2))
        checks.update(dev_checks)
    out["checks"] = checks
    return out, eng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m mcmtt_opticalflow_tpu_torch.soak",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", nargs="?", type=int, default=320)
    ap.add_argument("people", nargs="?", type=int, default=16)
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    from mcmtt_opticalflow_tpu_torch.utils.device import card_or_exit
    out = run_soak(args.frames, args.people, verbose=not args.json,
                   device=card_or_exit(args.device))
    print(json.dumps(out))
    sys.exit(0 if all(out["checks"].values()) else 1)


if __name__ == "__main__":
    main()
