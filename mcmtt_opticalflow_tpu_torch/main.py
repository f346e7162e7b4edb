"""CLI experiment driver (the reference's _tmain, psn_where/main.cpp:87-172).

Usage:
  python -m mcmtt_opticalflow_tpu_torch.main <parameters.txt>   # dataset run
  python -m mcmtt_opticalflow_tpu_torch.main --synthetic        # built-in demo

Reads the reference's parameters.txt keys (DATASET_PATH, START/END_FRAME_IDX,
NUM_EXPERIMENTS, SIZE_OF_KS, NUM_FRAMES_FOR_CONFIRMATION —
ref main.cpp:200-221), sweeps K x repeats, runs the engine, and prints the
per-window CLEAR-MOT table.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def run_synthetic(args):
    from mcmtt_opticalflow_tpu_torch.config import (EngineConfig,
                                                    SolverConfig,
                                                    Tracker2DConfig)
    from mcmtt_opticalflow_tpu_torch.data import make_scenario
    from mcmtt_opticalflow_tpu_torch.eval.experiment import k_sweep
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine

    sc = make_scenario(num_cameras=args.cameras, num_frames=args.frames,
                       num_people=args.people, image_size=(384, 288),
                       arena=6000.0, seed=args.seed)
    gx, gy = sc.gt_matrices()
    zone = (-12000.0, -12000.0, 12000.0, 12000.0)

    def make_engine(k):
        cfg = EngineConfig(
            num_cameras=args.cameras, image_width=384, image_height=288,
            tracker2d=Tracker2DConfig(max_detections=16, max_trackers=32,
                                      max_features=16, lk_window=8),
            solver=SolverConfig(num_replicas=4, max_vertices=128,
                                max_iterations=500))
        cfg = dataclasses.replace(
            cfg, assoc3d=dataclasses.replace(cfg.assoc3d, k_best_size=k))
        return TrackingEngine(cfg, sc.cameras, device=args.device)

    results = k_sweep(make_engine,
                      lambda t: np.stack(sc.frames(t)),
                      lambda t: sc.detections[t],
                      sc.num_frames, (gx, gy), zone,
                      ks=args.ks, num_experiments=args.repeats,
                      deferred_windows=args.windows)
    for r in results:
        print(f"== K={r.k} repeat={r.repeat} fps={r.fps:.2f}")
        for w, ev in sorted(r.per_window.items()):
            print(f"   window={w:2d}  {ev.summary()}")


def run_dataset(args):
    from mcmtt_opticalflow_tpu_torch.config import (EngineConfig,
                                                    parse_parameters_txt)
    from mcmtt_opticalflow_tpu_torch.data import (FrameSource,
                                                  read_detection_file,
                                                  read_ground_truth,
                                                  read_tsai_xml)
    from mcmtt_opticalflow_tpu_torch.eval.experiment import k_sweep
    from mcmtt_opticalflow_tpu_torch.geometry.sidemaps import \
        load_or_compute_sidemaps
    from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine

    if not os.path.isfile(args.parameters):
        # usage error like the reference (ref psn_where/main.cpp:181-184)
        print(f"error: parameter file not found: {args.parameters}\n"
              "usage: python -m mcmtt_opticalflow_tpu_torch.main <parameters.txt>"
              " | --synthetic", file=sys.stderr)
        raise SystemExit(2)
    params = parse_parameters_txt(open(args.parameters).read())
    root = params.get("DATASET_PATH", ".")
    start = int(params.get("START_FRAME_IDX", 0))
    end = int(params.get("END_FRAME_IDX", 100))
    cam_ids = params.get("CAM_IDS", [1, 5, 7])
    if isinstance(cam_ids, int):
        cam_ids = [cam_ids]
    # the reference's experiment-loop keys (ref main.cpp:103-106, 200-221)
    ks = params.get("SIZE_OF_KS", [10])
    if isinstance(ks, int):
        ks = [ks]
    num_experiments = int(params.get("NUM_EXPERIMENTS", 1))
    n_confirm = int(params.get("NUM_FRAMES_FOR_CONFIRMATION", 3))
    # crop zone: overridable (the reference bakes it in per dataset preset,
    # ref Defines.h:82-86); default = PETS2009
    zone = tuple(params.get("CROP_ZONE", (-14069.6, -14274.0,
                                          4981.3, 1733.5)))

    cams = [read_tsai_xml(os.path.join(
        root, "calibrationInfos", f"View_{cid:03d}.xml")) for cid in cam_ids]
    w, h = int(cams[0].width), int(cams[0].height)
    # precomputed reference side-maps when present, else Tsai-derived
    sidemaps = [load_or_compute_sidemaps(c, w, h, 4, dataset_path=root,
                                         cam_id=cid)
                for c, cid in zip(cams, cam_ids)]

    def make_engine(k):
        cfg = EngineConfig(num_cameras=len(cams), cam_ids=tuple(cam_ids),
                           image_width=w, image_height=h,
                           start_frame=start, end_frame=end)
        cfg = dataclasses.replace(cfg, assoc3d=dataclasses.replace(
            cfg.assoc3d, k_best_size=k,
            num_frames_for_confirmation=n_confirm))
        return TrackingEngine(cfg, cams, pipelined=True, sidemaps=sidemaps,
                              device=args.device)

    def dets(t):
        return [read_detection_file(os.path.join(
            root, f"View_{cid:03d}", "detectionResult",
            f"frame_{t:04d}.txt"))[0] for cid in cam_ids]

    frames = FrameSource(root, cam_ids, w, h)

    gt_path = os.path.join(root, "groundTruth", "cropped.txt")
    gt = read_ground_truth(gt_path) if os.path.exists(gt_path) else None
    results = k_sweep(make_engine, frames, dets, end - start + 1,
                      gt, zone, ks=ks, num_experiments=num_experiments)
    for r in results:
        print(f"== K={r.k} repeat={r.repeat} fps={r.fps:.2f}")
        for w_, ev in sorted(r.per_window.items()):
            print(f"   window={w_:2d}  {ev.summary()}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parameters", nargs="?", help="parameters.txt path")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--cameras", type=int, default=3)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--people", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ks", type=int, nargs="+", default=[10])
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the CUDA card (default) or the CPU")
    args = ap.parse_args()
    from mcmtt_opticalflow_tpu_torch.utils.device import default_device
    if args.device == "cuda":
        try:
            args.device = default_device()
        except RuntimeError as e:
            raise SystemExit(f"error: {e}")
    print(f"device: {args.device}", file=sys.stderr)
    if args.synthetic or not args.parameters:
        run_synthetic(args)
    else:
        run_dataset(args)


if __name__ == "__main__":
    main()
