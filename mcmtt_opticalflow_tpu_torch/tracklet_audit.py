"""The 2D stage's tracklet audit (scripts/tracklet_audit.py) on the port:
the bench density scene through the engine's 2D program alone, scored
per camera against the ground truth's feet.

    python -m mcmtt_opticalflow_tpu_torch.tracklet_audit [--frames 35]
        [--people 22] [--device cuda|cpu]

It separates "the 3D stage cannot recover identity" from "the 2D stage
never delivered the tracklets": per camera, the share of ground-truth
person-frames with a detection within 20 px of the feet (det_coverage)
and with a tracklet box there (tracklet_coverage), how often a tracklet
id stays on one person (tracklet_purity_mean) and the tracklets'
lengths.  Each frame's 8-bit gray is (r + g + b) // 3, as the JAX
script computes it, uploaded into the 2D program's buffer; the program
(one CUDA graph on the card) runs once a frame and its packed outputs
come back in one download.  No 3D association runs.  Prints one JSON
line with the JAX script's keys.  The card is the default; the CPU only
runs when asked for."""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

from mcmtt_opticalflow_tpu_torch.config import (EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.density_lab import IMAGE_SIZE, lab_scene

NEAR_PX = 20.0              # a detection or tracklet box "at" the feet


def audit_config() -> EngineConfig:
    """The JAX script's EngineConfig (scripts/tracklet_audit.py:38-43)."""
    return EngineConfig(
        num_cameras=4, image_width=IMAGE_SIZE[0],
        image_height=IMAGE_SIZE[1],
        tracker2d=Tracker2DConfig(lk_pyramid_levels=2, lk_iterations=8,
                                  max_detections=48, max_trackers=64),
        solver=SolverConfig(num_replicas=2, max_vertices=64,
                            max_iterations=20))


def gray_of(frame_u8: np.ndarray) -> np.ndarray:
    """[..., 3] u8 RGB -> [...] u8 gray, (r + g + b) // 3."""
    return ((frame_u8[..., 0].astype(np.uint16) + frame_u8[..., 1]
             + frame_u8[..., 2]) // 3).astype(np.uint8)


def _foot_centers(boxes: np.ndarray) -> np.ndarray:
    """[n, 4] (x, y, w, h) -> [n, 2] bottom centres."""
    if not len(boxes):
        return np.zeros((0, 2))
    return np.stack([boxes[:, 0] + boxes[:, 2] / 2,
                     boxes[:, 1] + boxes[:, 3]], -1)


def run_audit(frames: int = 35, people: int = 22, device=None):
    """The audit on the card by default (raises without one), or
    device="cpu".  Returns (the JSON record, the engine)."""
    from mcmtt_opticalflow_tpu_torch.geometry.tsai_np import HostCamera
    from mcmtt_opticalflow_tpu_torch.models.pipeline import (TrackingEngine,
                                                             _unpack2d)
    from mcmtt_opticalflow_tpu_torch.parallel.mesh import AsyncFetch
    from mcmtt_opticalflow_tpu_torch.utils.device import resolve_device

    sc = lab_scene(frames, people, seed=0)
    eng = TrackingEngine(audit_config(), sc.cameras, pipelined=False,
                         device=resolve_device(device))
    host_cams = [HostCamera(c) for c in sc.cameras]
    w_img, h_img = IMAGE_SIZE

    det_cover = np.zeros((4,))          # person-frames with a detection
    trk_cover = np.zeros((4,))          # person-frames with a tracklet box
    gt_total = np.zeros((4,))
    # per camera: tracklet id -> person -> frames near that person
    votes = [defaultdict(lambda: defaultdict(int)) for _ in range(4)]
    lengths = [defaultdict(int) for _ in range(4)]

    for t in range(sc.num_frames):
        rgb = (np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5
               ).astype(np.uint8)
        boxes, mask = eng._pad_detections(sc.detections[t])
        eng._upload_gray(gray_of(rgb))
        eng.frame_idx = t
        ids_np, boxes_np, mask_np = _unpack2d(
            AsyncFetch(eng._step2d(boxes, mask)).get())
        for c in range(4):
            feet = {}
            for p in range(sc.num_people):
                xy = sc.gt_xy[t, p]
                if np.isnan(xy[0]):
                    continue
                f = host_cams[c].world_to_image(
                    np.asarray([xy[0], xy[1], 0.0]))
                if not np.isfinite(f).all():
                    continue
                if 0 <= f[0] < w_img and 0 <= f[1] < h_img:
                    feet[p] = f
                    gt_total[c] += 1
            dbc = _foot_centers(
                np.asarray(sc.detections[t][c]).reshape(-1, 4))
            tid = ids_np[c][mask_np[c]]
            tbc = _foot_centers(boxes_np[c][mask_np[c]])
            for p, f in feet.items():
                if len(dbc) and np.min(np.linalg.norm(dbc - f, axis=1)) \
                        < NEAR_PX:
                    det_cover[c] += 1
                if len(tbc):
                    d = np.linalg.norm(tbc - f, axis=1)
                    j = int(np.argmin(d))
                    if d[j] < NEAR_PX:
                        trk_cover[c] += 1
                        votes[c][int(tid[j])][p] += 1
            for i in tid:
                lengths[c][int(i)] += 1

    purity = [max(vs.values()) / sum(vs.values())
              for c in range(4) for vs in votes[c].values()]
    ln = [n for c in range(4) for n in lengths[c].values()]
    record = {
        "gt_person_frames": gt_total.sum(),
        "det_coverage": round(float(det_cover.sum() / gt_total.sum()), 3),
        "tracklet_coverage": round(float(trk_cover.sum() / gt_total.sum()),
                                   3),
        "tracklet_purity_mean": round(float(np.mean(purity)), 3),
        "tracklet_len_mean": round(float(np.mean(ln)), 2),
        "num_tracklets": len(ln),
    }
    return record, eng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m mcmtt_opticalflow_tpu_torch.tracklet_audit",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=35)
    ap.add_argument("--people", type=int, default=22)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    from mcmtt_opticalflow_tpu_torch.utils.device import card_or_exit
    device = card_or_exit(args.device)
    record, _ = run_audit(args.frames, args.people, device)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
