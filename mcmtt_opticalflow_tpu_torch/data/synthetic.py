"""Synthetic multi-camera pedestrian scenarios.

The reference is driven by PETS2009/ETRI recordings that are not shipped
with the code; the engine therefore generates its own calibrated scenarios
for tests and benchmarks: ground-truth 3D walks, Tsai cameras on a ring,
projected full-body detections with configurable noise/FP/FN, and rendered
textured frames so the optical-flow and appearance paths see real structure.

Output formats mirror the reference's data model: detections are (x, y, w, h)
full-body boxes whose bottom-centre is the ground reconstruction point
(ref psn_where/PSNWhere_Types.h:131-145), and ground truth is the X/Y
matrix pair consumed by the CLEAR-MOT evaluator (ref Evaluator.cpp:45-88).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from mcmtt_opticalflow_tpu_torch.geometry.tsai import TsaiCamera
from mcmtt_opticalflow_tpu_torch.geometry.tsai_np import HostCamera


def ring_cameras(num_cameras: int,
                 arena_radius: float = 8000.0,
                 camera_height: float = 5500.0,
                 image_size: Tuple[int, int] = (768, 576),
                 focal: float = 8.0,
                 kappa1: float = 1e-9) -> List[TsaiCamera]:
    """Place cameras on a ring looking at the arena centre (origin).

    Builds Tsai extrinsics directly: the rotation maps world axes into a
    camera frame whose +z looks at the origin and +y points "down" in image
    space; translation t = -R c for camera centre c.
    """
    w, h = image_size
    cams = []
    for i in range(num_cameras):
        ang = 2.0 * np.pi * i / num_cameras + 0.35
        c = np.asarray([arena_radius * 1.6 * np.cos(ang),
                        arena_radius * 1.6 * np.sin(ang),
                        camera_height])
        look = np.asarray([0.0, 0.0, 800.0])
        fwd = look - c
        fwd = fwd / np.linalg.norm(fwd)
        up_world = np.asarray([0.0, 0.0, 1.0])
        right = np.cross(fwd, up_world)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        down /= np.linalg.norm(down)
        # rows of R: camera x (right), y (down), z (forward)
        rot = np.stack([right, down, fwd])
        t = -rot @ c
        # recover Euler angles in the reference's R(rx, ry, rz) convention
        # (ref cameraModel.cpp:38-53): R = Rz(rz) @ Ry(ry) @ Rx(rx) rows
        ry = np.arcsin(-rot[2, 0])
        rx = np.arctan2(rot[2, 1], rot[2, 2])
        rz = np.arctan2(rot[1, 0], rot[0, 0])
        cams.append(TsaiCamera.create(
            width=w, height=h, dpx=0.0083, dpy=0.0083,
            focal=focal, kappa1=kappa1, cx=w / 2.0, cy=h / 2.0, sx=1.0,
            tx=t[0], ty=t[1], tz=t[2], rx=rx, ry=ry, rz=rz))
    return cams


@dataclasses.dataclass
class SyntheticScenario:
    """A generated multi-camera tracking scenario."""

    cameras: List[TsaiCamera]
    num_frames: int
    num_people: int
    image_size: Tuple[int, int]
    # ground truth trajectories: [T, P, 2] mm on the ground plane; nan = absent
    gt_xy: np.ndarray
    heights: np.ndarray               # [P] person heights, mm
    # detections[t][c] -> [K, 4] float boxes (x, y, w, h)
    detections: List[List[np.ndarray]]
    # per-person visual textures for rendering
    _textures: Optional[np.ndarray] = None
    _background: Optional[np.ndarray] = None
    _host_cams: Optional[list] = None

    def __post_init__(self):
        if self._host_cams is None:
            self._host_cams = [HostCamera(c) for c in self.cameras]

    def gt_matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        """X, Y matrices in the reference evaluator's layout [T, P]
        (0.0 encodes 'absent', ref Evaluator.cpp:45-88)."""
        x = np.where(np.isnan(self.gt_xy[..., 0]), 0.0, self.gt_xy[..., 0])
        y = np.where(np.isnan(self.gt_xy[..., 1]), 0.0, self.gt_xy[..., 1])
        return x, y

    def render_frame(self, t: int, cam_idx: int) -> np.ndarray:
        """[H, W, 3] float32 image in [0, 1] with textured pedestrians."""
        w, h = self.image_size
        img = self._background.copy()
        cam = self._host_cams[cam_idx]
        order = []  # paint far people first (approx by image y of feet)
        for p in range(self.num_people):
            xy = self.gt_xy[t, p]
            if np.isnan(xy[0]):
                continue
            feet = cam.world_to_image(np.asarray([xy[0], xy[1], 0.0]))
            head = cam.world_to_image(
                np.asarray([xy[0], xy[1], self.heights[p]]))
            order.append((feet[1], p, feet, head))
        order.sort()
        for _, p, feet, head in order:
            bh = abs(feet[1] - head[1])
            bw = 0.42 * bh
            x0 = int(round(feet[0] - bw / 2))
            y0 = int(round(min(feet[1], head[1])))
            x1 = int(round(feet[0] + bw / 2))
            y1 = int(round(max(feet[1], head[1])))
            x0c, y0c = max(x0, 0), max(y0, 0)
            x1c, y1c = min(x1, w), min(y1, h)
            if x1c <= x0c or y1c <= y0c:
                continue
            tex = self._textures[p]
            th, tw = tex.shape[:2]
            # stretch the texture over the full box so it stays glued to the
            # person (good optical flow target)
            yy = ((np.arange(y0c, y1c) - y0) * (th - 1) /
                  max(y1 - y0, 1)).astype(int)
            xx = ((np.arange(x0c, x1c) - x0) * (tw - 1) /
                  max(x1 - x0, 1)).astype(int)
            img[y0c:y1c, x0c:x1c] = tex[yy[:, None], xx[None, :]]
        return img

    def frames(self, t: int) -> List[np.ndarray]:
        return [self.render_frame(t, c) for c in range(len(self.cameras))]


def _random_walks(rng, num_frames, num_people, arena, speed, enter_exit):
    """[T, P, 2] smooth bounded random walks; nan outside lifetime."""
    t_total = num_frames
    xy = np.full((t_total, num_people, 2), np.nan)
    for p in range(num_people):
        if enter_exit and num_people > 1:
            t0 = rng.randint(0, max(1, t_total // 3))
            t1 = rng.randint(2 * t_total // 3, t_total)
        else:
            t0, t1 = 0, t_total
        pos = rng.uniform(-arena * 0.6, arena * 0.6, size=2)
        vel = rng.uniform(-1, 1, size=2)
        vel = vel / (np.linalg.norm(vel) + 1e-9) * speed * rng.uniform(0.5, 1.0)
        for t in range(t0, t1):
            xy[t, p] = pos
            # smooth heading change
            ang = rng.randn() * 0.15
            rot = np.asarray([[np.cos(ang), -np.sin(ang)],
                              [np.sin(ang), np.cos(ang)]])
            vel = rot @ vel
            pos = pos + vel
            # soft arena boundary: bounce
            for d in range(2):
                if abs(pos[d]) > arena:
                    vel[d] = -vel[d]
                    pos[d] = np.clip(pos[d], -arena, arena)
    return xy


def synth_tracklet_stream(sc: "SyntheticScenario", max_trackers: int,
                          rotation: int, fn_rate: float = 0.05,
                          fp_per_cam: float = 0.10,
                          noise_px: float = 1.0, seed: int = 1,
                          staggered: bool = False):
    """Synthesize the 2D stage's per-frame output (ids, boxes, mask)
    directly from ground truth: each visible person's box becomes a
    tracklet whose id rotates every `rotation` frames — SYNCHRONIZED
    across all targets, the worst-case load the reference's 3-frame
    tracklet cap creates (ref PSN_2D_MAX_TRACKLET_LENGTH,
    Tracker2D.cpp:10) when every target is present from frame 0.  False
    positives become one-frame tracklets; misses drop the tracklet for a
    frame.  Drives associator-only density tests/benchmarks ~100x faster
    than the full pipeline."""
    rng = np.random.RandomState(seed)
    host_cams = [HostCamera(c) for c in sc.cameras]
    w, h = sc.image_size
    ncam = len(sc.cameras)
    out = []
    next_fp_id = 1_000_000
    for t in range(sc.num_frames):
        ids = np.full((ncam, max_trackers), -1, np.int64)
        boxes = np.zeros((ncam, max_trackers, 4), np.float32)
        mask = np.zeros((ncam, max_trackers), bool)
        for c, cam in enumerate(host_cams):
            k = 0
            for p in range(sc.num_people):
                xy = sc.gt_xy[t, p]
                if np.isnan(xy[0]) or rng.rand() < fn_rate:
                    continue
                feet = cam.world_to_image(np.asarray([xy[0], xy[1], 0.0]))
                head = cam.world_to_image(
                    np.asarray([xy[0], xy[1], sc.heights[p]]))
                if not (np.isfinite(feet).all() and np.isfinite(head).all()):
                    continue
                bh = abs(feet[1] - head[1])
                bw = 0.42 * bh
                x0 = feet[0] - bw / 2 + rng.randn() * noise_px
                y0 = min(feet[1], head[1]) + rng.randn() * noise_px
                if x0 + bw < 5 or x0 > w - 5 or y0 + bh < 5 or y0 > h - 5:
                    continue
                if k >= max_trackers:
                    break
                # staggered=True offsets each (person, camera)'s rotation
                # phase — the regime the real 2D stage produces (tracklet
                # caps expire per-tracklet, not globally), where re-seeded
                # tracks start as 1-camera combinations and the deferred
                # windows have genuine mistakes to revise
                phase = (p * 7 + c * 3) % rotation if staggered else 0
                ids[c, k] = (p * 10_000 + c * 100_000_000
                             + (t + phase) // rotation)
                boxes[c, k] = [x0, y0, bw, bh]
                mask[c, k] = True
                k += 1
            for _ in range(rng.poisson(fp_per_cam)):
                if k >= max_trackers:
                    break
                bh = rng.uniform(40, 120)
                ids[c, k] = next_fp_id
                next_fp_id += 1
                boxes[c, k] = [rng.uniform(0, w - 40),
                               rng.uniform(0, h - bh), 0.42 * bh, bh]
                mask[c, k] = True
                k += 1
        out.append((ids, boxes, mask))
    return out


def make_scenario(num_cameras: int = 4,
                  num_frames: int = 40,
                  num_people: int = 5,
                  image_size: Tuple[int, int] = (768, 576),
                  arena: float = 6000.0,
                  speed_mm: float = 280.0,
                  noise_px: float = 1.0,
                  fp_rate: float = 0.0,
                  fn_rate: float = 0.0,
                  enter_exit: bool = False,
                  seed: int = 0) -> SyntheticScenario:
    """Generate a full scenario with GT, detections and renderable frames."""
    rng = np.random.RandomState(seed)
    cams = ring_cameras(num_cameras, arena_radius=arena * 4.0 / 3.0,
                        image_size=image_size)
    gt = _random_walks(rng, num_frames, num_people, arena, speed_mm,
                       enter_exit)
    heights = rng.uniform(1550.0, 1900.0, size=num_people)

    w, h = image_size
    host_cams = [HostCamera(c) for c in cams]
    detections: List[List[np.ndarray]] = []
    for t in range(num_frames):
        per_cam = []
        for cam in host_cams:
            boxes = []
            for p in range(num_people):
                if np.isnan(gt[t, p, 0]):
                    continue
                if rng.rand() < fn_rate:
                    continue
                feet = cam.world_to_image(
                    np.asarray([gt[t, p, 0], gt[t, p, 1], 0.0]))
                head = cam.world_to_image(
                    np.asarray([gt[t, p, 0], gt[t, p, 1], heights[p]]))
                if not (np.isfinite(feet).all() and np.isfinite(head).all()):
                    continue
                bh = abs(feet[1] - head[1])
                bw = 0.42 * bh
                x0 = feet[0] - bw / 2 + rng.randn() * noise_px
                y0 = min(feet[1], head[1]) + rng.randn() * noise_px
                bh = bh + rng.randn() * noise_px
                # keep boxes that are mostly on screen
                if x0 + bw < 5 or x0 > w - 5 or y0 + bh < 5 or y0 > h - 5:
                    continue
                boxes.append([x0, y0, bw, bh])
            # false positives
            n_fp = rng.poisson(fp_rate) if fp_rate > 0 else 0
            for _ in range(n_fp):
                bh = rng.uniform(40, 120)
                boxes.append([rng.uniform(0, w - 40), rng.uniform(0, h - bh),
                              0.42 * bh, bh])
            per_cam.append(np.asarray(boxes, np.float32).reshape(-1, 4))
        detections.append(per_cam)

    # textures: per-person distinct colour + speckle; background speckle
    textures = np.zeros((num_people, 32, 16, 3), np.float32)
    for p in range(num_people):
        base = rng.rand(3) * 0.7 + 0.2
        speck = rng.rand(32, 16, 1) * 0.35
        textures[p] = np.clip(base[None, None] * (0.65 + speck), 0, 1)
    background = (rng.rand(h, w, 1) * 0.12 + 0.35).astype(np.float32)
    background = np.repeat(background, 3, axis=2)

    return SyntheticScenario(
        cameras=cams, num_frames=num_frames, num_people=num_people,
        image_size=image_size, gt_xy=gt, heights=heights,
        detections=detections, _textures=textures, _background=background)
