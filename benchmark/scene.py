"""The benchmark's traffic generator: a periodic multi-camera scene.

A frozen copy of mcmtt_opticalflow_tpu_torch/data/synthetic.py at commit
052b569610a6 (`ring_cameras`, the renderer, the detection model), with one
change: every person walks a smooth closed loop on the ground plane with
period P frames, so images, ground truth and detections repeat every P
frames.  P frames rendered once then serve a window of any length at any
speed: frame t of the stream is frame (t + o) mod P of the scene, with the
offset o drawn from the seed.

The walk is the mix's: the loops, the heights and the exits and
re-entries come from the traffic file's `layout_seed`, so that every run
of a cell does the same work.  The run's seed (numpy's PCG64, which takes
any whole number) draws the rest: where in the period the stream starts,
the looks, the detection noise, the misses and the false positives.  The
mix's numbers come from a traffic file (benchmark/traffic/<name>.json):

    layout_seed   the seed of the walk
    period        P, frames of one loop
    people        people in the scene
    arena_mm      half-width of the square arena
    speed_mm      the largest step of a walker, mm a frame
    reentry_share share of the people who leave and re-enter once a period
    noise_px      detection box noise, px (standard deviation)
    fp_rate       false positives per camera and frame (Poisson mean)
    fn_rate       chance that a visible person is missed in one camera
    cameras, image_size come from the configuration.

Each camera's images are uint8 [P, H, W, 3]; the program and the reference
get the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from reference.tsai import TsaiCamera
from reference.tsai_np import HostCamera


def ring_camera_params(num_cameras: int, arena_radius: float,
                       camera_height: float = 5500.0,
                       image_size: Tuple[int, int] = (768, 576),
                       focal: float = 8.0,
                       kappa1: float = 1e-9) -> List[dict]:
    """Tsai parameters of cameras on a ring looking at the arena centre,
    as keyword arguments of `TsaiCamera.create` (synthetic.ring_cameras)."""
    w, h = image_size
    out = []
    for i in range(num_cameras):
        ang = 2.0 * np.pi * i / num_cameras + 0.35
        c = np.asarray([arena_radius * 1.6 * np.cos(ang),
                        arena_radius * 1.6 * np.sin(ang),
                        camera_height])
        look = np.asarray([0.0, 0.0, 800.0])
        fwd = look - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        down /= np.linalg.norm(down)
        rot = np.stack([right, down, fwd])
        t = -rot @ c
        out.append(dict(
            width=w, height=h, dpx=0.0083, dpy=0.0083, focal=focal,
            kappa1=kappa1, cx=w / 2.0, cy=h / 2.0, sx=1.0,
            tx=float(t[0]), ty=float(t[1]), tz=float(t[2]),
            rx=float(np.arctan2(rot[2, 1], rot[2, 2])),
            ry=float(np.arcsin(-rot[2, 0])),
            rz=float(np.arctan2(rot[1, 0], rot[0, 0]))))
    return out


@dataclasses.dataclass
class Scene:
    period: int
    offset: int                    # scene frame of the stream's frame 0
    camera_params: List[dict]      # TsaiCamera.create keyword arguments
    gt_xy: np.ndarray              # [P, people, 2] mm; nan = absent
    heights: np.ndarray            # [people] mm
    detections: List[List[np.ndarray]]   # [P][C] -> [K, 4] (x, y, w, h)
    images: np.ndarray             # [P, C, H, W, 3] uint8

    def frame(self, t: int):
        """Frame t of the stream: (images [C, H, W, 3], detections)."""
        i = (t + self.offset) % self.period
        return self.images[i], self.detections[i]

    def gt_matrices(self, frames: int) -> Tuple[np.ndarray, np.ndarray]:
        """X, Y matrices [frames, people] of the stream's first `frames`
        frames, 0.0 for absent (the CLEAR-MOT scorer's layout)."""
        idx = (np.arange(frames) + self.offset) % self.period
        xy = self.gt_xy[idx]
        return (np.where(np.isnan(xy[..., 0]), 0.0, xy[..., 0]),
                np.where(np.isnan(xy[..., 1]), 0.0, xy[..., 1]))


def _loops(rng, period: int, people: int, arena: float, speed: float):
    """[P, people, 2] smooth closed paths inside the arena: two harmonics
    of the period around a centre, scaled so that no step exceeds
    `speed`."""
    t = np.arange(period)[:, None]
    w = 2.0 * np.pi / period
    xy = np.zeros((period, people, 2))
    for p in range(people):
        amp1 = rng.uniform(0.25, 0.5) * arena
        amp2 = rng.uniform(0.0, 0.25) * amp1
        ph = rng.uniform(0.0, 2.0 * np.pi, size=4)
        squash = rng.uniform(0.4, 1.0)
        rot = rng.uniform(0.0, np.pi)
        u = amp1 * np.cos(w * t[:, 0] + ph[0]) + amp2 * np.cos(
            2 * w * t[:, 0] + ph[1])
        v = squash * (amp1 * np.sin(w * t[:, 0] + ph[0])
                      + amp2 * np.sin(2 * w * t[:, 0] + ph[2]))
        path = np.stack([u * np.cos(rot) - v * np.sin(rot),
                         u * np.sin(rot) + v * np.cos(rot)], -1)
        step = np.max(np.linalg.norm(np.roll(path, -1, 0) - path, axis=-1))
        if step > speed:
            path *= speed / step
        span = np.max(np.abs(path), axis=0)
        room = np.maximum(arena - span, 0.0)
        centre = rng.uniform(-room, room)
        xy[:, p] = path + centre
    return xy


def make_scene(traffic: dict, num_cameras: int, image_size: Tuple[int, int],
               seed: int) -> Scene:
    """The periodic scene of a traffic mix (see the module docstring)."""
    walk = np.random.default_rng(int(traffic["layout_seed"]))
    rng = np.random.default_rng(seed)
    period = int(traffic["period"])
    people = int(traffic["people"])
    arena = float(traffic["arena_mm"])
    noise_px = float(traffic["noise_px"])
    fp_rate, fn_rate = float(traffic["fp_rate"]), float(traffic["fn_rate"])
    params = ring_camera_params(num_cameras, arena * 4.0 / 3.0,
                                image_size=image_size)
    host_cams = [HostCamera(TsaiCamera.create(**p)) for p in params]
    gt = _loops(walk, period, people, arena, float(traffic["speed_mm"]))
    # a share of the people leave and come back once a period
    n_out = int(round(float(traffic["reentry_share"]) * people))
    for p in walk.choice(people, size=n_out, replace=False):
        gone = int(walk.integers(period // 8, period // 4))
        start = int(walk.integers(0, period))
        gt[(start + np.arange(gone)) % period, p] = np.nan
    heights = walk.uniform(1550.0, 1900.0, size=people)
    offset = int(rng.integers(0, period))

    w, h = image_size
    detections: List[List[np.ndarray]] = []
    for t in range(period):
        per_cam = []
        for cam in host_cams:
            boxes = []
            for p in range(people):
                if np.isnan(gt[t, p, 0]) or rng.random() < fn_rate:
                    continue
                feet = cam.world_to_image(
                    np.asarray([gt[t, p, 0], gt[t, p, 1], 0.0]))
                head = cam.world_to_image(
                    np.asarray([gt[t, p, 0], gt[t, p, 1], heights[p]]))
                if not (np.isfinite(feet).all() and np.isfinite(head).all()):
                    continue
                bh = abs(feet[1] - head[1])
                bw = 0.42 * bh
                x0 = feet[0] - bw / 2 + rng.standard_normal() * noise_px
                y0 = min(feet[1], head[1]) + rng.standard_normal() * noise_px
                bh = bh + rng.standard_normal() * noise_px
                if x0 + bw < 5 or x0 > w - 5 or y0 + bh < 5 or y0 > h - 5:
                    continue
                boxes.append([x0, y0, bw, bh])
            for _ in range(rng.poisson(fp_rate) if fp_rate > 0 else 0):
                bh = rng.uniform(40, 120)
                boxes.append([rng.uniform(0, w - 40), rng.uniform(0, h - bh),
                              0.42 * bh, bh])
            per_cam.append(np.asarray(boxes, np.float32).reshape(-1, 4))
        detections.append(per_cam)

    textures = np.zeros((people, 32, 16, 3), np.float32)
    for p in range(people):
        base = rng.random(3) * 0.7 + 0.2
        speck = rng.random((32, 16, 1)) * 0.35
        textures[p] = np.clip(base[None, None] * (0.65 + speck), 0, 1)
    background = (rng.random((h, w, 1)) * 0.12 + 0.35).astype(np.float32)
    to_u8 = (lambda x: (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8))
    tex_u8 = to_u8(textures)
    bg_u8 = np.repeat(to_u8(background), 3, axis=2)
    images = np.empty((period, num_cameras, h, w, 3), np.uint8)
    for t in range(period):
        for c, cam in enumerate(host_cams):
            _render(images[t, c], bg_u8, tex_u8, gt[t], heights, cam)
    return Scene(period, offset, params, gt, heights, detections, images)


def _render(out, background, textures, xy_t, heights, cam) -> None:
    """One camera's image of one frame into `out` [H, W, 3] uint8: the
    background, then each present person as a textured box stretched over
    their full body, the farthest first (synthetic.render_frame)."""
    h, w = out.shape[:2]
    out[:] = background
    order = []
    for p in range(len(heights)):
        if np.isnan(xy_t[p, 0]):
            continue
        feet = cam.world_to_image(np.asarray([xy_t[p, 0], xy_t[p, 1], 0.0]))
        head = cam.world_to_image(
            np.asarray([xy_t[p, 0], xy_t[p, 1], heights[p]]))
        order.append((feet[1], p, feet, head))
    order.sort()
    for _, p, feet, head in order:
        bh = abs(feet[1] - head[1])
        bw = 0.42 * bh
        x0 = int(round(feet[0] - bw / 2))
        y0 = int(round(min(feet[1], head[1])))
        x1 = int(round(feet[0] + bw / 2))
        y1 = int(round(max(feet[1], head[1])))
        x0c, y0c, x1c, y1c = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
        if x1c <= x0c or y1c <= y0c:
            continue
        tex = textures[p]
        th, tw = tex.shape[:2]
        yy = ((np.arange(y0c, y1c) - y0) * (th - 1)
              / max(y1 - y0, 1)).astype(int)
        xx = ((np.arange(x0c, x1c) - x0) * (tw - 1)
              / max(x1 - x0, 1)).astype(int)
        out[y0c:y1c, x0c:x1c] = tex[yy[:, None], xx[None, :]]
