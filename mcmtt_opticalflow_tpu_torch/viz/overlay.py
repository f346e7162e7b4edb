"""Host-side result visualisation (numpy, no GUI dependency).

Covers the reference's Visualize path: per-camera overlays of detections /
tracklet boxes / reprojected 3D tracks, 2x2 frame tiling, and a top-view
trajectory rendering (ref psn_where/PSNWhere.cpp:301-477, drawing helpers
PSNWhere_Utils.cpp:647-892).  Output frames are float RGB arrays; save_ppm
writes them without external imaging libraries.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from mcmtt_opticalflow_tpu_torch.utils.colors import generate_colors


def draw_box(img: np.ndarray, box, color, thickness: int = 1) -> None:
    """In-place rectangle on [H, W, 3] image; box = (x, y, w, h)."""
    h, w, _ = img.shape
    x0, y0 = int(max(box[0], 0)), int(max(box[1], 0))
    x1 = int(min(box[0] + box[2], w - 1))
    y1 = int(min(box[1] + box[3], h - 1))
    if x1 <= x0 or y1 <= y0:
        return
    t = thickness
    img[y0:y0 + t, x0:x1] = color
    img[max(y1 - t, 0):y1, x0:x1] = color
    img[y0:y1, x0:x0 + t] = color
    img[y0:y1, max(x1 - t, 0):x1] = color


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """In-place line segment on [H, W, 3] (integer DDA, numpy only)."""
    h, w, _ = img.shape
    x0, y0, x1, y1 = float(p0[0]), float(p0[1]), float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1.0))
    ts = np.linspace(0.0, 1.0, n + 1)
    xs = np.clip((x0 + (x1 - x0) * ts).astype(int), 0, w - 1)
    ys = np.clip((y0 + (y1 - y0) * ts).astype(int), 0, h - 1)
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[inb], xs[inb]] = color


def draw_flow_vectors(img: np.ndarray, feats: np.ndarray,
                      feat_valid: np.ndarray, flow: np.ndarray,
                      color=(1.0, 1.0, 0.0)) -> np.ndarray:
    """Copy of img with a KLT motion vector per valid feature point (the
    reference draws prev->curr optical-flow lines over each camera view,
    ref PSNWhere.cpp:301-477 + Tracker2D display, Tracker2D.cpp:318-368).

    feats [N, 2] current feature positions, feat_valid [N], flow [N, 2]
    (or [2], broadcast) displacement since the previous frame: vectors run
    from feat - flow to feat, with a 2x2 head mark at the current point.
    """
    out = np.asarray(img).copy()
    feats = np.asarray(feats, float).reshape(-1, 2)
    flow = np.broadcast_to(np.asarray(flow, float), feats.shape)
    col = np.asarray(color, out.dtype)
    h, w, _ = out.shape
    for p, f, ok in zip(feats, flow, np.asarray(feat_valid).reshape(-1)):
        if not ok:
            continue
        draw_line(out, p - f, p, col)
        y, x = int(p[1]), int(p[0])
        if 0 <= y < h and 0 <= x < w:
            out[max(y - 1, 0):y + 1, max(x - 1, 0):x + 1] = col
    return out


def draw_overlay(frame: np.ndarray, boxes, ids,
                 colors: Optional[np.ndarray] = None) -> np.ndarray:
    """Copy of frame with id-coloured boxes."""
    out = np.asarray(frame).copy()
    if colors is None:
        colors = generate_colors(256)
    for box, i in zip(boxes, ids):
        draw_box(out, box, colors[int(i) % len(colors)])
    return out


def draw_result_trajectories(frame: np.ndarray, result, cam_idx: int,
                             colors: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """Overlay one camera view with every tracked object's recent
    trajectory reprojection, coloured by its reusable visualization id
    (ref CPSNWhere::Visualize 3D-track pass, PSNWhere.cpp:301-477 +
    the recentPoint2Ds payload filled by ResultWithTracks,
    Associator3D.cpp:3131-3165).  `result` is a Track3DResult."""
    out = np.asarray(frame).copy()
    if colors is None:
        colors = generate_colors(256)
    vis = result.vis_ids or result.ids
    for obj, v in zip(result.recent_proj, vis):
        col = colors[int(v) % len(colors)]
        traj = obj[cam_idx]
        for a, b in zip(traj[:-1], traj[1:]):
            draw_line(out, a, b, col)
    return out


def draw_top_view(points_by_frame: Sequence[np.ndarray],
                  ids_by_frame: Sequence[Sequence[int]],
                  extent: float = 8000.0, size: int = 512,
                  trail: int = 40) -> np.ndarray:
    """Ground-plane trajectory rendering (ref SHOW_TOPVIEW path,
    PSNWhere.cpp:301-477); keeps the last `trail` frames like
    DISP_TRAJECTORY3D_LENGTH (ref PSNWhere_Defines.h:76)."""
    img = np.full((size, size, 3), 0.1, np.float32)
    colors = generate_colors(256)
    start = max(0, len(points_by_frame) - trail)
    for t in range(start, len(points_by_frame)):
        fade = 0.3 + 0.7 * (t - start + 1) / (len(points_by_frame) - start)
        for p, i in zip(points_by_frame[t], ids_by_frame[t]):
            u = int((p[0] / extent * 0.5 + 0.5) * (size - 1))
            v = int((p[1] / extent * 0.5 + 0.5) * (size - 1))
            if 0 <= u < size and 0 <= v < size:
                img[max(v - 1, 0):v + 2, max(u - 1, 0):u + 2] = \
                    colors[int(i) % 256] * fade
    return img


def tile_frames(frames: Sequence[np.ndarray], cols: int = 2) -> np.ndarray:
    """2x2-style tiling of camera views (ref PSNWhere.cpp display tiling)."""
    frames = [np.asarray(f) for f in frames]
    h, w, c = frames[0].shape
    rows = (len(frames) + cols - 1) // cols
    out = np.zeros((rows * h, cols * w, c), frames[0].dtype)
    for i, f in enumerate(frames):
        r, cc = divmod(i, cols)
        out[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = f
    return out


def save_ppm(path: str, img: np.ndarray) -> None:
    """Write a float [0,1] RGB image as binary PPM (no deps)."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr.tobytes())
