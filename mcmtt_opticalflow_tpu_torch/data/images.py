"""Frame ingest: JPEG/PNG decode + the reference's dataset frame layouts.

The reference grabs one JPEG per camera per frame with cv::imread
(ref psn_where/main.cpp:128-151):

  * PETS layout (PSN_INPUT_TYPE=1):  <root>/View_%03d/frame_%04d.jpg
  * ETRI layout (PSN_INPUT_TYPE=0):  <root>/%d_%d.jpg  (camID_frame)

Decoding uses PIL when present, else OpenCV, else PPM/PGM fallback (both
PIL and cv2 ship in this environment; the fallback keeps tests hermetic).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

try:
    from PIL import Image as _PILImage
except Exception:                                   # pragma: no cover
    _PILImage = None
try:
    import cv2 as _cv2
except Exception:                                   # pragma: no cover
    _cv2 = None


def read_image(path: str) -> np.ndarray:
    """Decode an image file to an RGB uint8 array [H, W, 3]."""
    if _PILImage is not None:
        with _PILImage.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    if _cv2 is not None:
        bgr = _cv2.imread(path, _cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        return bgr[..., ::-1].copy()
    return _read_ppm(path)


def write_image(path: str, rgb: np.ndarray) -> None:
    """Encode an RGB uint8 array to path (format from extension)."""
    rgb = np.ascontiguousarray(np.asarray(rgb, np.uint8))
    if path.endswith((".ppm", ".pgm")):
        _write_ppm(path, rgb)
        return
    if _PILImage is not None:
        _PILImage.fromarray(rgb).save(path)
        return
    if _cv2 is not None:                             # pragma: no cover
        _cv2.imwrite(path, rgb[..., ::-1])
        return
    raise RuntimeError("no image encoder available")  # pragma: no cover


def _read_ppm(path: str) -> np.ndarray:
    """Minimal binary PPM (P6) / PGM (P5) reader — dependency-free."""
    with open(path, "rb") as f:
        data = f.read()
    fields: List[bytes] = []
    i = 0
    while len(fields) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        fields.append(data[i:j])
        i = j
    magic, w, h = fields[0], int(fields[1]), int(fields[2])
    i += 1                                           # single whitespace
    pix = np.frombuffer(data, np.uint8, offset=i)
    if magic == b"P6":
        return pix[:w * h * 3].reshape(h, w, 3).copy()
    if magic == b"P5":
        g = pix[:w * h].reshape(h, w)
        return np.repeat(g[..., None], 3, -1)
    raise ValueError(f"{path}: unsupported magic {magic!r}")


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())


def frame_path(root: str, cam_id: int, frame_idx: int,
               layout: str = "pets") -> str:
    """Reference frame naming (ref main.cpp:137-143)."""
    if layout == "pets":
        return os.path.join(root, f"View_{cam_id:03d}",
                            f"frame_{frame_idx:04d}.jpg")
    return os.path.join(root, f"{cam_id}_{frame_idx}.jpg")


def find_frame(root: str, cam_id: int, frame_idx: int) -> Optional[str]:
    """Locate a frame file under either reference layout, any of the
    extensions we can decode.  None if absent."""
    stems = [os.path.join(root, f"View_{cam_id:03d}",
                          f"frame_{frame_idx:04d}"),
             os.path.join(root, f"{cam_id}_{frame_idx}")]
    for stem in stems:
        for ext in (".jpg", ".jpeg", ".png", ".ppm", ".pgm"):
            p = stem + ext
            if os.path.isfile(p):
                return p
    return None


class FrameSource:
    """Per-frame multi-camera image loader for dataset runs.

    Falls back to flat mid-gray frames (detections-only mode) for frames
    with no image files — with a one-time warning, unlike the reference
    which aborts on a missing frame (ref main.cpp:145-150)."""

    def __init__(self, root: str, cam_ids: Sequence[int], width: int,
                 height: int):
        self.root = root
        self.cam_ids = list(cam_ids)
        self.width = width
        self.height = height
        self._warned = False

    def __call__(self, frame_idx: int) -> np.ndarray:
        """[C, H, W, 3] uint8 RGB."""
        out = np.full((len(self.cam_ids), self.height, self.width, 3),
                      128, np.uint8)
        for i, cid in enumerate(self.cam_ids):
            p = find_frame(self.root, cid, frame_idx)
            if p is None:
                if not self._warned:
                    import sys
                    print(f"warning: no image for camera {cid} frame "
                          f"{frame_idx} under {self.root}; feeding flat "
                          "gray (detections-only mode)", file=sys.stderr)
                    self._warned = True
                continue
            img = read_image(p)
            if img.shape[:2] != (self.height, self.width):
                img = _resize_nn(img, self.height, self.width)
            out[i] = img
        return out


def _resize_nn(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] / h).astype(int)
    xs = (np.arange(w) * img.shape[1] / w).astype(int)
    return img[ys][:, xs]
