"""AVI video recording (host-side, no hard dependencies).

The reference records its visualisation to an MJPG AVI via OpenCV's
VideoWriter (ref psn_where/PSNWhere.cpp:206-231 + 301-477).  This writer
produces the same container directly: MJPG streams when a JPEG encoder
(PIL) is importable, otherwise uncompressed bottom-up BI_RGB ('DIB ')
frames — both are plain RIFF/AVI files any player opens.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def _jpeg_encode(rgb_u8: np.ndarray, quality: int = 90) -> Optional[bytes]:
    try:
        import io

        from PIL import Image
    except Exception:
        return None
    buf = io.BytesIO()
    Image.fromarray(rgb_u8, "RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class AviWriter:
    """Minimal single-video-stream AVI muxer.

    Frames are float RGB in [0, 1] or uint8 RGB; all frames must share
    one (H, W).  Close (or use as a context manager) to finalise the
    headers and index.
    """

    def __init__(self, path: str, fps: float = 7.0,
                 force_raw: bool = False):
        self.path = path
        self.fps = max(float(fps), 1.0)
        self.force_raw = force_raw
        self._frames: list[bytes] = []
        self._shape = None
        self._mjpg = None   # decided on the first frame

    def add(self, frame: np.ndarray) -> None:
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, -1)
        h, w = arr.shape[:2]
        if self._shape is None:
            self._shape = (h, w)
            enc = None if self.force_raw else _jpeg_encode(arr)
            self._mjpg = enc is not None
            if enc is not None:
                self._frames.append(enc)
                return
        assert (h, w) == self._shape, "frame size changed mid-stream"
        if self._mjpg:
            self._frames.append(_jpeg_encode(arr))
        else:
            # bottom-up BGR rows padded to 4 bytes (BI_RGB convention)
            bgr = arr[::-1, :, ::-1]
            row = w * 3
            pad = (-row) % 4
            if pad:
                bgr = np.concatenate(
                    [bgr.reshape(h, row),
                     np.zeros((h, pad), np.uint8)], axis=1)
            self._frames.append(bgr.tobytes())

    def close(self) -> None:
        h, w = self._shape if self._shape else (0, 0)
        n = len(self._frames)
        fourcc = b"MJPG" if self._mjpg else b"DIB "
        compression = 0x47504A4D if self._mjpg else 0  # 'MJPG' | BI_RGB
        usec = int(1_000_000 / self.fps)
        maxbuf = max((len(f) for f in self._frames), default=0)

        def chunk(tag: bytes, payload: bytes) -> bytes:
            if len(payload) % 2:
                payload += b"\0"
            return tag + struct.pack("<I", len(payload)) + payload

        avih = struct.pack("<14I", usec, maxbuf * int(self.fps), 0,
                           0x10,  # AVIF_HASINDEX
                           n, 0, 1, maxbuf, w, h, 0, 0, 0, 0)
        strh = (b"vids" + fourcc
                + struct.pack("<10I4H", 0, 0, 0, 1, int(self.fps), 0, n,
                              maxbuf, 0xFFFFFFFF, 0, 0, 0, w, h))
        strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, compression,
                           w * h * 3, 0, 0, 0, 0)
        strl = chunk(b"LIST", b"strl" + chunk(b"strh", strh)
                     + chunk(b"strf", strf))
        hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + strl)

        movi_payload = b"movi"
        offsets = []
        for f in self._frames:
            offsets.append(len(movi_payload))
            movi_payload += chunk(b"00dc", f)
        movi = chunk(b"LIST", movi_payload)

        idx = b""
        for off, f in zip(offsets, self._frames):
            idx += b"00dc" + struct.pack("<3I", 0x10, off, len(f))
        idx1 = chunk(b"idx1", idx)

        body = b"AVI " + hdrl + movi + idx1
        with open(self.path, "wb") as fh:
            fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_avi_frame_count(path: str) -> int:
    """Cheap sanity probe: frame count from the avih header."""
    with open(path, "rb") as fh:
        data = fh.read(256)
    i = data.find(b"avih")
    assert i > 0, "not an AVI produced by AviWriter"
    return struct.unpack("<I", data[i + 8 + 16:i + 8 + 20])[0]
