"""Structured logging (replaces psn::printLog append-only text logs,
ref psn_where/PSNWhere_Utils.cpp:921 and the PSN_DEBUG/MONITOR gates,
PSNWhere_Defines.h:16-18)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def get_logger(name: str = "mcmtt") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("MCMTT_LOG_LEVEL", "INFO"))
    return logger


class FrameLog:
    """Append-only JSONL per-frame metrics log."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def write(self, frame_idx: int, **fields: Any) -> None:
        if self._f is None:
            return
        rec: Dict[str, Any] = {"t": time.time(), "frame": frame_idx}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
