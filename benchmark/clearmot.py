# Frozen copy of mcmtt_opticalflow_tpu_torch/eval/clearmot.py at commit 052b569610a6:
# the CLEAR-MOT scorer the benchmark prints beside its result.
"""CLEAR-MOT evaluation, a faithful port of the reference's CEvaluator
(psn_where/Evaluator.cpp:236-695, itself a MATLAB CLEAR_MOT.m port).

Semantics preserved:
  * temporal match inheritance within the 1000 mm radius (ref :423-465)
  * greedy global-min-distance GT<->estimate matching          (ref :467-532)
  * ID switches counted against the last non-empty mapping     (ref :534-551)
  * boundary-aware FP discounting with inner/outer crop zones  (ref :570-598)
  * MOTA / MOTP / MOTAL / recall / precision / FAR             (ref :605-623)
  * MT / PT / ML thresholds 0.8 / 0.2                          (ref :625-660)
  * fragments                                                  (ref :662-692)

The 0.0-coordinate-means-absent convention of the reference's matrices is
kept so its ground-truth files evaluate identically.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class EvaluationResult:
    mota: float = 0.0
    motp: float = 0.0
    motal: float = 0.0
    recall: float = 0.0
    precision: float = 0.0
    missed: int = 0
    false_positives: int = 0
    id_switches: int = 0
    most_tracked: int = 0
    partially_tracked: int = 0
    most_lost: int = 0
    fragments: int = 0
    far: float = 0.0
    miss_per_gt: float = 0.0
    fa_per_gt: float = 0.0

    def summary(self) -> str:
        """One-line PETS-style report (ref PrintResultToConsole,
        Evaluator.cpp:1084-1105)."""
        return (f"MOTA={self.mota:.4f} MOTP={self.motp:.4f} "
                f"MOTAL={self.motal:.4f} Rcll={self.recall:.4f} "
                f"Prcn={self.precision:.4f} FAR={self.far:.4f} "
                f"MT={self.most_tracked} PT={self.partially_tracked} "
                f"ML={self.most_lost} FP={self.false_positives} "
                f"FN={self.missed} IDs={self.id_switches} "
                f"FM={self.fragments}")

    def report(self) -> str:
        """The reference's result-file text, byte-layout compatible
        (ref PrintResultToFile, Evaluator.cpp:1107-1137)."""
        err = self.missed + self.false_positives + self.id_switches
        return (
            "Evaluating PETS on ground plane...\n"
            "| Recl Prcn  FAR| MT PT ML|  FPR  FNR  FP  FN  ID  FM  err|"
            " MOTA MOTP MOTL\n"
            "|%5.1f%5.1f%5.2f|%3i%3i%3i|%5.1f%5.1f%4i%4i%4i%4i%5i|"
            "%5.1f %4.1f %4.1f\n" % (
                self.recall * 100, self.precision * 100, self.far,
                self.most_tracked, self.partially_tracked, self.most_lost,
                self.fa_per_gt * 100, self.miss_per_gt * 100,
                self.false_positives, self.missed, self.id_switches,
                self.fragments, err,
                self.mota * 100, self.motp * 100, self.motal * 100))

    def save(self, path: str) -> None:
        """Write the reference's per-(K, window) evaluation file
        (ref Associator3D.cpp:375-377 + Evaluator.cpp:1107-1137)."""
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.report())


class ClearMotAccumulator:
    """Accumulates per-frame (track_id, x, y) results keyed by a stable id
    (the reference keys by tree id, ref SetResult Evaluator.cpp:119-151),
    then evaluates against GT X/Y matrices."""

    def __init__(self, gt_x: np.ndarray, gt_y: np.ndarray,
                 crop_zone: Tuple[float, float, float, float],
                 crop_margin: float = 1000.0):
        self.gt_x = np.asarray(gt_x, np.float64)
        self.gt_y = np.asarray(gt_y, np.float64)
        self.crop_zone = crop_zone
        self.margin = crop_margin
        self.num_time = self.gt_x.shape[0]
        self._ids: List[int] = []
        self._frames: List[List[Tuple[int, float, float]]] = [
            [] for _ in range(self.num_time)]
        self._num_saved = 0

    def _zone_contains(self, x, y, margin=0.0):
        x0, y0, x1, y1 = self.crop_zone
        return (x0 - margin <= x < x1 + margin) and (y0 - margin <= y < y1 + margin)

    def set_result(self, time_idx: int,
                   entries: Sequence[Tuple[int, float, float]]) -> None:
        """Record results for a frame: iterable of (stable_id, x, y).
        Points outside the margin-extended crop zone are dropped
        (ref Evaluator.cpp:132-134)."""
        if time_idx >= self.num_time:
            return
        frame = []
        for sid, x, y in entries:
            if not self._zone_contains(x, y, self.margin):
                continue
            if sid not in self._ids:
                self._ids.append(sid)
            frame.append((self._ids.index(sid), float(x), float(y)))
        self._frames[time_idx] = frame
        self._num_saved = max(self._num_saved, time_idx + 1)

    def save_result_matrix(self, path: str) -> None:
        """Write the accumulated X/Y result matrices in the reference's
        offline re-scoring format (ref PrintResultMatrix /
        LoadResultFromText, Evaluator.cpp:153-234, 1144+)."""
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n = max(len(self._ids), 1)
        f = self._num_saved
        x = np.zeros((f, n))
        y = np.zeros((f, n))
        for t in range(f):
            for idx, px, py in self._frames[t]:
                x[t, idx] = px
                y[t, idx] = py
        with open(path, "w") as fh:
            fh.write(f"MatX:({f},{n})\n")
            for row in x:
                fh.write(",".join(f"{v:.4f}" for v in row) + ",\n")
            fh.write(f"MatY:({f},{n})\n")
            for row in y:
                fh.write(",".join(f"{v:.4f}" for v in row) + ",\n")

    def load_result_matrix(self, path: str) -> None:
        """Load results saved by save_result_matrix (offline re-scoring,
        ref LoadResultFromText Evaluator.cpp:153-234)."""
        import re

        text = open(path).read()
        m = re.search(r"MatX:\((\d+),(\d+)\)", text)
        f, n = int(m.group(1)), int(m.group(2))
        my = re.search(r"MatY:\((\d+),(\d+)\)", text)
        xs_text = text[m.end():my.start()]
        ys_text = text[my.end():]

        def parse(block):
            rows = []
            for line in block.strip().splitlines():
                vals = [float(v) for v in line.split(",") if v.strip()]
                rows.append(vals)
            return np.asarray(rows).reshape(f, n)

        x, y = parse(xs_text), parse(ys_text)
        self._ids = list(range(n))
        self._frames = [[] for _ in range(self.num_time)]
        for t in range(min(f, self.num_time)):
            for j in range(n):
                if x[t, j] != 0.0 or y[t, j] != 0.0:
                    self._frames[t].append((j, float(x[t, j]),
                                            float(y[t, j])))
        self._num_saved = f

    def evaluate(self) -> EvaluationResult:
        num_est = len(self._ids)
        f = self._num_saved
        if f == 0:
            return EvaluationResult()
        # result matrices incl. margin-zone points (matX_b) and inner-cropped
        x_b = np.zeros((f, max(num_est, 1)))
        y_b = np.zeros((f, max(num_est, 1)))
        x_m = np.zeros_like(x_b)       # crop-zone-only (the reference's matX)
        y_m = np.zeros_like(y_b)
        x_ic = np.zeros_like(x_b)      # inner crop (margin inside)
        x0, y0, x1, y1 = self.crop_zone
        for t in range(f):
            for idx, x, y in self._frames[t]:
                x_b[t, idx], y_b[t, idx] = x, y
                if self._zone_contains(x, y):
                    x_m[t, idx], y_m[t, idx] = x, y
                    if (x0 + self.margin <= x < x1 - self.margin
                            and y0 + self.margin <= y < y1 - self.margin):
                        x_ic[t, idx] = x
        gt_x, gt_y = self.gt_x[:f], self.gt_y[:f]
        # drop GT columns that are entirely absent in the window (ref :356-374)
        keep = (np.count_nonzero(gt_x, axis=0) > 0) \
            & (np.count_nonzero(gt_y, axis=0) > 0)
        gt_x, gt_y = gt_x[:, keep], gt_y[:, keep]
        return evaluate_clear_mot(gt_x, gt_y, x_m, y_m, x_b, y_b, x_ic,
                                  self.margin)


def evaluate_clear_mot(gt_x, gt_y, x, y, x_b=None, y_b=None, x_ic=None,
                       margin: float = 1000.0) -> EvaluationResult:
    """Evaluate CLEAR-MOT given [T, N] coordinate matrices (0 = absent)."""
    f, ngt = gt_x.shape
    n = x.shape[1]
    if x_b is None:
        x_b, y_b = x, y
    if x_ic is None:
        x_ic = x
    res = EvaluationResult()
    if n == 0 or ngt == 0:
        res.missed = int(np.count_nonzero(gt_x))
        res.most_lost = ngt
        res.miss_per_gt = 1.0
        return res

    m_map = np.full((f, ngt), -1, np.int64)
    mme = np.zeros(f, int)
    c = np.zeros(f, int)
    fp = np.zeros(f, int)
    g = np.zeros(f, int)
    d = np.zeros((f, ngt))

    for t in range(f):
        g[t] = np.count_nonzero(gt_x[t])

        # -- temporal inheritance (ref :423-465)
        if t > 0:
            for j in range(ngt):
                e = m_map[t - 1, j]
                if e < 0:
                    continue
                gx, gy = gt_x[t, j], gt_y[t, j]
                if gx == 0.0 or gy == 0.0:
                    continue
                if x[t, e] != 0.0:
                    ex, ey = x[t, e], y[t, e]
                else:
                    ex, ey = x_b[t, e], y_b[t, e]
                if ex == 0.0 or ey == 0.0:
                    continue
                if np.hypot(gx - ex, gy - ey) > margin:
                    continue
                m_map[t, j] = e

        # -- greedy min-distance matching (ref :467-532)
        while True:
            gts = [j for j in range(ngt)
                   if m_map[t, j] < 0 and gt_x[t, j] != 0.0]
            used = set(m_map[t][m_map[t] >= 0])
            es = [e for e in range(n) if x[t, e] != 0.0 and e not in used]
            if not gts or not es:
                break
            gx = gt_x[t, gts][:, None]
            gy = gt_y[t, gts][:, None]
            ex = x[t, es][None, :]
            ey = y[t, es][None, :]
            dist = np.hypot(gx - ex, gy - ey)
            jj, ee = np.unravel_index(np.argmin(dist), dist.shape)
            if dist[jj, ee] > margin:
                break
            m_map[t, gts[jj]] = es[ee]

        # -- matches / id switches / distances (ref :534-568)
        for j in range(ngt):
            e = m_map[t, j]
            if e < 0:
                continue
            c[t] += 1
            if t > 0:
                last = -1
                for tt in range(t):
                    if m_map[tt, j] >= 0:
                        last = tt
                if gt_x[t - 1, j] != 0.0 and last >= 0 \
                        and m_map[t, j] != m_map[last, j]:
                    mme[t] += 1
            if x[t, e] != 0.0:
                ex, ey = x[t, e], y[t, e]
            else:
                ex, ey = x_b[t, e], y_b[t, e]
            d[t, j] = np.hypot(gt_x[t, j] - ex, gt_y[t, j] - ey)

        # -- false positives with boundary discount (ref :570-598)
        used = set(m_map[t][m_map[t] >= 0])
        for e in range(n):
            if x[t, e] == 0.0 or e in used:
                continue
            fp[t] += 1
            if x_ic[t, e] != 0.0:
                continue
            # connectivity check: drop isolated boundary points
            if t == 0 and t < f - 1:
                if x[t + 1, e] == 0.0:
                    continue
            elif t < f - 1:
                if x[t - 1, e] == 0.0 and x[t + 1, e] == 0.0:
                    continue
            elif x[t - 1, e] == 0.0:
                continue
            fp[t] -= 1

    miss = g - c
    sum_c, sum_g = c.sum(), g.sum()
    sum_m, sum_fp, sum_mme = miss.sum(), fp.sum(), mme.sum()
    res.missed = int(sum_m)
    res.false_positives = int(sum_fp)
    res.id_switches = int(sum_mme)
    if sum_c > 0:
        res.motp = 1.0 - d.sum() / (sum_c * margin)
    if sum_g > 0:
        res.mota = 1.0 - (sum_m + sum_fp + sum_mme) / sum_g
        res.motal = 1.0 - (sum_m + sum_fp + np.log10(sum_mme + 1)) / sum_g
        res.recall = sum_c / sum_g
        res.miss_per_gt = sum_m / sum_g
        res.fa_per_gt = sum_fp / sum_g
    if sum_fp + sum_c > 0:
        res.precision = sum_c / (sum_fp + sum_c)
    res.far = sum_fp / f

    # MT / PT / ML (ref :625-660)
    for j in range(ngt):
        present = gt_x[:, j] != 0.0
        get_len = present.sum()
        if get_len == 0:
            continue
        tracked = ((m_map[:, j] >= 0) & present).sum()
        ratio = tracked / get_len
        if ratio < 0.2:
            res.most_lost += 1
        elif ratio >= 0.8:
            res.most_tracked += 1
        else:
            res.partially_tracked += 1

    # fragments (ref :662-692)
    for j in range(ngt):
        tracked = m_map[:, j] >= 0
        if not tracked.any():
            continue
        # count tracked->untracked transitions, excluding the trailing gap
        trans = int(np.sum(tracked[:-1] & ~tracked[1:]))
        last = np.where(tracked)[0][-1]
        if last == f - 1:
            pass
        else:
            trans -= 1
        res.fragments += max(trans, 0)
    return res
