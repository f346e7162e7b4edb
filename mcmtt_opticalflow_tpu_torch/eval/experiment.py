"""Experiment runner: K-sweep x repeats with deferred-window evaluation.

The reference's driver loop (ref psn_where/main.cpp:103-172) sweeps the
solver's K over SIZE_OF_KS x NUM_EXPERIMENTS repeats, and its associator
feeds 11 deferred-output evaluators (windows 0..10,
ref PSNWhere_Associator3D.cpp:282-286, 507-512).  This module reproduces
that harness over any scenario source.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mcmtt_opticalflow_tpu_torch.config import EngineConfig
from mcmtt_opticalflow_tpu_torch.eval.clearmot import (ClearMotAccumulator,
                                                       EvaluationResult)
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine


@dataclasses.dataclass
class ExperimentResult:
    k: int
    repeat: int
    per_window: Dict[int, EvaluationResult]
    fps: float


def run_sequence(engine: TrackingEngine, frames_fn, detections_fn,
                 num_frames: int,
                 gt: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 crop_zone=None, crop_margin: float = 1000.0,
                 deferred_windows: int = 11) -> Dict[int, EvaluationResult]:
    """Run one sequence, evaluating at every deferred-output window size
    like the reference (window w scores frame t-w using the current best
    hypothesis at t)."""
    accs = None
    if gt is not None:
        gx, gy = gt
        accs = [ClearMotAccumulator(gx, gy, crop_zone, crop_margin)
                for _ in range(deferred_windows)]

    def harvest(t_done: int) -> None:
        for w in range(deferred_windows):
            td = t_done - w
            if td < 0:
                continue
            r = engine.deferred_result(td)
            accs[w].set_result(
                td, [(i, p[0], p[1]) for i, p in zip(r.ids, r.points)])

    # a pipelined engine's association trails its input by one or more
    # frames: harvest at the associator's COMPLETED frame (its applied
    # hypothesis solve), not the input frame, and drain the pipeline tail
    # with flush()
    last_done = -1

    def _completed() -> int:
        a = engine.assoc
        return getattr(a, "completed_frame", a.frame_idx)

    def catch_up() -> None:
        nonlocal last_done
        while accs is not None and last_done < _completed():
            last_done += 1
            harvest(last_done)

    for t in range(num_frames):
        engine.process_frame(frames_fn(t), detections_fn(t), frame_idx=t)
        catch_up()
    if hasattr(engine, "flush"):
        while engine.flush() is not None:
            catch_up()
    if accs is None:
        return {}
    # finalize-time backfill: window w has only scored frames up to
    # last_done - w; re-score the remaining tail with the FINAL best
    # hypothesis so every window covers every frame (the reference's
    # Finalize does exactly this sweep, ref Associator3D.cpp:364-372)
    for w in range(deferred_windows):
        for td in range(max(last_done - w + 1, 0), last_done + 1):
            r = engine.deferred_result(td)
            accs[w].set_result(
                td, [(i, p[0], p[1]) for i, p in zip(r.ids, r.points)])
    return {w: accs[w].evaluate() for w in range(deferred_windows)}


def k_sweep(make_engine: Callable[[int], TrackingEngine],
            frames_fn, detections_fn, num_frames: int,
            gt, crop_zone, ks: Sequence[int] = (1, 5, 10),
            num_experiments: int = 1,
            deferred_windows: int = 11,
            result_dir: Optional[str] = None,
            tag: str = "run") -> List[ExperimentResult]:
    """K-sweep x repeats (ref main.cpp:103-106).

    result_dir: when set, every (K, window) evaluation is written to
    `{result_dir}/K{K:03d}/{tag}_evaluation_K{K:03d}_W{W:03d}.txt` in the
    reference's file layout and text format (ref Associator3D.cpp:357-377
    + Evaluator.cpp:1107-1137)."""
    import os
    import time

    out = []
    for k in ks:
        for rep in range(num_experiments):
            eng = make_engine(k)
            t0 = time.perf_counter()
            per_window = run_sequence(eng, frames_fn, detections_fn,
                                      num_frames, gt, crop_zone,
                                      deferred_windows=deferred_windows)
            dt = time.perf_counter() - t0
            if result_dir is not None:
                for w, res in per_window.items():
                    res.save(os.path.join(
                        result_dir, "K%03d" % k,
                        "%s_evaluation_K%03d_W%03d.txt" % (tag, k, w)))
            out.append(ExperimentResult(
                k=k, repeat=rep, per_window=per_window,
                fps=num_frames / dt))
    return out
