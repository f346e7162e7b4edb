"""Per-frame self times of the program's host stages.

The program's StageTimer (mcmtt_opticalflow_tpu_torch/utils/timing.py)
sums each named stage's wall seconds.  Stages nest without a parent link
(`branch.*` inside `assoc.branch`, `hyp.dispatch` inside
`assoc.hypotheses`), so a layer's self time is its stages' sum less the
stages nested in them that belong to another layer.
"""

from __future__ import annotations

from typing import Dict, Iterable


def stage_ms(totals: Dict[str, float], frames: int,
             names: Iterable[str]) -> float:
    """The stages' summed seconds over the window, as ms per frame."""
    if frames <= 0:
        raise ValueError("no frames in the window")
    return 1e3 * sum(totals.get(n, 0.0) for n in names) / frames


def self_ms(totals: Dict[str, float], frames: int, outer: Iterable[str],
            nested: Iterable[str]) -> float:
    """ms per frame of the `outer` stages less the `nested` stages that run
    inside them."""
    return stage_ms(totals, frames, outer) - stage_ms(totals, frames, nested)


def with_prefix(totals: Dict[str, float], prefix: str):
    """The stage names that start with `prefix`."""
    return [n for n in totals if n.startswith(prefix)]
