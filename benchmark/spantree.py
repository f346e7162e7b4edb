"""The program's span tree, as the span metrics read it.

`exported()` is mcmtt_opticalflow_tpu_torch/utils/spans.py's
`current().export()`: the associator's SpanTimer, which run.py resets at
the window's start.  A program without that module or timer gives None,
and so does every reader of it.

Paths run from the `frame` root ("frame/assoc.branch/branch.enum");
spans outside any root (flush, precompile) are in the export's `outside`
book and never read here.  Per-frame figures divide by the timer's own
count of roots, one a `process_frame` call of the window.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

ROOT = "frame"
# the device-boundary spans inside the host association
DEVICE_SPANS = ("hyp.dispatch", "rescore.dispatch", "rescore.device")


def exported() -> Optional[dict]:
    try:
        from mcmtt_opticalflow_tpu_torch.utils import spans
    except ImportError:
        return None
    timer = spans.current()
    return None if timer is None else timer.export()


def self_ms(exp: dict, top: Callable[[str], bool],
            less: Iterable[str] = DEVICE_SPANS) -> Optional[float]:
    """ms a frame root: the self time of every span under the roots'
    children whose name passes `top`, those children included, less the
    spans named in `less` and what lies under them."""
    if not exp["roots"]:
        return None
    less = set(less)
    s = 0.0
    for path, agg in exp["paths"].items():
        names = path.split("/")
        if len(names) > 1 and names[0] == ROOT and top(names[1]) \
                and less.isdisjoint(names[1:]):
            s += agg["self_s"]
    return 1e3 * s / exp["roots"]


def named(*names: str) -> Callable[[str], bool]:
    return set(names).__contains__
