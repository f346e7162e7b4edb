"""Math utility parity with the reference's psn:: namespace
(psn_where/PSNWhere_Utils.cpp:181-525).

erf/erfc use jax.scipy.special on device and scipy on host (both match the
reference's double-precision series implementation, Utils.cpp:213-433, to
f32 precision — validated in tests); nchoosek mirrors Utils.cpp:181-202.
"""

from __future__ import annotations

from typing import List

import numpy as np


def nchoosek(n: int, k: int) -> List[List[int]]:
    """All k-combinations of range(n) (ref psn::nchoosek,
    Utils.cpp:181-202)."""
    import itertools

    if n < k or n <= 0:
        return []
    return [list(c) for c in itertools.combinations(range(n), k)]


def erf(x):
    from scipy.special import erf as _erf

    return _erf(x)


def erfc(x):
    from scipy.special import erfc as _erfc

    return _erfc(x)


def histogram_channel(values: np.ndarray, num_bins: int) -> np.ndarray:
    """Per-channel histogram of byte values (ref psn::histogram,
    Utils.cpp:445-460): bin = floor(v / (256/num_bins))."""
    v = np.asarray(values).reshape(-1)
    bins = np.clip((v / (256.0 / num_bins)).astype(int), 0, num_bins - 1)
    out = np.zeros(num_bins)
    np.add.at(out, bins, 1.0)
    return out
