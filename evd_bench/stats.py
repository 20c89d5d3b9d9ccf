"""Order statistics of the harness."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, interpolated linearly between
    the two nearest ranks (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

