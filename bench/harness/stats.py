"""Order statistics over every sample: a percentile by Python's
``statistics.quantiles`` (inclusive method), a median, and the spread the
benchmark's bounds are set from."""
from __future__ import annotations

import statistics


def percentile(values, q: int) -> float:
    """The ``q``-th percentile (1..99) of all ``values``."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("no samples")
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=100, method="inclusive")[q - 1]


def median(values) -> float:
    return float(statistics.median(float(v) for v in values))


def spread(values) -> float:
    """Interquartile distance as a share of the median."""
    q1, _, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / statistics.median(values)
