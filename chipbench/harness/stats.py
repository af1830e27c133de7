"""Percentiles and run-to-run spreads."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default); None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as Python's
    ``statistics.quantiles(values, n=4)`` gives them, as a share of the
    median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
