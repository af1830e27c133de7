"""The program's own work counters (``repro_torch.obs.spans.COUNTERS``):
what its calls computed against what they needed, counted where the
work happens from shapes and host mirrors.  They are the process's
totals, read once the run is over: every call of the run, the warm-up's
and the first join's with the window's."""
from __future__ import annotations

import sys
from typing import Optional


def ratio(num: str, den: str) -> Optional[float]:
    """Counter ``num`` over counter ``den``; None (and why, on standard
    error) where the program keeps no such counters or ``den`` is 0."""
    try:
        from repro_torch.obs.spans import COUNTERS
    except ImportError:
        print(f"chipbench: the program keeps no work counters ({num})",
              file=sys.stderr)
        return None
    d = COUNTERS.counter(den)
    if d <= 0:
        print(f"chipbench: counter {den} is 0", file=sys.stderr)
        return None
    return COUNTERS.counter(num) / d
