"""Rows active per decode call, mean over the window's decode calls
(the backend's record of each call): how full the engine keeps the
batch."""
from chipbench.metrics.common import mean


def read(rec):
    return mean(len(c.rows) for c in rec.calls_in("decode"))
