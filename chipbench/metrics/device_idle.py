"""Share of the profiled slice (serving calls or train steps) in which
no operation ran on the card."""
from chipbench.metrics.common import idle


def read(rec):
    return idle(rec)
