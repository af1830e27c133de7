"""The port kernels' time-weighted share of their roofline, in %: the
frozen least time of every launch in the profiled slice (serving: at
each call's shapes; training: the RMSNorm forward and backward entries
of the profiled steps) over the kernels' device time in the trace.
Nothing where the trace's kernel counts differ from the launchers'
counters."""
from chipbench.harness.record import TrainRecord
from chipbench.metrics.common import serve_roofline, train_roofline


def read(rec):
    if isinstance(rec, TrainRecord):
        return train_roofline(rec)
    return serve_roofline(rec)
