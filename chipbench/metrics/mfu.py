"""Useful FLOPs as % of the card's bf16 peak.  Serving: of the window's
model calls over their wall time (the calls' time, not the window's, so
the offered load does not set it).  Training: of the steps done inside
the window over the window."""
from chipbench.harness.endtoend import train_steps
from chipbench.harness.record import TrainRecord
from chipbench.metrics.common import serve_mfu
from chipbench.roofline.peaks import BF16_FLOPS


def read(rec):
    if not isinstance(rec, TrainRecord):
        return serve_mfu(rec)
    steps = train_steps(rec)
    if steps == 0:
        return None
    per_step = rec.arch.train_step_flops(rec.cfg, rec.batch, rec.seq)
    return 100.0 * steps * per_step / (rec.window[1] - rec.window[0]) \
        / BF16_FLOPS
