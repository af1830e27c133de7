"""Wall ms per prefill-chunk call, up to the tokens' read-back: the
window's chunk calls' total time over their number."""
from chipbench.metrics.common import call_ms


def read(rec):
    return call_ms(rec, "prefill")
