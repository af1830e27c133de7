"""KV tokens held over the KV tokens reserved (whole pages of the
worst case each request booked at join), mean over the window's decode
calls: the memory model's reservation against use."""
from chipbench.metrics.common import mean


def read(rec):
    return mean(c.kv_live / c.kv_reserved for c in rec.calls_in("decode")
                if c.kv_reserved > 0)
