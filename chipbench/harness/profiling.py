"""A slice of the window under ``torch.profiler``, started and stopped
between calls, and what its trace says: device busy time, idle gaps by
what the host was doing (the harness's own ``chipbench/...`` ranges),
device time by operation, and the port kernels' times and counts."""
from __future__ import annotations

import re
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from chipbench.roofline.kernels import KERNEL_FAMILIES

SLICE = "chipbench/slice"
#: what the host does outside every harness range: the program's own
#: host work between calls (the engine's step, the optimizer's leaves)
OUTSIDE = "chipbench/outside"
#: seconds the profiler runs on after the slice's range, idle
TAIL_S = 0.5


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]          # top 10 by seconds
    idle_gaps: List[Tuple[str, float]]           # idle s by host range
    family_s: Dict[str, float] = field(default_factory=dict)
    family_n: Dict[str, int] = field(default_factory=dict)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else 1000 * getattr(e, f"{what}_us")()


def _union(spans):
    out = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def summarise(events) -> Summary:
    """Summary of kineto events (``prof.profiler.kineto_results
    .events()``) inside the slice's range."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ranges, dev = [], []
    lo = hi = None
    for e in events:
        name = e.name()
        s = _ns(e, "start")
        t = s + _ns(e, "duration")
        if e.device_type() == cuda:
            # a user annotation (a ``record_function`` range, the
            # harness's own among them) is copied onto the device's
            # timeline too: it is no device work
            if not e.is_user_annotation():
                dev.append((s, t, name))
        elif name == SLICE:
            lo, hi = s, t
        elif name.startswith("chipbench/"):
            ranges.append((s, t, name))
    if lo is None:
        raise RuntimeError("the trace holds no chipbench/slice range")
    # The card is idle when the profiler starts and when it stops (every
    # call reads back, every step synchronises), so each device operation
    # of the trace belongs to the slice: none is cut at the host's range
    # of it, and the window reaches over any that stick out of that range.
    if dev:
        first = min(s for s, _, _ in dev)
        last = max(t for _, t, _ in dev)
        print(f"chipbench: trace: device operations from "
              f"{(first - lo) / 1e6:+.3f} ms after the slice's start to "
              f"{(last - hi) / 1e6:+.3f} ms after its end", file=sys.stderr)
        lo, hi = min(lo, first), max(hi, last)
    busy = _union([(s, t) for s, t, _ in dev])
    busy_ns = sum(t - s for s, t in busy)
    by_op: Dict[str, float] = {}
    for s, t, n in dev:
        by_op[n] = by_op.get(n, 0.0) + (t - s) / 1e9
    gaps: Dict[str, float] = {}
    edge = lo
    for s, t in busy + [[hi, hi]]:
        if s > edge:
            mid = (edge + s) / 2
            inner = [r for r in ranges if r[0] <= mid < r[1]]
            label = (min(inner, key=lambda r: r[1] - r[0])[2]
                     if inner else OUTSIDE)
            gaps[label] = gaps.get(label, 0.0) + (s - edge) / 1e9
        edge = max(edge, t)
    fam_s, fam_n = {}, {}
    for fam, (pattern, _) in KERNEL_FAMILIES.items():
        rx = re.compile(pattern)
        hits = [(t - s) for s, t, n in dev if rx.search(n)]
        if hits:
            fam_s[fam] = sum(hits) / 1e9
            fam_n[fam] = len(hits)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
                   device_ops=[[n[:160], v] for n, v in top],
                   idle_gaps=sorted(([k, v] for k, v in gaps.items()),
                                    key=lambda kv: -kv[1])[:10],
                   family_s=fam_s, family_n=fam_n)


class Slice:
    """``start()`` and ``stop()`` between calls; ``summary()`` after."""

    def __init__(self):
        self.prof = None
        self._range = None

    @staticmethod
    def warm() -> None:
        """One empty profile, so that the profiler's own first start
        (CUPTI's set-up) falls into set-up and not into the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    @property
    def running(self) -> bool:
        return self.prof is not None and self._range is not None

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._range = None
        # stopped at once, the profiler loses some of the slice's last
        # device operations (on an H100: 1 to 7 of a chat slice's port
        # kernels, in about half the traced runs); idle time before the
        # stop keeps them
        time.sleep(TAIL_S)
        self.prof.stop()

    def summary(self) -> Summary:
        return summarise(self.prof.profiler.kineto_results.events())
