"""Arithmetic the readers share."""
from __future__ import annotations

import sys
from typing import Dict, Optional

from chipbench.roofline import kernels
from chipbench.roofline.peaks import BF16_FLOPS


def mean(xs) -> Optional[float]:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def call_ms(rec, kind: str) -> Optional[float]:
    """Wall ms per ``kind`` call in the window (its calls' total time
    over their number), outside the profiled slice."""
    calls = rec.calls_in(kind)
    if not calls:
        return None
    return 1e3 * sum(c.t1 - c.t0 for c in calls) / len(calls)


def serve_mfu(rec) -> Optional[float]:
    """Useful FLOPs of the window's model calls over their wall time,
    as % of the bf16 peak."""
    calls = rec.calls_in("prefill") + rec.calls_in("decode")
    if not calls:
        return None
    flops = sum(rec.arch.forward_flops(rec.cfg, c.rows, c.logits_rows)
                for c in calls)
    return 100.0 * flops / sum(c.t1 - c.t0 for c in calls) / BF16_FLOPS


def _families_match(prof, launches) -> bool:
    """Every port-kernel family's count in the trace equals the
    launches its launchers counted (else the profiler dropped events);
    a mismatch is printed."""
    ok = True
    for fam, (_, entries) in kernels.KERNEL_FAMILIES.items():
        want = sum(launches.get(e, 0) for e in entries)
        if prof.family_n.get(fam, 0) != want:
            print(f"chipbench: kernel family {fam}: {prof.family_n.get(fam, 0)}"
                  f" in the trace, {want} launched: no roofline read",
                  file=sys.stderr)
            ok = False
    return ok


def _roofline(bound_ms: Dict[str, float], prof) -> float:
    """Σ least ms ÷ Σ device ms over the families, in %; each family's
    two sums are printed."""
    for fam, s in sorted(prof.family_s.items()):
        least = bound_ms.get(fam, 0.0)
        print(f"chipbench: kernel family {fam}: least {least:.6f} ms of "
              f"{1e3 * s:.6f} ms on the card ({100.0 * least / (1e3 * s):.3f}"
              f" %)", file=sys.stderr)
    total_s = sum(prof.family_s.values())
    return 100.0 * sum(bound_ms.values()) / (1e3 * total_s)


def serve_roofline(rec) -> Optional[float]:
    """The port kernels' time-weighted share of their bound over the
    profiled slice, in %: the least time of every launch at its call's
    shapes over the kernels' device time."""
    prof = rec.profile
    calls = (rec.calls_in("prefill", profiled=True)
             + rec.calls_in("decode", profiled=True))
    if prof is None or not calls or not prof.family_s:
        return None
    launches = {}
    for c in calls:
        for e, n in c.launches.items():
            launches[e] = launches.get(e, 0) + n
    if not _families_match(prof, launches):
        return None
    bound_ms: Dict[str, float] = {}
    for c in calls:
        shape = kernels.CallShape(c.kind, rec.cap, rec.chunk, c.rows, c.lens,
                                  rec.page)
        for fam, ms in kernels.serving_by_family(rec.cfg, shape,
                                                 c.launches).items():
            bound_ms[fam] = bound_ms.get(fam, 0.0) + ms
    return _roofline(bound_ms, prof)


def train_roofline(rec) -> Optional[float]:
    prof = rec.profile
    if prof is None or not rec.profiled_launches or not prof.family_s:
        return None
    if not _families_match(prof, rec.profiled_launches):
        return None
    return _roofline(kernels.train_by_family(rec.cfg, rec.batch, rec.seq,
                                             rec.profiled_launches), prof)


def idle(rec) -> Optional[float]:
    return None if rec.profile is None else rec.profile.idle_share
