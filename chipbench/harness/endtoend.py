"""The end-to-end metrics, from the wall-clock record of a run: what a
user of the system sees.  ``setup_s`` is passed in (process start to
the window's wall mark)."""
from __future__ import annotations

from typing import List

from chipbench.harness.record import ServeRecord, TrainRecord
from chipbench.harness.stats import percentile


def _inside(t: float, window) -> bool:
    return window[0] <= t <= window[1]


def output_tok_s(rec: ServeRecord) -> float:
    """Output tokens stamped inside the window over the window."""
    n = sum(1 for ts in rec.stamps.values() for t in ts
            if _inside(t, rec.window))
    return n / (rec.window[1] - rec.window[0])


def token_gaps(rec: ServeRecord) -> List[float]:
    """Every gap between consecutive tokens of one request with both
    stamps inside the window, over all requests."""
    gaps = []
    for ts in rec.stamps.values():
        for a, b in zip(ts, ts[1:]):
            if _inside(a, rec.window) and _inside(b, rec.window):
                gaps.append(b - a)
    return gaps


def itl_p95_ms(rec: ServeRecord) -> float:
    return 1e3 * percentile(token_gaps(rec), 95)


def ttfts(rec: ServeRecord) -> List[float]:
    """For every request due in the window: its first token's stamp
    minus its due time, or, with no first token by the close, the wait
    until the close."""
    w0, w1 = rec.window
    out = []
    for rid, due in rec.due.items():
        if not w0 <= due <= w1:
            continue
        first = rec.stamps.get(rid, [])
        t = first[0] if first and first[0] <= w1 else w1
        out.append(t - due)
    return out


def ttft_p50_s(rec: ServeRecord) -> float:
    return percentile(ttfts(rec), 50)


def train_steps(rec: TrainRecord) -> float:
    """Steps done inside the window: each step that ended inside it,
    and the share of the step that crosses its close which lay inside
    (steps run back to back from the window's start), so a stall at
    the close lowers the count as it would anywhere else."""
    w0, w1 = rec.window
    done, start = 0.0, w0
    for end in rec.step_ends:
        if end <= w1:
            done += 1.0
        else:
            done += max(0.0, w1 - start) / (end - start)
            break
        start = end
    return done


def train_tok_s(rec: TrainRecord) -> float:
    """Tokens of the steps done inside the window over the window."""
    return train_steps(rec) * rec.tokens_per_step / (rec.window[1]
                                                      - rec.window[0])


#: each end-to-end metric by name
METRICS = {"output_tok_s": output_tok_s, "itl_p95_ms": itl_p95_ms,
           "train_tok_s": train_tok_s}


def tails(rec: ServeRecord) -> str:
    """The first token's wait and the token gaps at several percentiles
    (seconds, ms), for the record on standard error."""
    def qs(xs, at):
        return " ".join(f"p{q}={percentile(xs, q)!r}" for q in at) \
            if xs else "none"
    t, g = ttfts(rec), [1e3 * x for x in token_gaps(rec)]
    return (f"ttft_s n={len(t)} {qs(t, (25, 50, 75, 90))}; gaps_ms "
            f"n={len(g)} {qs(g, (50, 90, 95, 99))}")


def attempted(rec) -> int:
    """Steps in the window (training); requests due in the window or
    joined before its close (serving)."""
    if isinstance(rec, TrainRecord):
        return sum(1 for t in rec.step_ends if _inside(t, rec.window))
    w0, w1 = rec.window
    return sum(1 for rid, d in rec.due.items()
               if w0 <= d <= w1 or rec.joined.get(rid, w1 + 1) <= w1)
