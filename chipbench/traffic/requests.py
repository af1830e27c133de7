"""Serving requests: lognormal prompt and output lengths, all due at
once (a backlog) or as a Poisson stream (an open loop).

What the lengths and arrival times are comes from the mix's own
``base_seed``: every run seed gets the same multiset of sizes and the
same arrival times.  The run seed shuffles the sizes within consecutive
blocks of ``shuffle_block`` requests (so each block of the stream holds
the same work whatever the seed) and draws the prompt tokens.  A run's
throughput then depends on the seed through the order alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

#: prompt tokens are drawn from [FIRST_TOKEN, vocab): clear of the
#: serving backend's pad id (3) and the ids below it
FIRST_TOKEN = 4


@dataclass(frozen=True)
class Spec:
    """One request before it enters the engine: due time in seconds
    from the engine's start, lengths, and prompt ids."""
    rid: int
    due: float
    prompt: List[int]
    max_new: int


def lognormal_lengths(rng: np.random.Generator, n: int, dist: dict
                      ) -> np.ndarray:
    """``n`` lengths from a lognormal of the given median and sigma,
    rounded and clipped to [min, max]."""
    x = rng.lognormal(np.log(dist["median"]), dist["sigma"], n)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def arrival_times(params: dict, horizon_s: float) -> np.ndarray:
    """Due times (seconds from the start) of the mix: ``count`` at 0 for
    a backlog; a Poisson stream at ``rate_per_s`` up to ``horizon_s``."""
    if params["arrivals"] == "backlog":
        return np.zeros(int(params["count"]))
    if params["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {params['arrivals']!r}")
    rng = np.random.default_rng([int(params["base_seed"]), 1])
    rate = float(params["rate_per_s"])
    n = int(horizon_s * rate * 1.5) + 64
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    while t[-1] < horizon_s:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, n))])
    return t[t < horizon_s]


def block_permutation(rng: np.random.Generator, n: int, block: int
                      ) -> np.ndarray:
    """A permutation of range(n) that moves each index only within its
    block of ``block`` consecutive indices."""
    perm = np.arange(n)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        perm[lo:hi] = lo + rng.permutation(hi - lo)
    return perm


def make(params: dict, seed: int, horizon_s: float, vocab: int
         ) -> List[Spec]:
    """The mix's requests for run ``seed``, due before ``horizon_s``."""
    due = arrival_times(params, horizon_s)
    n = len(due)
    base = np.random.default_rng([int(params["base_seed"]), 0])
    plen = lognormal_lengths(base, n, params["prompt"])
    olen = lognormal_lengths(base, n, params["output"])
    rng = np.random.default_rng([int(seed), 7])
    perm = block_permutation(rng, n, int(params.get("shuffle_block", 1)))
    plen, olen = plen[perm], olen[perm]
    out = []
    for i in range(n):
        ids = rng.integers(FIRST_TOKEN, vocab, int(plen[i]))
        out.append(Spec(i, float(due[i]), ids.tolist(), int(olen[i])))
    return out


def longest(params: dict) -> int:
    """Prompt plus output of the longest request the mix can send."""
    return int(params["prompt"]["max"]) + int(params["output"]["max"])


def summary(specs: Sequence[Spec]) -> str:
    p = np.array([len(s.prompt) for s in specs])
    o = np.array([s.max_new for s in specs])
    return (f"{len(specs)} requests, prompt median {np.median(p):.0f} "
            f"(max {p.max()}), output median {np.median(o):.0f} "
            f"(max {o.max()})")
