"""The numbers that decide ``correct``, each compared with its limit.

* Serving: the gap by which each served token's reference logit lies
  below the reference's best at its position, over a sample of the
  requests served (greedy decoding: a sound program serves the
  reference's best token up to rounding).  Over all the sampled tokens:
  ``logit_gap_max`` the widest, ``logit_gap_mean`` the mean and
  ``logit_gap_p80`` the 80th percentile.  Request by request:
  ``request_gap_p50_max``, the largest median gap of one request, so a
  fault confined to one row of the batch fails the check though it is
  a small share of the pool (whose 80th percentile would not move).
  The MoE's top-8 routing flips between bf16 and float32 on near ties,
  which moves the widest gap of sound runs to within 1.6 times of the
  fp8 control's: its cell compares the 80th percentile and the largest
  request median instead.
* Training: ``loss_gap`` (the largest relative gap of the three steps'
  losses), ``grad_gap`` (the first step's clipped gradient as the
  optimizer took it) and ``change_gap`` (each leaf's change after three
  steps): for a leaf, the gap between the program's norm and the
  reference's, over the larger of the reference's norm of that leaf and
  of the median leaf; the worst leaf counts.  Leaves whose reference
  gradient is under a thousandth of the median leaf's move by round-off
  alone and are left out of ``change_gap``.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple



def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               skip: Sequence[str] = ()) -> Tuple[float, str]:
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    worst, leaf = 0.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def round_off_leaves(ref_grad: Dict[str, float]) -> list:
    med = statistics.median(ref_grad.values())
    return sorted(k for k, g in ref_grad.items() if g < 1e-3 * med)


def train_numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    """``prog``/``ref``: {"losses", "grad", "change"} -> the three
    numbers with the leaf that set each."""
    skip = round_off_leaves(ref["grad"])
    g, gl = worst_leaf(prog["grad"], ref["grad"])
    c, cl = worst_leaf(prog["change"], ref["change"], skip)
    return {"loss_gap": {"value": loss_gap(prog["losses"],
                                           ref["losses"])},
            "grad_gap": {"value": g, "leaf": gl},
            "change_gap": {"value": c, "leaf": cl,
                           "left_out": skip}}


def serve_numbers(gaps: List, min_tokens: int = 1) -> Dict[str, dict]:
    """``gaps``: one tensor of per-token gaps for each sampled request
    (none sampled: a gap of infinity) -> the serving numbers.  A
    request's median is read only where it was served ``min_tokens`` or
    more (the median of a few tokens moves with one near tie); with no
    such request, the pool's."""
    import torch
    if not gaps:
        gaps = [torch.full((1,), float("inf"))]
    per = [g.double().cpu() for g in gaps]
    pool = torch.cat(per)
    judged = [g for g in per if g.numel() >= min_tokens] or [pool]
    medians = [float(torch.quantile(g, 0.5)) for g in judged]
    worst = max(range(len(judged)), key=medians.__getitem__)
    return {"logit_gap_max": {"value": float(pool.max())},
            "logit_gap_mean": {"value": float(pool.mean())},
            "logit_gap_p80": {"value": float(torch.quantile(pool, 0.8))},
            "request_gap_p50_max": {"value": medians[worst],
                                    "tokens": int(judged[worst].numel()),
                                    "requests": len(judged)}}


def judge(numbers: Dict[str, dict], limits: Dict[str, float]) -> bool:
    """Every number that ``limits`` names within its limit; the others
    (and a limit of None) are recorded and not compared."""
    limits = {k: v for k, v in limits.items() if v is not None}
    for name, lim in limits.items():
        numbers[name]["limit"] = lim
    return all(numbers[k]["value"] <= lim for k, lim in limits.items())
