"""Routed (token, expert) pairs over the expert buffer slots computed
(E x C), every MoE layer of every model call of the run:
``moe.pairs_routed`` over ``moe.slots_computed``."""
from chipbench.harness.work import ratio


def read(rec):
    return ratio("moe.pairs_routed", "moe.slots_computed")
