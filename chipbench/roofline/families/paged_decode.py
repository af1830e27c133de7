"""Paged decode attention (``paged_attention_fwd``): one launch a layer
of each decode call."""
from __future__ import annotations

from chipbench.roofline.families import BF16, bound, widths

PATTERN = r"paged_decode_split_kernel"
ENTRIES = {"paged_attention_fwd": "repro_torch.kernels.paged_attention.kernel"}


def paged_bound_ms(B, Hq, D, page, Hkv, lens, es=BF16):
    """Paged decode: each live K/V page, q, the output, the live table
    slots and lens moved once; 4 * Hq * D operations per live token."""
    pages = sum(-(-int(n) // page) for n in lens)
    nbytes = (pages * page * Hkv * D * 2 * es + 2 * B * Hq * D * es
              + pages * 4 + B * 4)
    ops = 4 * Hq * D * int(sum(int(n) for n in lens))
    return bound(nbytes, ops, "bfloat16")


def serving_ms(cfg, call, launches) -> float:
    n = launches.get("paged_attention_fwd", 0)
    if not n:
        return 0.0
    w = widths(cfg)
    return n * paged_bound_ms(call.cap, w["Hq"], w["D"], call.page,
                              w["Hkv"], call.lens)[0]
