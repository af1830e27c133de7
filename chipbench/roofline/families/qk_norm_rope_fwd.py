"""The qk-norm and RoPE of q and k, fused (``qk_norm_rope_fwd``)."""
from __future__ import annotations

from chipbench.roofline.families import BF16, bound, widths

PATTERN = r"qk_norm_rope_kernel"
ENTRIES = {"qk_norm_rope_fwd": "repro_torch.kernels.rmsnorm.kernel"}

#: operations per element (kernel_bench's NORM_OPS)
OPS = 4 + 3 + 1.5


def qk_norm_rope_bound(B, S, Hq, Hkv, D, position_bytes, qk_norm=True,
                       es=BF16):
    """``qk_norm_rope_fwd``: q and k read and written once, the norm
    weights, the positions and the fp32 inverse frequencies read once."""
    outs = B * S * (Hq + Hkv) * D
    nbytes = (2 * outs * es + 2 * D * es * qk_norm + position_bytes
              + 4 * D // 2)
    return (*bound(nbytes, OPS * outs, "float32"), nbytes)


def serving_ms(cfg, call, launches) -> float:
    """At int32 positions, one a token."""
    w = widths(cfg)
    S = call.chunk if call.kind == "prefill" else 1
    return launches.get("qk_norm_rope_fwd", 0) * qk_norm_rope_bound(
        call.cap, S, w["Hq"], w["Hkv"], w["D"], 4 * call.cap * S,
        w["qk_norm"])[0]


def train_ms(cfg, B: int, S: int, launches) -> float:
    """At int64 positions [S]."""
    w = widths(cfg)
    return launches.get("qk_norm_rope_fwd", 0) * qk_norm_rope_bound(
        B, S, w["Hq"], w["Hkv"], w["D"], 8 * S, w["qk_norm"])[0]
