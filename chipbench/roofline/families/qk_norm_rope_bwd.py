"""The row kernel of the qk-norm and RoPE backward
(``qk_norm_rope_bwd``); its bound covers the sum of dwq's and dwk's
partial rows too (family ``dw_sum``)."""
from __future__ import annotations

from chipbench.roofline.families import widths
from chipbench.roofline.families.norm_bwd import norm_bwd_bound

PATTERN = r"qk_norm_rope_bwd_kernel"
ENTRIES = {"qk_norm_rope_bwd": "repro_torch.kernels.rmsnorm.kernel"}


def train_ms(cfg, B: int, S: int, launches) -> float:
    w = widths(cfg)
    return launches.get("qk_norm_rope_bwd", 0) * norm_bwd_bound(
        "qk_norm_rope_bwd", B, S, w["d"], w["Hq"], w["Hkv"], w["D"],
        w["qk_norm"])[0]
