"""The row kernel of the RMSNorm backwards (``rmsnorm_bwd``,
``add_rmsnorm_bwd``).  Each backward's bound covers its second launch
too, the sum of dw's partial rows (family ``dw_sum``)."""
from __future__ import annotations

from chipbench.roofline.families import BF16, bound, widths

PATTERN = r"(?<![A-Za-z0-9_])norm_bwd_kernel"
ENTRIES = {"rmsnorm_bwd": "repro_torch.kernels.rmsnorm.kernel",
           "add_rmsnorm_bwd": "repro_torch.kernels.rmsnorm.kernel"}

#: operations per element (kernel_bench's NORM_BWD_OPS)
OPS = {"rmsnorm_bwd": 10, "add_rmsnorm_bwd": 11,
       "qk_norm_rope_bwd": 10 + 6 + 1.5}


def norm_bwd_bound(entry, B, S, d, Hq, Hkv, D, qk_norm=True, es=BF16):
    """A backward at a train step's launch: the incoming gradients and
    the forward's inputs read once, the gradients written once (dw in
    w's dtype), RoPE's int64 positions and fp32 frequencies read once."""
    if entry == "qk_norm_rope_bwd":
        outs = B * S * (Hq + Hkv) * D
        nbytes = (3 * outs * es + 4 * D * es * qk_norm + 4 * D // 2
                  + 8 * S)
    else:
        outs = B * S * d
        acts = {"rmsnorm_bwd": 3, "add_rmsnorm_bwd": 4}[entry]
        nbytes = acts * outs * es + 2 * d * es
    return (*bound(nbytes, OPS[entry] * outs, "float32"), nbytes)


def train_ms(cfg, B: int, S: int, launches) -> float:
    w = widths(cfg)
    ms = 0.0
    for entry in ENTRIES:
        ms += launches.get(entry, 0) * norm_bwd_bound(
            entry, B, S, w["d"], w["Hq"], w["Hkv"], w["D"],
            w["qk_norm"])[0]
    return ms
