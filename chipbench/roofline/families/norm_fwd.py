"""The RMSNorm forward and the residual add fused into it
(``rmsnorm_fwd``, ``add_rmsnorm_fwd``): one reduction, one device
name."""
from __future__ import annotations

from chipbench.roofline.families import BF16, bound, widths

PATTERN = r"(?<![A-Za-z0-9_])norm_kernel"
ENTRIES = {"rmsnorm_fwd": "repro_torch.kernels.rmsnorm.kernel",
           "add_rmsnorm_fwd": "repro_torch.kernels.rmsnorm.kernel"}

#: operations per element (kernel_bench's NORM_OPS)
OPS = {"rmsnorm_fwd": 4, "add_rmsnorm_fwd": 5}


def rmsnorm_bound(rows: int, d: int, es=BF16):
    """``rmsnorm_fwd`` on [rows, d]: x read, out written, w read."""
    numel = rows * d
    nbytes = 2 * numel * es + d * es
    return (*bound(nbytes, OPS["rmsnorm_fwd"] * numel, "float32"),
            nbytes)


def add_rmsnorm_bound(rows: int, d: int, es=BF16):
    """``add_rmsnorm_fwd``: x, delta read, normed and sum written."""
    numel = rows * d
    nbytes = 4 * numel * es + d * es
    return (*bound(nbytes, OPS["add_rmsnorm_fwd"] * numel, "float32"),
            nbytes)


def serving_ms(cfg, call, launches) -> float:
    """Every launch on the call's ``cap * S`` rows, but a chunk call's
    last ``add_rmsnorm_fwd``: the final norm, on one row each."""
    d = widths(cfg)["d"]
    S = call.chunk if call.kind == "prefill" else 1
    rows = call.cap * S
    ms = launches.get("rmsnorm_fwd", 0) * rmsnorm_bound(rows, d)[0]
    n_add = launches.get("add_rmsnorm_fwd", 0)
    if n_add:
        last = call.cap if call.kind == "prefill" else rows
        ms += ((n_add - 1) * add_rmsnorm_bound(rows, d)[0]
               + add_rmsnorm_bound(last, d)[0])
    return ms


def train_ms(cfg, B: int, S: int, launches) -> float:
    d = widths(cfg)["d"]
    return (launches.get("rmsnorm_fwd", 0) * rmsnorm_bound(B * S, d)[0]
            + launches.get("add_rmsnorm_fwd", 0)
            * add_rmsnorm_bound(B * S, d)[0])
