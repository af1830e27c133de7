"""Each port kernel's least time on the card: the larger of its
necessary bytes over the memory rate and its operations over the peak
rate.  The formulas are copies of ``repro_torch.tools.kernel_bench``'s
bounds (a CPU test holds them equal), with the model's widths passed in;
the functions at the end add up a serving call's or a train step's
launches at their shapes."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from chipbench.roofline.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_S

PEAK_OPS_S = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
BF16 = 2

#: operations per element (kernel_bench's NORM_OPS, NORM_BWD_OPS)
NORM_OPS = {"rmsnorm_fwd": 4, "add_rmsnorm_fwd": 5,
            "qk_norm_rope_fwd": 4 + 3 + 1.5}
NORM_BWD_OPS = {"rmsnorm_bwd": 10, "add_rmsnorm_bwd": 11,
                "qk_norm_rope_bwd": 10 + 6 + 1.5}


def bound(nbytes: float, ops: float, dtype: str) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_bound_ms(B, Hq, D, page, Hkv, lens, es=BF16):
    """Paged decode: each live K/V page, q, the output, the live table
    slots and lens moved once; 4 * Hq * D operations per live token."""
    pages = sum(-(-int(n) // page) for n in lens)
    nbytes = (pages * page * Hkv * D * 2 * es + 2 * B * Hq * D * es
              + pages * 4 + B * 4)
    ops = 4 * Hq * D * int(sum(int(n) for n in lens))
    return bound(nbytes, ops, "bfloat16")


def rmsnorm_bound(rows: int, d: int, es=BF16):
    """``rmsnorm_fwd`` on [rows, d]: x read, out written, w read."""
    numel = rows * d
    nbytes = 2 * numel * es + d * es
    return (*bound(nbytes, NORM_OPS["rmsnorm_fwd"] * numel, "float32"),
            nbytes)


def add_rmsnorm_bound(rows: int, d: int, es=BF16):
    """``add_rmsnorm_fwd``: x, delta read, normed and sum written."""
    numel = rows * d
    nbytes = 4 * numel * es + d * es
    return (*bound(nbytes, NORM_OPS["add_rmsnorm_fwd"] * numel,
                   "float32"), nbytes)


def qk_norm_rope_bound(B, S, Hq, Hkv, D, position_bytes, qk_norm=True,
                       es=BF16):
    """``qk_norm_rope_fwd``: q and k read and written once, the norm
    weights, the positions and the fp32 inverse frequencies read once."""
    outs = B * S * (Hq + Hkv) * D
    nbytes = (2 * outs * es + 2 * D * es * qk_norm + position_bytes
              + 4 * D // 2)
    return (*bound(nbytes, NORM_OPS["qk_norm_rope_fwd"] * outs,
                   "float32"), nbytes)


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
    return (*bound(nbytes, NORM_BWD_OPS[entry] * outs, "float32"), nbytes)


# --- launches of a path, at their shapes -----------------------------------

#: the port's kernels as the device trace names them, and the launcher
#: entries (``<launcher>.launches``) whose launches each name counts
KERNEL_FAMILIES = {
    "paged_decode": (r"paged_decode_split_kernel",
                     ("paged_attention_fwd",)),
    "norm_fwd": (r"(?<![A-Za-z0-9_])norm_kernel",
                 ("rmsnorm_fwd", "add_rmsnorm_fwd")),
    "qk_norm_rope_fwd": (r"qk_norm_rope_kernel", ("qk_norm_rope_fwd",)),
    "norm_bwd": (r"(?<![A-Za-z0-9_])norm_bwd_kernel",
                 ("rmsnorm_bwd", "add_rmsnorm_bwd")),
    "qk_norm_rope_bwd": (r"qk_norm_rope_bwd_kernel", ("qk_norm_rope_bwd",)),
    "dw_sum": (r"sum_partials_kernel",
               ("rmsnorm_bwd", "add_rmsnorm_bwd", "qk_norm_rope_bwd")),
}


def widths(cfg) -> Dict[str, int]:
    return dict(d=cfg.d_model, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                D=cfg.head_dim, qk_norm=int(cfg.use_qk_norm))


def serving_call_ms(cfg, kind: str, cap: int, chunk: int,
                    lens: Sequence[int], launches: Dict[str, int],
                    page: int) -> float:
    """Least ms of the port kernels one serving call launched:
    ``kind`` "prefill" (a chunk of ``chunk`` tokens on each of ``cap``
    rows; its last ``add_rmsnorm_fwd`` is the final norm on one row
    each) or "decode" (``lens``: the kv length each of the ``cap`` rows
    attends, as launched)."""
    w = widths(cfg)
    S = chunk if kind == "prefill" else 1
    rows = cap * S
    ms = launches.get("rmsnorm_fwd", 0) * rmsnorm_bound(rows, w["d"])[0]
    n_add = launches.get("add_rmsnorm_fwd", 0)
    if n_add:
        last = cap if kind == "prefill" else rows
        ms += ((n_add - 1) * add_rmsnorm_bound(rows, w["d"])[0]
               + add_rmsnorm_bound(last, w["d"])[0])
    ms += launches.get("qk_norm_rope_fwd", 0) * qk_norm_rope_bound(
        cap, S, w["Hq"], w["Hkv"], w["D"], 4 * cap * S, w["qk_norm"])[0]
    if launches.get("paged_attention_fwd", 0):
        ms += launches["paged_attention_fwd"] * paged_bound_ms(
            cap, w["Hq"], w["D"], page, w["Hkv"], lens)[0]
    return ms


def train_step_ms(cfg, B: int, S: int, launches: Dict[str, int]) -> float:
    """Least ms of the norm kernels a train step launched, every one on
    the step's [B * S] rows (positions int64 [S])."""
    w = widths(cfg)
    rows = B * S
    ms = (launches.get("rmsnorm_fwd", 0) * rmsnorm_bound(rows, w["d"])[0]
          + launches.get("add_rmsnorm_fwd", 0)
          * add_rmsnorm_bound(rows, w["d"])[0]
          + launches.get("qk_norm_rope_fwd", 0) * qk_norm_rope_bound(
              B, S, w["Hq"], w["Hkv"], w["D"], 8 * S, w["qk_norm"])[0])
    for entry in ("rmsnorm_bwd", "add_rmsnorm_bwd", "qk_norm_rope_bwd"):
        ms += launches.get(entry, 0) * norm_bwd_bound(
            entry, B, S, w["d"], w["Hq"], w["Hkv"], w["D"],
            w["qk_norm"])[0]
    return ms
