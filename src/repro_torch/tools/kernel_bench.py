"""Kernel microbenchmarks of the port: every hand-written CUDA kernel at
the main paths' launch shapes, beside its bound, its plain PyTorch
version and, where one exists, one PyTorch library call that computes
the same function.

    python -m repro_torch.tools.kernel_bench                # the card
    python -m repro_torch.tools.kernel_bench --device cpu   # plain only

On the card (the default; it raises without one) the kernels are built
from the checkout's sources and each (kernel, launch) prints one line and
emits one ``name,value,derived`` row of its device ms; the rows go to
``results/bench_torch_kernels.json``.  With ``--device cpu`` only the
plain versions run, at the JAX tool's CPU sizes (attention at S 128, 256
and 512, the SSD scan at S 256 and 1024, RMSNorm ``[256, 512]``), each
row labelled ``plain``: a CPU time, no device metric.

Device times come from ``torch.profiler`` (the kernels' own time, with a
fallback to CUDA events behind a sleep kernel where the profiler drops
events), and time per call from CUDA events.  A bound is the larger of
the bytes the call must move (each input read once, each output written
once) over the card's memory rate and its operations over the peak rate
of their type; the bound functions take shapes, not tensors, so the CPU
tests check them.

This module imports no part of ``repro_torch`` when it is imported, and
the kernels only inside the timers: ``chip_smoke.py`` loads this file by
its path, so that ``chip_smoke.py --kernel-times SRC`` times the kernels
of another checkout's package (one without ``repro_torch.tools`` too)
with this tree's timing code, shapes and bounds.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

#: H100 SXM: device memory rate, and peak rates without sparsity (bf16 on
#: the tensor cores; f32 outside them, since TF32 is off)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

#: where the timers put their inputs
DEVICE = "cuda"

#: the numbers of a timed row that ``chip_smoke.py``'s kernels line holds
JSON_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE, dtype=dtype)


# --- timing ---------------------------------------------------------------

def _cuda_ms(fn, iters: int) -> float:
    """Time per call between CUDA events around ``iters`` calls: the
    device's time, or the host's time to issue each call where that is
    longer (a small kernel behind a Python wrapper)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def _queued_ms(fn, iters: int) -> float:
    """Device time per call between CUDA events around ``iters`` calls
    that the host issues while a sleep kernel holds the stream, so that
    the calls run back to back on the device and the host's time to issue
    them stays out (a window in which the first event had already passed
    when the host was done is timed again behind a longer sleep)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    # clock cycles: four times the synchronised loop's wall time at 2 GHz
    cycles = int(8e9 * (time.perf_counter() - t0)) + 10**6
    for _ in range(4):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for i in range(iters):
            fn(i)
        e1.record()
        held = not e0.query()
        e1.synchronize()
        if held:
            return e0.elapsed_time(e1) / iters
        cycles *= 4
    raise AssertionError(f"the host issued {iters} calls slower than a "
                         f"sleep of {cycles // 4} cycles held the stream")


def _device_ms(fn, iters: int, kernel: str = "", per_call: int = 0,
               floor_ms: float = 0.0) -> float:
    """Device time per call: the summed times of the kernels that
    ``iters`` calls of ``fn`` launch (``torch.profiler``; one stream, so
    they do not overlap), over ``iters``.  With ``kernel``, the mean time
    of the kernels whose name holds it (one per call); with ``per_call``,
    the calls' kernels counted (that many a call).  The profiler may drop
    events, so with either at least nine tenths of the kernels must be
    seen, and it has been seen to read a window's kernels at half their
    time, so a time below ``floor_ms`` (the call's bound, which no kernel
    beats) is refused too; a refused window is profiled again, up to
    three times, and after a third the calls are timed by ``_queued_ms``
    instead, which also counts any other kernel of a call and the
    device's gaps between launches.  Unlike ``_cuda_ms`` it leaves out
    the gaps while the host issues the next call."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and kernel in e.name]
        want = iters * (per_call or 1) if kernel or per_call else 0
        if kernels and (not want or 0.9 * want <= len(kernels) <= want):
            total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
            ms = total / (len(kernels) / (per_call or 1) if want else iters)
            if ms >= floor_ms:
                return ms
            print(f"the profiler read {ms * 1e3:.2f} us per call of the "
                  f"device events named {kernel!r}, below the bound of "
                  f"{floor_ms * 1e3:.3f} us")
        else:
            print(f"the profiler saw {len(kernels)} device events named "
                  f"{kernel!r} for {iters} calls")
    ms = _queued_ms(fn, iters)
    print(f"the profiler dropped or misread device events named "
          f"{kernel!r} in three windows of {iters} calls: timed on CUDA "
          f"events behind a sleep kernel instead, {ms * 1e3:.2f} us per "
          f"call")
    return ms


def _ms_by_kernel(fn, iters: int) -> dict:
    """(summed device ms, launches seen) of each kernel that ``iters``
    calls of ``fn`` launch, by the kernel's name (``torch.profiler``, one
    window; it may drop events)."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = out.get(e.name, (0.0, 0))
            out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


def bwd_launches(fn, iters: int) -> str:
    """A backward's two launches apart: the row kernel's and dw's
    fixed-order sum's (``sum_partials_kernel``) device times per call,
    each the mean over the launches the profiler saw (their count
    printed)."""
    by_name = _ms_by_kernel(fn, iters)
    if not by_name:
        return "the profiler saw no device time"
    sums = {True: [0.0, 0], False: [0.0, 0]}
    for name, (ms, n) in by_name.items():
        sums["sum_partials" in name][0] += ms
        sums["sum_partials" in name][1] += n
    (dw, n_dw), (row, n_row) = sums[True], sums[False]
    row, dw = row / max(n_row, 1), dw / max(n_dw, 1)
    return (f"row kernel {row * 1e3:.2f} us + dw sum {dw * 1e3:.2f} us "
            f"({dw / (row + dw):.3f} of the two; {n_row} and {n_dw} "
            f"launches seen of {iters})")


def timed(fn, iters: int, kernel: str = "", per_call: int = 0,
          floor_ms: float = 0.0) -> dict:
    """{"ms": device time per call (of ``kernel`` alone, if named;
    ``per_call``: the kernels a call launches, checked; not below
    ``floor_ms``, the call's bound), "call_ms": event time per call}."""
    return {"ms": _device_ms(fn, iters, kernel, per_call, floor_ms),
            "call_ms": _cuda_ms(fn, iters)}


def us(t: dict) -> str:
    return f"{t['ms'] * 1e3:.2f} us ({t['call_ms'] * 1e3:.2f} per call)"


def _row(kernel: str, launch: str, ker, plain, lib, bound_ms,
         bound_by) -> dict:
    """One (kernel, launch): the kernel's device ms and ms per call, its
    plain version's and the library call's (None where there is none)
    device ms, and the bound."""
    return dict(kernel=kernel, launch=launch, ms=ker["ms"],
                call_ms=ker["call_ms"], plain_ms=plain["ms"],
                library_ms=None if lib is None else lib["ms"],
                bound_ms=bound_ms, bound_by=bound_by)


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# --- bounds (shapes only: no device) ---------------------------------------

def bound(nbytes: float, ops: float, dtype):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate for ``dtype``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_bound_ms(B, Hq, D, page, Hkv, lens, dtype):
    """Least time for the card: each live K/V page, q, the output, the
    live table slots and lens moved once; 4 * Hq * D operations per live
    token (q.k and p.v, multiply and add)."""
    es = dtype.itemsize
    pages = sum(-(-int(n) // page) for n in lens)
    nbytes = (pages * page * Hkv * D * 2 * es + 2 * B * Hq * D * es
              + pages * 4 + B * 4)
    ops = 4 * Hq * D * int(sum(int(n) for n in lens))
    return bound(nbytes, ops, dtype)


def attended_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep in one S x S attention."""
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= kp > qp - window
    return int(ok.sum())


def flash_bound(B, S, Hq, Hkv, D, window, dtype):
    """(ms, bound by, bytes, operations) of a causal prefill: q, k, v
    read and the output written once; 4 * D operations per attended
    (query, key) pair and head."""
    nbytes = B * S * D * dtype.itemsize * (2 * Hq + 2 * Hkv)
    ops = 4 * D * Hq * B * attended_pairs(S, True, window)
    return (*bound(nbytes, ops, dtype), nbytes, ops)


def attended_slots(S: int, lens, window: int) -> int:
    """Cache slots the dense decode reads over the rows: [max(0, end -
    window), min(end, S)) for each row's end = lens[b] (its position +
    1, past S where the write was clamped onto the last slot)."""
    return sum(min(e, S) - (max(0, e - window) if window else 0)
               for e in lens)


def decode_bound(B, S, Hq, Hkv, D, lens, window, dtype):
    """(ms, bound by, bytes, operations) of a dense decode: the attended
    K/V slots, q and the output moved once, the rows' positions read;
    4 * Hq * D operations per attended slot."""
    es = dtype.itemsize
    live = attended_slots(S, lens, window)
    nbytes = live * Hkv * D * 2 * es + 2 * B * Hq * D * es + B * 4
    ops = 4 * Hq * D * live
    return (*bound(nbytes, ops, dtype), nbytes, ops)


def ssd_bound_ms(B, S, H, P, G, N, chunk, dtype, init):
    """Least time for the card: xb, a, the grouped B and C and (when
    given) the initial state read once, y and the final state written
    once; the operations of the causal (j <= i) score and score-times-xb
    products and of the inter-chunk and state-update products, per
    chunk."""
    es = dtype.itemsize
    nbytes = (2 * B * S * H * P * es + B * S * H * 4 + 2 * B * S * G * N * es
              + (1 + (init is not None)) * B * H * P * N * 4)
    ops = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        pairs = n * (n + 1) // 2
        ops += 2 * pairs * (N + P) + 4 * n * N * P
    return (*bound(nbytes, B * H * ops, dtype), nbytes, B * H * ops)


#: operations per element of the normed activations: the norm's 4 (square
#: and add, scale, times w); the add's 1; the gate's silu (exp, add,
#: divide) and mul; RoPE's two products and a sum, and per pair the angle,
#: cos and sin.  All fp32 on the CUDA cores.
NORM_OPS = {"rmsnorm_fwd": 4, "add_rmsnorm_fwd": 5, "gated_rmsnorm_fwd": 8,
            "qk_norm_rope_fwd": 4 + 3 + 1.5}
#: operations per element of the split gated norm's entries: the gate
#: (silu: exp, add, divide; the product) and the square and add; the
#: norm's scale and times w after the gate; dot's product of three and
#: add after the gate; the backward's gated row as ``gated_rmsnorm_bwd``
SPLIT_OPS = {"gated_rmsnorm_sumsq": 6, "gated_rmsnorm_scale": 7,
             "gated_rmsnorm_dot": 7, "gated_rmsnorm_scale_bwd": 22}
#: operations per element of the normed activations in each backward (fp32
#: on the CUDA cores): g = dy * w, the two sums (square and add, product
#: and add), dx's three and dw's two; the add's dr; the gate's silu, its
#: derivative and three products; RoPE's rotation (four products and two
#: sums) and, per pair, the angle, cos and sin
NORM_BWD_OPS = {"rmsnorm_bwd": 10, "add_rmsnorm_bwd": 11,
                "gated_rmsnorm_bwd": 22, "qk_norm_rope_bwd": 10 + 6 + 1.5}

#: bytes of a position tensor of each form (``fused_inputs``): int32 [B,
#: 1], int32 [1], int64 [S]
_POSITION_BYTES = {"rows": lambda B, S: 4 * B, "one": lambda B, S: 4,
                   "seq": lambda B, S: 8 * S}


def rmsnorm_bound(shape, dtype=torch.bfloat16):
    """(ms, bound by, bytes) of ``rmsnorm_fwd`` on x of ``shape`` with w
    of x's dtype."""
    numel, d = int(np.prod(shape)), shape[-1]
    nbytes = 2 * numel * dtype.itemsize + d * dtype.itemsize
    return (*bound(nbytes, NORM_OPS["rmsnorm_fwd"] * numel, torch.float32),
            nbytes)


def _norm_widths(arch: str) -> dict:
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dict(d=cfg.d_model, di=cfg.d_inner, D=cfg.head_dim,
                Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                qk_norm=cfg.use_qk_norm)


def fused_bound(entry: str, arch: str, B: int, S: int, positions=None):
    """(ms, bound by, bytes) of a fused forward at one of the paths'
    launches (``fused_inputs``'s, bf16): its inputs read once (the gated
    norm's z the d_inner columns it reads), its outputs written once,
    RoPE's fp32 inverse frequencies read once."""
    w, es = _norm_widths(arch), 2
    if entry == "add_rmsnorm_fwd":           # x, delta -> normed, sum
        numel = B * S * w["d"]
        nbytes = 4 * numel * es + w["d"] * es
        outs = 2 * numel
    elif entry == "gated_rmsnorm_fwd":       # y, z -> normed
        numel = B * S * w["di"]
        nbytes = 3 * numel * es + w["di"] * es
        outs = numel
    else:                                    # q, k -> q, k rotated
        outs = B * S * (w["Hq"] + w["Hkv"]) * w["D"]
        nbytes = (2 * outs * es + 2 * w["D"] * es * w["qk_norm"]
                  + _POSITION_BYTES[positions](B, S) + 4 * w["D"] // 2)
    return (*bound(nbytes, NORM_OPS[entry] * outs, torch.float32), nbytes)


def norm_bwd_bound(entry: str, arch: str, B: int, S: int):
    """(ms, bound by, bytes) of a backward at one of the train step's
    launches (``bwd_inputs``'s, bf16): the incoming gradients and the
    forward's inputs read once, the gradients written once (dw in w's
    dtype), RoPE's positions (int64) and fp32 inverse frequencies read
    once."""
    w, es = _norm_widths(arch), 2
    if entry == "qk_norm_rope_bwd":          # dq, dk, q, k -> dq, dk
        outs = B * S * (w["Hq"] + w["Hkv"]) * w["D"]
        nbytes = (3 * outs * es + 4 * w["D"] * es * w["qk_norm"]
                  + 4 * w["D"] // 2 + 8 * S)
    else:
        d = w["di"] if entry == "gated_rmsnorm_bwd" else w["d"]
        outs = B * S * d
        acts = {"rmsnorm_bwd": 3,            # dy, x -> dx
                "add_rmsnorm_bwd": 4,        # dh, dr, r -> g
                "gated_rmsnorm_bwd": 5}[entry]   # dout, y, z -> dy, dz
        nbytes = acts * outs * es + 2 * d * es
    return (*bound(nbytes, NORM_BWD_OPS[entry] * outs, torch.float32),
            nbytes)


def split_bound(entry: str, rows: int, d: int, es: int, ws: int):
    """(ms, bound by, bytes) of a split gated norm entry on one rank's
    ``rows`` x ``d`` columns (activations of ``es`` bytes, w of ``ws``):
    the rank's inputs read once, its outputs written once, fp32 row
    sums."""
    act = rows * d * es
    nbytes = {"gated_rmsnorm_sumsq": 2 * act + 4 * rows,
              "gated_rmsnorm_scale": 3 * act + d * ws + 4 * rows,
              "gated_rmsnorm_dot": 3 * act + d * ws + 4 * rows,
              "gated_rmsnorm_scale_bwd": 5 * act + 2 * d * ws
              + 8 * rows}[entry]
    return (*bound(nbytes, SPLIT_OPS[entry] * rows * d, torch.float32),
            nbytes)


# --- paged decode ----------------------------------------------------------

def paged_case(B, P, page, Hq, Hkv, D, lens, seed, L=1):
    """q, pools ``[L, P, page, Hkv, D]`` and a page table whose live
    slots are distinct, shuffled pages (physical order != logical
    order) and whose parked slots point at scratch page 0."""
    r = np.random.default_rng(seed)
    q = r.normal(0, 1, (B, 1, Hq, D)).astype(np.float32)
    kp = r.normal(0, 1, (L, P, page, Hkv, D)).astype(np.float32)
    vp = r.normal(0, 1, (L, P, page, Hkv, D)).astype(np.float32)
    maxp = P - 1
    perm = list(r.permutation(np.arange(1, P)))
    table = np.zeros((B, maxp), np.int32)
    for b, ln in enumerate(lens):
        for i in range(-(-ln // page)):
            table[b, i] = perm.pop()
    return q, kp, vp, table, np.asarray(lens, np.int32)


#: (name, (B, P, page, Hq, Hkv, D, lens), window, softcap)
CASES = [
    ("main", (8, 177, 16, 16, 8, 128,
              [161, 160, 151, 140, 129, 97, 64, 17]), 0, 0.0),
    ("partial-gqa", (2, 16, 8, 4, 2, 16, [5, 23]), 0, 0.0),
    ("mqa", (1, 8, 16, 2, 1, 32, [48]), 0, 0.0),
    ("mha", (3, 32, 4, 8, 8, 64, [1, 9, 17]), 0, 0.0),
    ("d48-odd-heads", (2, 16, 8, 6, 3, 48, [12, 31]), 0, 0.0),
    ("window8", (2, 16, 8, 4, 2, 32, [21, 37]), 8, 0.0),
    ("window8-softcap50", (2, 16, 8, 4, 2, 32, [21, 37]), 8, 50.0),
    ("softcap50-main", (8, 177, 16, 16, 8, 128,
                        [161, 160, 151, 140, 129, 97, 64, 17]), 0, 50.0),
    ("zero-len-row", (3, 16, 16, 16, 8, 128, [0, 7, 40]), 0, 0.0),
    ("qwen3-moe-g8", (8, 177, 16, 32, 4, 128,
                      [161, 160, 151, 140, 129, 97, 64, 17]), 0, 0.0),
    ("full-table", (1, 20, 16, 16, 8, 128, [304]), 0, 0.0),
    ("window64-g8", (2, 177, 16, 32, 4, 128, [161, 100]), 64, 0.0),
    ("len1-main", (8, 177, 16, 16, 8, 128, [1] * 8), 0, 0.0),
    ("table-past-256", (1, 280, 4, 4, 2, 32, [1100]), 0, 0.0),
    ("g8-rows128", (8, 177, 16, 32, 4, 128, [128] * 8), 0, 0.0),
    ("g8-rows129", (8, 177, 16, 32, 4, 128, [129] * 8), 0, 0.0),
]
#: the launches the paged kernel is timed at: (path, case name, layers).
#: The first is the main path's, whose numbers go into chip_smoke.py's
#: JSON line; the last two are the qwen3-moe decode-step profile's rows
#: (context 128, then 129 after a step), on either side of the split's
#: pass boundary: 8 blocks of 16 tokens a pass hold 128 tokens, so a row
#: of 129 takes a second pass
PAGED_TIMED = [("qwen3", "main", 28), ("qwen3-moe", "qwen3-moe-g8", 48),
               ("qwen3-moe rows 128", "g8-rows128", 48),
               ("qwen3-moe rows 129", "g8-rows129", 48)]


def paged_on(arrs, dtype):
    """``paged_case``'s arrays on the card: q and the pools in ``dtype``."""
    q, kp, vp, table, lens = arrs
    f = [torch.from_numpy(a).to(DEVICE, dtype) for a in (q, kp, vp)]
    return f + [torch.from_numpy(a).to(DEVICE) for a in (table, lens)]


def time_paged_launches(label: str) -> list:
    """The paged kernel timed at every launch of PAGED_TIMED, one line
    each; returns the rows, the main path's first."""
    rows = []
    for path, name, layers in PAGED_TIMED:
        t = time_paged(name, layers, 20 * layers)
        print(f"{label} paged {path} {_paged_line(t)}")
        rows.append(_row("paged_attention_fwd", path, t["ker"], t["plain"],
                         t["lib"], t["bound_ms"], t["bound_by"]))
    return rows


def time_paged(name: str, L: int, iters: int) -> dict:
    """The paged kernel at one served launch (bf16, the case ``name`` of
    CASES, L layers' pools cycled so each launch reads its pages from
    device memory as a decode step does) beside its bound, the plain
    version and ``scaled_dot_product_attention`` on K/V already gathered
    (the live pages only) and repeated to the query heads."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         paged_attention_ref)
    cases = {n: shape for n, shape, *_ in CASES}
    B, P, page, Hq, Hkv, D, lens = cases[name]
    dtype = torch.bfloat16
    q, kp, vp, table, ln = paged_on(paged_case(B, P, page, Hq, Hkv, D, lens,
                                               seed=99, L=L), dtype)
    scale = D ** -0.5
    bound_ms, bound_by = paged_bound_ms(B, Hq, D, page, Hkv, lens, dtype)
    # "paged_decode" names the kernel of this tree and of earlier ones
    ker = timed(lambda i: pa_ops.paged_attention(
        q, kp[i % L], vp[i % L], table, ln), iters, "paged_decode",
        floor_ms=bound_ms)
    plain = timed(lambda i: paged_attention_ref(
        q.transpose(1, 2), kp[i % L], vp[i % L], table, ln, scale=scale),
        2 * L, floor_ms=bound_ms)
    npg = -(-max(lens) // page)
    S = npg * page
    kd = [gather_pages(kp[i], table[:, :npg]).movedim(2, 1)
          .repeat_interleave(Hq // Hkv, dim=1).contiguous() for i in range(L)]
    vd = [gather_pages(vp[i], table[:, :npg]).movedim(2, 1)
          .repeat_interleave(Hq // Hkv, dim=1).contiguous() for i in range(L)]
    mask = (torch.arange(S, device=DEVICE)[None, :] < ln[:, None])
    mask = mask[:, None, None, :]
    qs = q.transpose(1, 2)                           # [B, Hq, 1, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda i: sdpa(qs, kd[i % L], vd[i % L], attn_mask=mask,
                               scale=scale), iters, floor_ms=bound_ms)
    lib_err = (sdpa(qs, kd[0], vd[0], attn_mask=mask, scale=scale)
               .transpose(1, 2).float()
               - pa_ops.paged_attention(q, kp[0], vp[0], table, ln).float()
               ).abs().max().item()
    del kd, vd, kp, vp
    _release()
    return dict(ker=ker, plain=plain, lib=lib, lib_err=lib_err,
                bound_ms=bound_ms, bound_by=bound_by,
                shape=(B, Hq, Hkv, D, page, P - 1, max(lens)))


def _paged_line(t: dict) -> str:
    B, Hq, Hkv, D, page, maxp, top = t["shape"]
    return (f"bf16 (B={B}, Hq={Hq}, Hkv={Hkv}, D={D}, page={page}, "
            f"maxp={maxp}, lens<={top}), device time: kernel {us(t['ker'])}, "
            f"plain {us(t['plain'])}, sdpa {us(t['lib'])} (|sdpa - kernel| "
            f"{t['lib_err']:.2g}), bound {t['bound_ms'] * 1e3:.3f} us "
            f"({t['bound_by']}), {t['bound_ms'] / t['ker']['ms']:.3f} of it "
            f"reached")


# --- paged prefill -----------------------------------------------------------

def paged_prefill_bound(B, C, Hq, Hkv, D, page, starts, chunk_lens, dtype):
    """(ms, bound by, bytes, operations) of a chunk call: each prefilling
    row's live K/V pages (``ceil((start + chunk) / page)`` of them), its
    chunk's queries and outputs and its live table slots moved once,
    start and kv_lens read; 4 * D operations per query head and (chunk
    query, attended key) pair: query i of a chunk from ``start`` attends
    ``start + i + 1`` keys.  A row without a chunk needs nothing."""
    es = dtype.itemsize
    act = [(int(s), int(c)) for s, c in zip(starts, chunk_lens) if c > 0]
    pages = sum(-(-(s + c) // page) for s, c in act)
    tokens = sum(c for _, c in act)
    nbytes = (pages * page * Hkv * D * 2 * es + 2 * tokens * Hq * D * es
              + pages * 4 + 8 * B)
    pairs = sum(c * s + c * (c + 1) // 2 for s, c in act)
    ops = 4 * Hq * D * pairs
    return (*bound(nbytes, ops, dtype), nbytes, ops)


def time_paged_prefill_launches(label: str) -> list:
    """The paged-prefill kernel timed at every launch of its cases'
    ``TIMED``, one line each; returns the rows, the chat call's first.
    A package without the kernel (an older checkout) gives none."""
    try:
        from repro_torch.kernels.paged_prefill.cases import TIMED
    except ImportError:
        print(f"{label} paged prefill: not in this package")
        return []
    rows = []
    for path, shape, layers in TIMED:
        t = time_paged_prefill(shape, min(layers, 8), 20 * layers)
        print(f"{label} paged prefill {path} {_paged_prefill_line(t)}")
        rows.append(_row("paged_prefill_fwd", path, t["ker"], t["plain"],
                         t["lib"], t["bound_ms"], t["bound_by"]))
    return rows


def time_paged_prefill(shape, L: int, iters: int) -> dict:
    """The paged-prefill kernel at one chunk call (bf16, L layers' pools
    cycled so each launch reads its pages from device memory) beside its
    bound, the plain version (the page gather of every row's whole table
    and the fp32 masked softmax: the chunk path without the kernel) and
    ``scaled_dot_product_attention`` over the prefilling rows' live pages
    already gathered and repeated to the query heads, with the causal and
    length mask."""
    from repro_torch.kernels.paged_attention.ref import gather_pages
    from repro_torch.kernels.paged_prefill import ops as pp_ops
    from repro_torch.kernels.paged_prefill.cases import prefill_case
    from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref
    B, page, Hq, Hkv, D, C, starts, chunk_lens, maxp = shape
    dtype = torch.bfloat16
    q, kp, vp, table, st, ln = prefill_case(*shape, seed=99)
    P = kp.shape[1]
    gen = torch.Generator(device=DEVICE).manual_seed(99)
    q = torch.from_numpy(q).to(DEVICE, dtype)
    kp = rand(gen, (L, P, page, Hkv, D), dtype)
    vp = rand(gen, (L, P, page, Hkv, D), dtype)
    table, st, ln = (torch.from_numpy(a).to(DEVICE) for a in (table, st, ln))
    scale = D ** -0.5
    bound_ms, bound_by, nbytes, ops = paged_prefill_bound(
        B, C, Hq, Hkv, D, page, starts, chunk_lens, dtype)
    ker = timed(lambda i: pp_ops.paged_prefill(
        q, kp[i % L], vp[i % L], table, st, ln), iters, "paged_prefill",
        floor_ms=bound_ms)
    plain = timed(lambda i: paged_prefill_ref(
        q, kp[i % L], vp[i % L], table, st, ln, scale=scale), 4,
        floor_ms=bound_ms)
    act = torch.nonzero(torch.as_tensor(chunk_lens) > 0)[:, 0].to(DEVICE)
    npg = -(-int(max(np.asarray(starts) + np.asarray(chunk_lens))) // page)
    S = npg * page
    G = Hq // Hkv
    kd = [gather_pages(kp[i], table[act, :npg]).movedim(2, 1)
          .repeat_interleave(G, dim=1).contiguous() for i in range(L)]
    vd = [gather_pages(vp[i], table[act, :npg]).movedim(2, 1)
          .repeat_interleave(G, dim=1).contiguous() for i in range(L)]
    q_pos = st[act, None] + torch.arange(C, device=DEVICE)[None, :]
    k_pos = torch.arange(S, device=DEVICE)
    mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (k_pos[None, None, :] < ln[act, None, None]))[:, None]
    qs = q[act].transpose(1, 2).contiguous()         # [b, Hq, C, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda i: sdpa(qs, kd[i % L], vd[i % L], attn_mask=mask,
                               scale=scale), iters, floor_ms=bound_ms)
    got = pp_ops.paged_prefill(q, kp[0], vp[0], table, st, ln)[act]
    lib_err = (sdpa(qs, kd[0], vd[0], attn_mask=mask, scale=scale)
               .transpose(1, 2).float() - got.float()).abs().max().item()
    del kd, vd, kp, vp
    _release()
    return dict(ker=ker, plain=plain, lib=lib, lib_err=lib_err,
                bound_ms=bound_ms, bound_by=bound_by, nbytes=nbytes,
                ops=ops, shape=(B, int(act.numel()), C, Hq, Hkv, D, page,
                                maxp))


def _paged_prefill_line(t: dict) -> str:
    B, act, C, Hq, Hkv, D, page, maxp = t["shape"]
    return (f"bf16 (B={B}, prefilling {act}, C={C}, Hq={Hq}, Hkv={Hkv}, "
            f"D={D}, page={page}, maxp={maxp}), device time: kernel "
            f"{us(t['ker'])}, plain {us(t['plain'])}, sdpa {us(t['lib'])} "
            f"(|sdpa - kernel| {t['lib_err']:.2g}), bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
            f"{t['nbytes'] / 1e6:.2f} MB, {t['ops'] / 1e9:.3f} GFLOP), "
            f"{t['bound_ms'] / t['ker']['ms']:.3f} of it reached")


# --- flash prefill and dense decode ----------------------------------------

#: gemma2-27b's attention scale: 144^-0.5 (d_model / num_heads), where
#: D is 128
GEMMA2_SCALE = 144 ** -0.5

#: (name, (B, S, Hq, Hkv, D), causal, window, softcap[, scale]): causal
#: and not, window, softcap, S not a multiple of the tiles (64 x 64 in
#: bf16, 64 x 32 in f32), G in {1, 2, 4, 8}, the D > 128 tiling, S over
#: five K/V tiles (the bf16 ring wraps), a window that starts the kv loop
#: past key 0, a D that is a multiple of 8 but not of 16, and the dense
#: main paths' shapes (qwen3-0.6b, zamba2-2.7b's shared attention: D =
#: 80, Hq = Hkv = 32, qwen3-moe-30b-a3b: Hq 32, Hkv 4, G = 8; gemma2-27b's
#: local layers, window 4,096 and softcap 50 at scale 144^-0.5, and its
#: long-context prefill of 4,160 tokens, where the window binds;
#: whisper-large-v3's decoder, D 64 and G 1; pixtral-12b's 128 tokens and
#: 4 patches, S 132; qwen3-0.6b's heads on one of two model ranks, and on
#: one of 16 (phase 31's prefill: Hq 1, Hkv 1)).  The scale is D^-0.5
#: unless given.
FLASH_CASES = [
    ("main", (8, 128, 16, 8, 128), True, 0, 0.0),
    ("mha-ragged", (2, 80, 4, 4, 16), True, 0, 0.0),
    ("gqa2-1.5tiles", (2, 96, 4, 2, 32), True, 0, 0.0),
    ("gqa4", (1, 128, 8, 2, 64), True, 0, 0.0),
    ("window16", (2, 64, 4, 2, 16), True, 16, 0.0),
    ("softcap30", (2, 64, 4, 2, 16), True, 0, 30.0),
    ("window32-softcap50-ragged", (2, 72, 4, 2, 16), True, 32, 50.0),
    ("noncausal", (2, 64, 4, 2, 16), False, 0, 0.0),
    ("noncausal-window24-gqa4", (1, 70, 4, 1, 32), False, 24, 0.0),
    ("d256", (1, 40, 2, 1, 256), True, 0, 0.0),
    ("main-window48-softcap50", (8, 100, 16, 8, 128), True, 48, 50.0),
    ("s320-5tiles-causal", (1, 320, 4, 2, 64), True, 0, 0.0),
    ("s320-5tiles-noncausal", (1, 320, 4, 2, 32), False, 0, 0.0),
    ("s320-window100-softcap20", (1, 320, 2, 1, 32), True, 100, 20.0),
    ("d40-zero-filled", (2, 100, 4, 2, 40), True, 0, 0.0),
    ("zamba2-d80-mha32", (8, 128, 32, 32, 80), True, 0, 0.0),
    ("qwen3-moe-g8", (8, 128, 32, 4, 128), True, 0, 0.0),
    ("gemma2", (8, 128, 32, 16, 128), True, 4096, 50.0, GEMMA2_SCALE),
    ("gemma2-long", (2, 4160, 32, 16, 128), True, 4096, 50.0,
     GEMMA2_SCALE),
    ("whisper", (8, 128, 20, 20, 64), True, 0, 0.0),
    ("pixtral", (8, 132, 32, 8, 128), True, 0, 0.0),
    ("qwen3-tp2", (8, 128, 8, 4, 128), True, 0, 0.0),
    ("qwen3-seq16", (8, 44, 1, 1, 128), True, 0, 0.0),
]

#: (name, (B, S, Hq, Hkv, D, lens), window, softcap[, scale]): lens
#: include 1 and S, S not a multiple of the split, G in {1, 2, 4, 8}, a
#: len-0 row, 8 splits of several passes each, a row that leaves most
#: splits empty, a window that skips whole splits, and the dense main
#: paths' shapes (8 rows at the shared position; gemma2's local layers at
#: 161 slots and at 4,177, where the window skips the first 74 keys;
#: whisper's decoder; pixtral at len + 1 = 163 > S = 161, the decode
#: write clamped onto the last slot: lens = S, the window's end at 163;
#: qwen3-0.6b's heads on one of two model ranks, and phase 31's launch on
#: one of 16 ranks' 16-slot range: every q head, rows that attend none).
#: A len above S is the query's position + 1 past the last slot.
DECODE_CASES = [
    ("main", (8, 161, 16, 8, 128, [145] * 8), 0, 0.0),
    ("main-mixed-lens", (8, 161, 16, 8, 128,
                         [161, 160, 151, 140, 129, 97, 64, 1]), 0, 0.0),
    ("lens-1-and-S", (2, 64, 4, 4, 16, [1, 64]), 0, 0.0),
    ("gqa2-ragged", (2, 96, 8, 4, 32, [96, 40]), 0, 0.0),
    ("gqa4-short", (1, 50, 4, 1, 16, [7]), 0, 0.0),
    ("window16", (3, 130, 8, 2, 64, [130, 1, 77]), 16, 0.0),
    ("softcap30", (2, 70, 4, 2, 32, [70, 33]), 0, 30.0),
    ("window24-softcap50", (2, 100, 4, 2, 32, [100, 65]), 24, 50.0),
    ("d48-odd-heads", (1, 96, 6, 3, 48, [11]), 0, 0.0),
    ("zero-len-row", (2, 64, 4, 2, 16, [0, 9]), 0, 0.0),
    ("s1100-8splits", (2, 1100, 4, 2, 32, [1100, 731]), 0, 0.0),
    ("len3-empty-splits", (3, 200, 4, 2, 32, [3, 200, 150]), 0, 0.0),
    ("window64-skips-splits", (2, 600, 4, 2, 32, [600, 407]), 64, 0.0),
    ("g8-d64", (2, 161, 8, 1, 64, [145, 161]), 0, 0.0),
    ("zamba2-d80-mha32", (8, 161, 32, 32, 80, [145] * 8), 0, 0.0),
    ("qwen3-moe-g8", (8, 161, 32, 4, 128, [145] * 8), 0, 0.0),
    ("gemma2", (8, 161, 32, 16, 128, [145] * 8), 4096, 50.0, GEMMA2_SCALE),
    ("gemma2-long", (2, 4177, 32, 16, 128, [4170] * 2), 4096, 50.0,
     GEMMA2_SCALE),
    ("whisper", (8, 161, 20, 20, 64, [145] * 8), 0, 0.0),
    ("pixtral", (8, 161, 32, 8, 128, [163] * 8), 0, 0.0),
    ("clamped-window", (2, 96, 8, 2, 64, [100, 97]), 40, 30.0),
    ("qwen3-tp2", (8, 144, 8, 4, 128, [144] * 8), 0, 0.0),
    ("qwen3-seq16", (8, 16, 16, 8, 128, [16, 16, 9, 1, 0, 0, 16, 3]), 0,
     0.0),
]

#: the served launch shapes both dense kernels are timed at, by path: the
#: case of that name in FLASH_CASES and in DECODE_CASES; the first is the
#: main path's, whose numbers go into chip_smoke.py's JSON line
TIMED = [("qwen3", "main"), ("zamba2", "zamba2-d80-mha32"),
         ("qwen3-moe", "qwen3-moe-g8"), ("gemma2", "gemma2"),
         ("gemma2-long", "gemma2-long"), ("whisper", "whisper"),
         ("pixtral", "pixtral"), ("qwen3-tp2", "qwen3-tp2")]

#: why ``scaled_dot_product_attention`` has no time beside a launch with
#: a softcap: it cannot compute cap * tanh(s / cap) on the logits
NO_SDPA = "none: SDPA has no softcap"


def case_opts(case) -> dict:
    """A FLASH_CASES or DECODE_CASES entry's window, softcap and scale
    (D^-0.5 unless the entry gives one)."""
    name, shape, *rest = case
    if len(shape) == 5:                       # flash: causal comes first
        rest = rest[1:]
    window, cap, *scale = rest
    return dict(window=window, softcap=cap,
                scale=scale[0] if scale else shape[4] ** -0.5)


def _timing_line(label, shape, t, extra) -> str:
    lib = (NO_SDPA if t["lib"] is None else
           f"{us(t['lib'])} (|sdpa - kernel| {t['lib_err']:.2g})")
    return (f"{label} bf16 {shape}{extra}: device time kernel "
            f"{us(t['ker'])}, plain {us(t['plain'])}, sdpa {lib}; bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ker']['ms']:.3f} of it reached")


def time_flash(B, S, Hq, Hkv, D, L, gen, iters, window=0, softcap=0.0,
               scale=None) -> dict:
    """The flash kernel at one served launch (bf16, causal) beside its
    bound, the plain version and ``scaled_dot_product_attention`` on
    [B, Hq, S, D] with K/V repeated to the query heads (made outside the
    timing; none where the launch has a softcap); L sets of q/k/v cycled
    so each launch reads device memory."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = torch.bfloat16
    scale = D ** -0.5 if scale is None else scale
    opts = dict(window=window, attn_softcap=softcap, scale=scale)
    qs = [rand(gen, (B, S, Hq, D), dtype) for _ in range(L)]
    ks = [rand(gen, (B, S, Hkv, D), dtype) for _ in range(L)]
    vs = [rand(gen, (B, S, Hkv, D), dtype) for _ in range(L)]
    bound_ms, bound_by, nbytes, ops = flash_bound(B, S, Hq, Hkv, D, window,
                                                  dtype)
    ker = timed(lambda i: fa_ops.flash_attention(
        qs[i % L], ks[i % L], vs[i % L], **opts), iters, "flash_fwd",
        floor_ms=bound_ms)
    plain = timed(lambda i: attention_ref(
        qs[i % L].transpose(1, 2), ks[i % L].transpose(1, 2),
        vs[i % L].transpose(1, 2), scale=scale, window=window,
        softcap=softcap), max(L, iters // 10), floor_ms=bound_ms)
    lib, lib_err = None, None
    if softcap == 0.0:       # every served window comes with a softcap
        assert window == 0, window
        G = Hq // Hkv
        qh = [t.transpose(1, 2).contiguous() for t in qs]
        kh = [t.transpose(1, 2).repeat_interleave(G, 1).contiguous()
              for t in ks]
        vh = [t.transpose(1, 2).repeat_interleave(G, 1).contiguous()
              for t in vs]
        kw = dict(is_causal=True, scale=scale)
        lib = timed(lambda i: sdpa(qh[i % L], kh[i % L], vh[i % L], **kw),
                    iters, floor_ms=bound_ms)
        lib_err = (sdpa(qh[0], kh[0], vh[0], **kw).transpose(1, 2).float()
                   - fa_ops.flash_attention(qs[0], ks[0], vs[0], **opts)
                   .float()).abs().max().item()
        del qh, kh, vh
    return dict(ker=ker, plain=plain, lib=lib, lib_err=lib_err,
                bound_ms=bound_ms, bound_by=bound_by,
                nbytes=nbytes, ops=ops)


def time_decode(B, S, Hq, Hkv, D, lens, L, gen, iters, window=0,
                softcap=0.0, scale=None) -> dict:
    """The dense decode kernel at one served launch (bf16, every row at
    one shared position, as the dense path's cache is) beside its bound,
    the plain version and ``scaled_dot_product_attention`` of the 1-token
    query against the attended K/V repeated to Hq (made outside the
    timing; none where the launch has a softcap)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = torch.bfloat16
    scale = D ** -0.5 if scale is None else scale
    opts = dict(window=window, attn_softcap=softcap, scale=scale)
    ends = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    ln = torch.clamp(ends, max=S)
    pos = torch.tensor(lens[0] - 1, dtype=torch.int32, device=DEVICE)
    qs = [rand(gen, (B, 1, Hq, D), dtype) for _ in range(L)]
    kc = [rand(gen, (B, S, Hkv, D), dtype) for _ in range(L)]
    vc = [rand(gen, (B, S, Hkv, D), dtype) for _ in range(L)]
    bound_ms, bound_by, nbytes, ops = decode_bound(B, S, Hq, Hkv, D, lens,
                                                   window, dtype)
    ker = timed(lambda i: da_ops.decode_attention(
        qs[i % L], kc[i % L], vc[i % L], pos, **opts), iters,
        "dense_decode", floor_ms=bound_ms)
    plain = timed(lambda i: decode_attention_ref(
        qs[i % L].transpose(1, 2), kc[i % L], vc[i % L], ln, scale=scale,
        window=window, softcap=softcap, ends=ends), max(L, iters // 10),
        floor_ms=bound_ms)
    lib, lib_err = None, None
    if softcap == 0.0:
        hi = min(lens[0], S)
        lo = max(0, lens[0] - window) if window else 0
        qh = [t.transpose(1, 2).contiguous() for t in qs]
        kh = [t[:, lo:hi].transpose(1, 2).repeat_interleave(Hq // Hkv, 1)
              .contiguous() for t in kc]
        vh = [t[:, lo:hi].transpose(1, 2).repeat_interleave(Hq // Hkv, 1)
              .contiguous() for t in vc]
        lib = timed(lambda i: sdpa(qh[i % L], kh[i % L], vh[i % L],
                                   scale=scale), iters, floor_ms=bound_ms)
        lib_err = (sdpa(qh[0], kh[0], vh[0], scale=scale).transpose(1, 2)
                   .float() - da_ops.decode_attention(
                       qs[0], kc[0], vc[0], pos, **opts).float()
                   ).abs().max().item()
        del qh, kh, vh
    return dict(ker=ker, plain=plain, lib=lib, lib_err=lib_err,
                bound_ms=bound_ms, bound_by=bound_by, nbytes=nbytes, ops=ops)


def time_served_shapes(label: str, L: int) -> list:
    """Both dense attention kernels timed at every served launch shape
    (bf16; L sets of inputs cycled so each launch reads from device
    memory, as a step does), one line each; returns the rows, each
    kernel's main path first."""
    gen = torch.Generator(device=DEVICE).manual_seed(99)
    rows = []
    for kernel, cases, fn in (("flash", FLASH_CASES, time_flash),
                              ("decode", DECODE_CASES, time_decode)):
        by_name = {case[0]: case for case in cases}
        for n, (path, name) in enumerate(TIMED):
            case = by_name[name]
            shape = case[1]
            o = case_opts(case)
            t = fn(*shape, L, gen, (20 if n == 0 else 10) * L, **o)
            opts = (f", window {o['window']}" if o["window"] else "") + (
                f", softcap {o['softcap']:g}" if o["softcap"] else "") + (
                f", scale {o['scale']:.4g}")
            extra = (f" causal{opts}, {t['nbytes'] / 1e6:.2f} MB, "
                     f"{t['ops'] / 1e9:.3f} GFLOP" if kernel == "flash" else
                     f" lens {shape[-1][0]}{opts}, "
                     f"{t['nbytes'] / 1e6:.2f} MB")
            print(_timing_line(f"{label} {kernel} {path}", tuple(shape[:5]),
                               t, extra))
            rows.append(_row(f"{kernel}_attention_fwd", path, t["ker"],
                             t["plain"], t["lib"], t["bound_ms"],
                             t["bound_by"]))
            del t
            _release()
    return rows


# --- the SSD scan ----------------------------------------------------------

def ssd_key(xb, B_mat, chunk, initial_state) -> tuple:
    """What fixes an SSD launch's work and memory walk: xb's shape, G and
    N, the chunk, whether an initial state is read, and B's strides (C's
    are the same on every path)."""
    return (tuple(xb.shape), tuple(B_mat.shape[2:]), chunk,
            initial_state is not None, B_mat.stride())


def time_ssd(label: str, name: str) -> tuple:
    """The SSD kernel at one served launch (bf16, the case ``name`` of
    ``cases.py``; eight sets of inputs cycled, over 300 MB against the 50
    MB L2, so each launch reads from device memory as a prefill's layers
    do) beside its bound and the plain version; prints one line.  No
    single PyTorch call computes the scan, so there is no library time.
    Returns (the row, the launch's ``ssd_key``)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.cases import SSD_CASES, ssd_case_on
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    cases = {n: (shape, init) for n, shape, init in SSD_CASES}
    (B, S, H, P, G, N, chunk), init = cases[name]
    dtype = torch.bfloat16
    ins = [ssd_case_on(DEVICE, dtype, B, S, H, P, G, N, init, 99 + k)
           for k in range(8)]
    key = ssd_key(ins[0][0], ins[0][2], chunk, ins[0][4])
    bound_ms, bound_by, nbytes, ops = ssd_bound_ms(B, S, H, P, G, N, chunk,
                                                   dtype, init)
    # "ssd_scan" names the kernels of this tree and of earlier ones
    ker = timed(lambda i: ssd_ops.ssd_scan(
        *ins[i % 8][:4], chunk=chunk, initial_state=ins[i % 8][4]),
        80, "ssd_scan", floor_ms=bound_ms)
    plain = timed(lambda i: ssd_scan_ref(
        *ins[i % 8][:4], chunk=chunk, initial_state=ins[i % 8][4]), 16,
        floor_ms=bound_ms)
    print(f"{label} ssd {name} bf16 (B={B}, S={S}, H={H}, P={P}, G={G}, "
          f"N={N}, chunk={chunk}, initial state {init or 'none'}, B/C "
          f"strides {tuple(ins[0][2].stride())}), device time: kernel "
          f"{us(ker)}, plain {us(plain)}, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP), "
          f"{bound_ms / ker['ms']:.3f} of it reached; library: none (no "
          f"single PyTorch call computes the chunked scan)")
    del ins
    _release()
    return _row("ssd_scan_fwd", name, ker, plain, None, bound_ms,
                bound_by), key


# --- the RMSNorm kernels ---------------------------------------------------

def norm_cases():
    """This checkout's ``kernels/rmsnorm/cases.py``, loaded from its file
    (it imports the package only inside its functions), so that the
    timers time another checkout's package at this tree's shapes and
    against this tree's unfused sequences."""
    path = Path(__file__).resolve().parents[1] / "kernels" / "rmsnorm" \
        / "cases.py"
    spec = importlib.util.spec_from_file_location("kernel_bench_norm_cases",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over one bf16 ulp at |b| (8 significant bits)."""
    b = b.float()
    e = torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126)))
    return ((a.float() - b).abs() / torch.exp2(e - 7)).max().item()


def differ(got, want) -> int:
    """Elements of ``got`` that differ from ``want`` (outputs of one call:
    a tensor or a tuple of them)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    n = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{g.shape} {g.dtype} vs {w.shape} "
                                 f"{w.dtype}")
        n += int((g != w).sum())
    return n


def fused_inputs(entry: str, arch: str, B: int, S: int, positions, seed):
    """Inputs of one fused kernel at one of the paths' launches (bf16, the
    arch's widths; random values from ``seed``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import mamba2_dims
    cfg, dtype = get_config(arch), torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def weight(d):
        return 1 + 0.1 * rand(gen, (d,), dtype)
    if entry == "add_rmsnorm_fwd":
        d = cfg.d_model
        return (rand(gen, (B, S, d), dtype), rand(gen, (B, S, d), dtype),
                weight(d))
    if entry == "gated_rmsnorm_fwd":
        dm = mamba2_dims(cfg)
        z = rand(gen, (B, S, dm["in_dim"]), dtype)[..., :dm["di"]]
        return rand(gen, (B, S, dm["di"]), dtype), z, weight(dm["di"])
    hd = cfg.head_dim
    q = rand(gen, (B, S, cfg.num_heads, hd), dtype)
    k = rand(gen, (B, S, cfg.num_kv_heads, hd), dtype)
    wq, wk = ((weight(hd), weight(hd)) if cfg.use_qk_norm else (None, None))
    pos = {"rows": lambda: torch.randint(128, 161, (B, 1), generator=gen,
                                         device=DEVICE, dtype=torch.int32),
           "one": lambda: torch.full((1,), 150, dtype=torch.int32,
                                     device=DEVICE),
           "seq": lambda: torch.arange(S, device=DEVICE)}[positions]()
    return q, k, wq, wk, pos


def time_norm_kernels(label: str, C) -> list:
    """``rmsnorm_fwd`` at ``C.RMSNORM_TIMED`` beside its bound, the plain
    version and ``torch.nn.functional.rms_norm``; then each fused kernel at
    ``C.FUSED_TIMED`` beside its bound, its plain version and the unfused
    card sequence it replaces (device time of all its kernels), with the
    elements that differ from that sequence (none may), eight inputs
    cycled.  A package without the fused kernels (an earlier checkout's)
    has only the unfused sequences timed.  One line each; returns the
    rows."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.configs import get_config
    dtype, rows = torch.bfloat16, []
    lib_fn = torch.nn.functional.rms_norm
    for name, shape in C.RMSNORM_TIMED.items():
        ins = [C.rmsnorm_case_on(DEVICE, dtype, dtype, shape, "dense", 50 + j)
               for j in range(8)]
        d = shape[-1]
        bound_ms, bound_by, nbytes = rmsnorm_bound(shape, dtype)
        # "norm_kernel" names the row kernels of this tree and of earlier ones
        ker = timed(lambda i: rms_ops.rmsnorm(*ins[i % 8], 1e-6), 400,
                    "norm_kernel", floor_ms=bound_ms)
        plain = timed(lambda i: rms_ref.rmsnorm_ref(*ins[i % 8], 1e-6), 100,
                      floor_ms=bound_ms)
        lib = timed(lambda i: lib_fn(ins[i % 8][0], (d,), ins[i % 8][1],
                                     1e-6), 400, floor_ms=bound_ms)
        x, w = ins[0]
        ulps = bf16_ulps(lib_fn(x, (d,), w, 1e-6), rms_ops.rmsnorm(x, w, 1e-6))
        rows.append(_row("rmsnorm_fwd", name, ker, plain, lib, bound_ms,
                         bound_by))
        print(f"{label} rmsnorm {name} bf16 {tuple(shape)}: device time "
              f"kernel {us(ker)}, plain {us(plain)}, F.rms_norm "
              f"{us(lib)}, bound {bound_ms * 1e3:.4f} us ({bound_by}: "
              f"{nbytes / 1e6:.3f} MB); F.rms_norm vs kernel max "
              f"{ulps:.2f} bf16 ulp: "
              f"{'the same' if ulps <= 1 else 'not the same'} function to "
              f"1 ulp")
        del ins
    fused = hasattr(rms_ops, "add_rmsnorm")
    for entry, launches in C.FUSED_TIMED.items():
        op = entry[:-4]
        for name, arch, B, S, *pos in launches:
            theta = get_config(arch).rope_theta
            extra = (theta,) if pos else ()
            ins = [fused_inputs(entry, arch, B, S, pos[0] if pos else None,
                                60 + j) for j in range(8)]
            iters = 400 if S == 1 else 100
            bound_ms, bound_by, nbytes = fused_bound(
                entry, arch, B, S, pos[0] if pos else None)
            unfused_fn = getattr(C, f"{op}_unfused")
            unf = timed(lambda i: unfused_fn(*ins[i % 8], *extra, 1e-6),
                        iters // 4, floor_ms=bound_ms)
            shapes = tuple(tuple(t.shape) for t in ins[0] if t is not None
                           and t.dim() > 1)
            if not fused:
                print(f"{label} {op} {name} bf16 {shapes}: device time of "
                      f"the unfused card sequence {us(unf)} (this package "
                      f"has no fused kernel)")
                continue
            fn = getattr(rms_ops, op)
            plain_fn = getattr(rms_ref, f"{op}_ref")
            ker = timed(lambda i: fn(*ins[i % 8], *extra, 1e-6), iters,
                        "qk_norm_rope_kernel" if pos else "norm_kernel",
                        floor_ms=bound_ms)
            plain = timed(lambda i: plain_fn(*ins[i % 8], *extra, 1e-6),
                          iters // 4, floor_ms=bound_ms)
            got = fn(*ins[0], *extra, 1e-6)
            diff = differ(got, unfused_fn(*ins[0], *extra, 1e-6))
            if diff:
                raise AssertionError(f"{op} {name}: {diff} elements differ "
                                     f"from the unfused card sequence")
            rows.append(_row(entry, name, ker, plain, None, bound_ms,
                             bound_by))
            print(f"{label} {op} {name} bf16 {shapes}"
                  f"{' positions ' + pos[0] if pos else ''}: device time "
                  f"kernel {us(ker)}, plain {us(plain)}, unfused card "
                  f"sequence {us(unf)} ({unf['ms'] / ker['ms']:.1f}x the "
                  f"kernel); bound {bound_ms * 1e3:.4f} us ({bound_by}: "
                  f"{nbytes / 1e6:.3f} MB), {bound_ms / ker['ms']:.3f} of it "
                  f"reached; {diff} elements differ from the unfused "
                  f"sequence; library: none (no single PyTorch call "
                  f"computes it)")
            del ins
    _release()
    return rows


def time_split_norm(label: str, C) -> list:
    """Each split entry at its path's launch (``C.SPLIT_TIMED``: one of
    two ranks' columns of chip_smoke.py phase 33's bf16 prefill for the
    forward, of its f32 train step for the backward) beside its bound
    (the rank's inputs read once, its outputs written once) and its plain
    version; no single PyTorch call computes any of them.  Four inputs
    cycled.  A package without them (an earlier checkout's) is skipped.
    One line each; returns the rows."""
    from repro_torch.kernels.rmsnorm import kernel as K
    from repro_torch.kernels.rmsnorm import ref as R
    from repro_torch.kernels.rmsnorm.ops import row_view
    if not hasattr(K, "gated_rmsnorm_sumsq"):
        print(f"{label}: this package has no split gated norm")
        return []
    cases = {c[0]: c for c in C.SPLIT_CASES}
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    rows = []
    for entry, (name, dt) in C.SPLIT_TIMED.items():
        _, shape, M = cases[name]
        dtype, D = dts[dt], shape[-1]
        ins = []
        for j in range(4):
            _, blocks = C.split_case_on(DEVICE, dtype, dtype, shape, M,
                                        80 + j)
            y, z, dout = (row_view(t) for t in blocks[0][:3])
            w = blocks[0][3]
            # the rank's sums stand in for the sums over the ranks
            ss = K.gated_rmsnorm_sumsq(y, z) * M
            dot = K.gated_rmsnorm_dot(dout, y, z, w) * M
            ins.append((y, z, dout, w, ss, dot))
        calls = {
            "gated_rmsnorm_sumsq": (
                lambda i: K.gated_rmsnorm_sumsq(*ins[i % 4][:2]),
                lambda i: R.gated_rmsnorm_sumsq_ref(*ins[i % 4][:2])),
            "gated_rmsnorm_scale": (
                lambda i: K.gated_rmsnorm_scale(
                    *ins[i % 4][:2], ins[i % 4][3], ins[i % 4][4],
                    d_total=D, eps=1e-6),
                lambda i: R.gated_rmsnorm_scale_ref(
                    *ins[i % 4][:2], ins[i % 4][3], ins[i % 4][4], D)),
            "gated_rmsnorm_dot": (
                lambda i: K.gated_rmsnorm_dot(ins[i % 4][2], *ins[i % 4][:2],
                                              ins[i % 4][3]),
                lambda i: R.gated_rmsnorm_dot_ref(
                    ins[i % 4][2], *ins[i % 4][:2], ins[i % 4][3])),
            "gated_rmsnorm_scale_bwd": (
                lambda i: K.gated_rmsnorm_scale_bwd(
                    ins[i % 4][2], *ins[i % 4][:2], *ins[i % 4][3:],
                    d_total=D, eps=1e-6),
                lambda i: R.gated_rmsnorm_scale_bwd_ref(
                    ins[i % 4][2], *ins[i % 4][:2], *ins[i % 4][3:], D)),
        }
        kfn, pfn = calls[entry]
        # the two forward entries and dot are one launch each (norm_kernel
        # and gated_dot_kernel); scale_bwd two (the row kernel, dw's sum)
        name_of = {"gated_rmsnorm_sumsq": "norm_kernel",
                   "gated_rmsnorm_scale": "norm_kernel",
                   "gated_rmsnorm_dot": "gated_dot_kernel"}.get(entry, "")
        y, w = ins[0][0], ins[0][3]
        n, d = y.shape
        bound_ms, bound_by, nbytes = split_bound(
            entry, n, d, y.element_size(), w.element_size())
        ker = timed(kfn, 100, name_of, 0 if name_of else 2,
                    floor_ms=bound_ms)
        split = ("" if name_of else
                 f" ({bwd_launches(kfn, 100)})")
        plain = timed(pfn, 25, floor_ms=bound_ms)
        rows.append(_row(entry, name, ker, plain, None, bound_ms, bound_by))
        print(f"{label} {entry} {name} {dt} (one of {M} ranks: {n} rows "
              f"x {d} of {D} columns): device time kernel {us(ker)}"
              f"{split}, plain "
              f"{us(plain)}; bound {bound_ms * 1e3:.4f} us ({bound_by}: "
              f"{nbytes / 1e6:.3f} MB), {bound_ms / ker['ms']:.3f} of it "
              f"reached; library: none (no single PyTorch call computes "
              f"it)")
        del ins
    _release()
    return rows


def bwd_inputs(entry: str, arch: str, B: int, S: int, seed: int):
    """The backward kernel's inputs at one of the train step's launches
    (bf16, the arch's widths, random values from ``seed``): the forward's
    inputs as the model passes them (the gated norm's z a slice of the
    Mamba2 input projection) and the incoming gradients, dense."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm.ops import inv_freq, row_view
    if entry == "qk_norm_rope_bwd":
        q, k, wq, wk, pos = fused_inputs("qk_norm_rope_fwd", arch, B, S,
                                         "seq", seed)
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        freq = inv_freq(q.device, q.shape[-1], get_config(arch).rope_theta)
        return (rand(gen, q.shape, q.dtype), rand(gen, k.shape, k.dtype),
                q, k, wq, wk, pos, freq)
    fwd = {"rmsnorm_bwd": "add_rmsnorm_fwd", "add_rmsnorm_bwd":
           "add_rmsnorm_fwd", "gated_rmsnorm_bwd": "gated_rmsnorm_fwd"}[entry]
    a, b, w = fused_inputs(fwd, arch, B, S, None, seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    dy = row_view(rand(gen, a.shape, a.dtype))
    if entry == "rmsnorm_bwd":
        return dy, row_view(a), w
    if entry == "add_rmsnorm_bwd":
        return dy, row_view(rand(gen, a.shape, a.dtype)), row_view(a), w
    return dy, row_view(a), row_view(b), w


def bwd_plain(entry: str, ins, theta: float):
    """The plain formula on ``bwd_inputs``'s arguments (``theta``: RoPE's,
    of the arch)."""
    from repro_torch.kernels.rmsnorm import ref as R
    if entry == "qk_norm_rope_bwd":
        dq, dk, q, k, wq, wk, pos, _ = ins
        return R.qk_norm_rope_bwd_ref(dq, dk, q, k, wq, wk, pos, theta,
                                      1e-6)
    if entry == "rmsnorm_bwd":
        dy, x, w = ins
        return R.rmsnorm_bwd_ref(dy, x, w, 1e-6)
    if entry == "add_rmsnorm_bwd":
        dh, dr, r, w = ins
        return R.add_rmsnorm_bwd_ref(dh, dr, r, w, 1e-6)
    dout, y, z, w = ins
    return R.gated_rmsnorm_bwd_ref(dout, y, z, w, 1e-6)


def time_norm_bwd_kernels(label: str, C) -> list:
    """Each backward kernel at the train step's launch (``C.BWD_TIMED``,
    bf16): device time of its two launches, beside its bound, its plain
    formula and, for ``rmsnorm_bwd``, the backward of
    ``torch.nn.functional.rms_norm`` under autograd (the library time);
    four inputs cycled.  One line each; returns the rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import kernel as K
    rows = []
    for entry, launches in C.BWD_TIMED.items():
        fn = getattr(K, entry)
        for name, arch, B, S in launches:
            theta = get_config(arch).rope_theta
            ins = [bwd_inputs(entry, arch, B, S, 70 + j) for j in range(4)]
            if entry == "qk_norm_rope_bwd":
                def call(i):
                    dq, dk, q, k, wq, wk, pos, freq = ins[i % 4]
                    return fn(dq, dk, q, k, wq, wk, pos, freq, eps=1e-6)
            else:
                def call(i):
                    return fn(*ins[i % 4], eps=1e-6)
            bound_ms, bound_by, nbytes = norm_bwd_bound(entry, arch, B, S)
            # the row kernel and dw's sum
            ker = timed(call, 40, per_call=2, floor_ms=bound_ms)
            split = bwd_launches(call, 40)
            plain = timed(lambda i: bwd_plain(entry, ins[i % 4], theta),
                          10, floor_ms=bound_ms)
            lib = None
            if entry == "rmsnorm_bwd":
                dy, x, w = ins[0]
                xr = x.detach().requires_grad_(True)
                wr = w.detach().requires_grad_(True)
                y = torch.nn.functional.rms_norm(xr, (x.shape[-1],), wr,
                                                 1e-6)
                lib = timed(lambda i: torch.autograd.grad(
                    y, (xr, wr), dy, retain_graph=True), 40,
                    floor_ms=bound_ms)
            rows.append(_row(entry, name, ker, plain, lib, bound_ms,
                             bound_by))
            shapes = tuple(tuple(t.shape) for t in ins[0]
                           if t is not None and t.dim() > 1)
            print(f"{label} {entry} {name} bf16 {shapes}: device time "
                  f"kernel {us(ker)} ({split}), plain {us(plain)}"
                  + (f", F.rms_norm's backward under autograd {us(lib)}"
                     if lib else ", library: none (no single PyTorch call)")
                  + f"; bound {bound_ms * 1e3:.3f} us ({bound_by}: "
                  f"{nbytes / 1e6:.2f} MB), {bound_ms / ker['ms']:.3f} of "
                  f"it reached")
            del ins
            gc.collect()
    torch.cuda.empty_cache()
    return rows


def time_all(label: str) -> list:
    """Every kernel at every launch the timers know: the paged kernel,
    the paged-prefill kernel, both dense attention kernels, the SSD scan
    (both SSM paths' launches and one model rank's of each), the forward
    RMSNorm kernels, the split gated norm and the backward kernels.
    Returns the rows."""
    from repro_torch.kernels.ssd_scan.cases import SSD_MAIN, SSD_TP
    rows = time_paged_launches(label)
    rows += time_paged_prefill_launches(label)
    rows += time_served_shapes(label, 28)       # qwen3-0.6b's layers
    for name in list(SSD_MAIN.values()) + list(SSD_TP.values()):
        rows.append(time_ssd(label, name)[0])
    C = norm_cases()
    rows += time_norm_kernels(label, C)
    rows += time_split_norm(label, C)
    rows += time_norm_bwd_kernels(label, C)
    return rows


# --- the CPU: plain versions alone ------------------------------------------

def time_plain_on_cpu(emit) -> dict:
    """The plain versions at the JAX tool's CPU sizes, host time per call:
    causal attention (1 x 4 q heads over 2 kv heads, D 64) at S 128, 256
    and 512; the SSD scan (8 heads of 64, N 64, chunk 64) at S 256 and
    1024; RMSNorm [256, 512].  Each row labelled ``plain``."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.tools.common import timed as host_timed
    rng = np.random.default_rng(0)
    payload = {}

    def f32(*shape, sd=1.0):
        return torch.from_numpy(rng.normal(0, sd, shape).astype(np.float32))
    for S in (128, 256, 512):
        q, k, v = f32(1, 4, S, 64), f32(1, 2, S, 64), f32(1, 2, S, 64)
        t = host_timed(lambda: attention_ref(q, k, v, scale=0.125))
        flops = 4 * 1 * 4 * S * S * 64
        payload[f"attn_plain_S{S}"] = {"us": t * 1e6,
                                       "gflops": flops / t / 1e9}
        emit(f"kernel_attn_plain_S{S}", round(t * 1e6, 1),
             f"us_per_call;plain;gflops={flops / t / 1e9:.1f}")
    for S in (256, 1024):
        xb, B, C = f32(1, S, 8, 64, sd=.5), f32(1, S, 1, 64, sd=.5), \
            f32(1, S, 1, 64, sd=.5)
        a = -f32(1, S, 8, sd=.3).abs()
        t = host_timed(lambda: ssd_scan_ref(xb, a, B, C, chunk=64))
        payload[f"ssd_plain_S{S}"] = {"us": t * 1e6}
        emit(f"kernel_ssd_plain_S{S}", round(t * 1e6, 1),
             "us_per_call;plain")
    x, w = f32(256, 512), torch.ones(512)
    t = host_timed(lambda: rmsnorm_ref(x, w, 1e-6))
    payload["rmsnorm_plain"] = {"us": t * 1e6}
    emit("kernel_rmsnorm_plain", round(t * 1e6, 1), "us_per_call;plain")
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: every kernel on the card) or "
                         "cpu (the plain versions alone)")
    args = ap.parse_args(argv)
    from repro_torch.tools.common import device, emit, save_result
    if device(args.device).type == "cpu":
        payload = time_plain_on_cpu(emit)
    else:
        from repro_torch.kernels import build
        build.build_all()
        card = card_line()
        payload = {"device": {"kind": torch.cuda.get_device_name(0),
                              "card": card}}
        for r in time_all("kernel bench"):
            payload[f"{r['kernel']}|{r['launch']}"] = r
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.6g}")
            emit(f"kernel_{r['kernel']}_{r['launch'].replace(' ', '_')}",
                 f"{r['ms']:.6g}",
                 f"device_ms;bound_ms={r['bound_ms']:.6g} "
                 f"({r['bound_by']});plain_ms={r['plain_ms']:.6g};"
                 f"library_ms={lib}")
        print(card)
    save_result("kernels", payload)
    return payload


if __name__ == "__main__":
    main()
