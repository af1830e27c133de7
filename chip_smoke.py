#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  The phases run in order, each prints one line of its numbers,
and any failure exits non-zero:

1. device and build: the hand-written CUDA kernels are compiled from the
   checkout's sources with ``nvcc`` into ``build/kernels/``;
2. kernel vs plain: the paged-decode kernel against its plain PyTorch
   version on the card (f32 atol/rtol 2e-5, bf16 2e-2), then timed with
   CUDA events at the main path's shapes beside its bound, the plain
   version and ``scaled_dot_product_attention`` on the gathered K/V;
3. the main path: ``repro_torch.launch.serve.main`` serves 8 requests
   with the full-width, full-depth qwen3-0.6b (bf16, random weights from
   a seed); every request must complete and the kernel must have been
   launched once per layer per decode step;
4. card vs CPU: the same full-width qwen3-0.6b in f32 (TF32 off), one
   32-token prefill chunk for 2 rows and 4 decode steps, on the card
   (kernel) and on the CPU (plain): greedy tokens equal, logits within
   ``PARITY_ATOL``.

The last three lines are the card's name and power limit as
``nvidia-smi`` gives them, a JSON line describing each kernel, and the
JSON status line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM: device memory rate, and peak rates without sparsity (bf16 on
#: the tensor cores; f32 outside them, since TF32 is off)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: phase 4: f32 logits on the card vs the CPU.  Both sides compute in
#: f32, but in another order (cuBLAS vs the CPU BLAS, the kernel's
#: online softmax over pages vs one softmax over the gathered row);
#: relative rounding of ~1e-6 per product, compounded over 28 layers,
#: stays orders of magnitude below this bound on logits of order 1, and
#: far below the gap between the top two logits that decides each
#: greedy token.
PARITY_ATOL = 2e-3

#: where phases 2 and 4 put the kernel's side (the card)
DEVICE = "cuda"

MAIN_ARGV = ["--arch", "qwen3-0.6b", "--requests", "8", "--prompt-len",
             "128", "--decode-steps", "32", "--budget-gb", "8",
             "--device", "cuda"]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device_and_build() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card: "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = [ln.split("ptxas info    :")[-1].strip()
             for out in reports.values() for ln in out.splitlines()
             if "Used" in ln]
    card = card_line()
    print(f"phase 1 device+build: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}); built {len(reports)} kernel "
          f"source(s) in {secs:.2f}s; ptxas: {' | '.join(ptxas)}")
    print(card)
    return card


# --- phase 2 -----------------------------------------------------------------

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
]


def _to(arrs, dtype):
    q, kp, vp, table, lens = arrs
    f = [torch.from_numpy(a).to(DEVICE, dtype) for a in (q, kp, vp)]
    return f + [torch.from_numpy(a).to(DEVICE) for a in (table, lens)]


def _cuda_ms(fn, iters: int) -> float:
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


def paged_bound_ms(q, page, Hkv, lens, dtype):
    """Least time for the card: each live K/V page, q, the output, the
    live table slots and lens moved once; 4 * Hq * D operations per live
    token (q.k and p.v, multiply and add)."""
    B, _, Hq, D = q.shape
    es = torch.empty((), dtype=dtype).element_size()
    pages = sum(-(-int(n) // page) for n in lens)
    nbytes = (pages * page * Hkv * D * 2 * es + 2 * B * Hq * D * es
              + pages * 4 + B * 4)
    ops = 4 * Hq * D * int(sum(int(n) for n in lens))
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_vs_plain() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         paged_attention_ref)
    errs, worst = [], 0.0
    for seed, (name, (B, P, page, Hq, Hkv, D, lens), window, cap) in \
            enumerate(CASES):
        arrs = paged_case(B, P, page, Hq, Hkv, D, lens, seed=seed)
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, ln = _to(arrs, dtype)
            kp, vp = kp[0], vp[0]
            out = pa_ops.paged_attention(q, kp, vp, table, ln, window=window,
                                         attn_softcap=cap)
            ref = paged_attention_ref(q.transpose(1, 2), kp, vp, table, ln,
                                      scale=D ** -0.5, window=window,
                                      softcap=cap).transpose(1, 2)
            torch.cuda.synchronize()
            live = ln >= 1       # the plain version averages len-0 rows
            if not torch.all(out[~live] == 0):
                raise AssertionError(f"{name}: a len == 0 row is not zero")
            a, b = out[live].float(), ref[live].float()
            err = (a - b).abs().max().item()
            tol = TOL[dtype]
            if not torch.allclose(a, b, atol=tol, rtol=tol):
                raise AssertionError(f"{name} {dtype}: kernel vs plain "
                                     f"max abs err {err:.3g} > {tol}")
            worst = max(worst, err)
            errs.append(f"{name}/{str(dtype)[6:]}={err:.2g}")

    # timing at the main path's shapes, pools of all 28 layers cycled so
    # each launch reads its pages from device memory as a decode step does
    _, (B, P, page, Hq, Hkv, D, lens), _, _ = CASES[0]
    L, dtype = get_config("qwen3-0.6b").num_layers, torch.bfloat16
    q, kp, vp, table, ln = _to(paged_case(B, P, page, Hq, Hkv, D, lens,
                                          seed=99, L=L), dtype)
    scale = D ** -0.5
    ms = _cuda_ms(lambda i: pa_ops.paged_attention(
        q, kp[i % L], vp[i % L], table, ln), 20 * L)
    plain_ms = _cuda_ms(lambda i: paged_attention_ref(
        q.transpose(1, 2), kp[i % L], vp[i % L], table, ln, scale=scale),
        2 * L)
    # the yardstick: one library call on K/V already gathered (the live
    # pages only) and repeated to the query heads
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
    library_ms = _cuda_ms(lambda i: sdpa(qs, kd[i % L], vd[i % L],
                                         attn_mask=mask, scale=scale),
                          20 * L)
    lib_err = (sdpa(qs, kd[0], vd[0], attn_mask=mask, scale=scale)
               .transpose(1, 2).float()
               - pa_ops.paged_attention(q, kp[0], vp[0], table, ln).float()
               ).abs().max().item()
    bound_ms, bound_by = paged_bound_ms(q, page, Hkv, lens, dtype)
    print(f"phase 2 kernel vs plain: {len(errs)} cases ok, max abs err "
          f"{worst:.3g} [{' '.join(errs)}]; main shapes bf16 (B={B}, "
          f"Hq={Hq}, Hkv={Hkv}, D={D}, page={page}, maxp={P - 1}, "
          f"lens<={max(lens)}): kernel {ms * 1e3:.2f} us, plain "
          f"{plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} us "
          f"(|sdpa - kernel| {lib_err:.2g}), bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# --- phase 3 -----------------------------------------------------------------

def phase_main_path() -> int:
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.launch import serve
    cfg = get_config("qwen3-0.6b")
    torch.cuda.reset_peak_memory_stats()
    pa_kernel.paged_attention_fwd.launches = 0
    out = serve.main(MAIN_ARGV)
    launches = pa_kernel.paged_attention_fwd.launches
    summary, backends = out["summary"], out["backends"]
    calls = sum(be.decode_calls for be in backends)
    if summary["completed"] != 8:
        raise AssertionError(f"served {summary['completed']}/8 requests")
    for r in out["engine"].requests:
        if len(r.tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens "
                                 f"of {r.max_new_tokens}, or out of vocab")
    if not (cfg.num_layers == 28 and launches == cfg.num_layers * calls
            and launches > 0):
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{calls} decode steps x {cfg.num_layers} "
                             f"layers")
    dec_s = sum(be.decode_seconds for be in backends)
    tok = summary["good_tokens"]
    print(f"phase 3 main path: qwen3-0.6b full ({cfg.num_layers} layers, "
          f"d={cfg.d_model}, {cfg.param_dtype}) served "
          f"{summary['completed']}/8 requests, {tok} tokens in "
          f"{out['wall_s']:.2f}s wall ({tok / out['wall_s']:.1f} tok/s); "
          f"{calls} decode steps, mean {1e3 * dec_s / calls:.2f} ms/step; "
          f"paged-decode kernel launched {launches} = {cfg.num_layers} x "
          f"{calls}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    decode_step_profile(backends[0])
    return launches


def decode_step_profile(be, batch: int = 8, steps: int = 5) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    decode steps with the phase-3 backend's weights and page pool size,
    every row of the batch live (context 128 on distinct pages), each
    step ending in the greedy read-back as in serving; timed first
    without the profiler and then under it.  Device busy time is the sum
    of the kernels' times (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_lib
    from repro_torch.train.step import build_paged_decode_step
    cfg, dev, page = be.cfg, be.device, be.page_size
    ctx = 128
    cache = model_lib.init_paged_cache(cfg, batch, be.alloc.num_pages, page,
                                       device=dev)
    per_row = -(-(ctx + 2 * steps) // page)
    table = np.zeros(tuple(cache["table"].shape), np.int32)
    table[:, :per_row] = 1 + np.arange(batch * per_row).reshape(batch,
                                                                per_row)
    cache["table"] = torch.from_numpy(table).to(dev)
    cache["lens"] = torch.full((batch,), ctx, dtype=torch.int32, device=dev)
    token = torch.full((batch, 1), 7, dtype=torch.long, device=dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    decode = build_paged_decode_step(cfg)
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = decode(be.params, cache, token, active)
        logits.argmax(-1).cpu()
    plain_wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = decode(be.params, cache, token, active)
            logits.argmax(-1).cpu()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"phase 3 decode-step profile: {1e3 * plain_wall:.2f} ms "
              f"per step (host clock, batch {batch}); the profiler saw no "
              f"device time: busy and idle share not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"phase 3 decode-step profile: batch {batch}, context {ctx}: "
          f"{1e3 * plain_wall:.2f} ms per step (host clock; "
          f"{1e3 * wall / steps:.2f} under the profiler), device busy "
          f"{1e3 * busy / steps:.3f} ms per step ({len(kernels) // steps} "
          f"kernels): idle share {1 - busy / steps / plain_wall:.3f} of an "
          f"unprofiled step, {1 - busy / wall:.3f} of the profiled window; "
          f"top kernels ms/step: "
          + "; ".join(f"{n[:100]} {t:.3f}" for n, t in top))


# --- phase 4 -----------------------------------------------------------------

def _run_parity(cfg, params, device, prompts, table, num_pages, page):
    from repro_torch.models import model as model_lib
    from repro_torch.train.step import (build_paged_decode_step,
                                        build_prefill_chunk_step)
    B, C = prompts.shape
    dev = torch.device(device)
    cache = model_lib.init_paged_cache(cfg, B, num_pages, page, device=dev)
    cache["table"] = torch.from_numpy(table).to(dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    logits, cache = build_prefill_chunk_step(cfg)(
        params, cache, torch.from_numpy(prompts).long().to(dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.full((B,), C, dtype=torch.int32, device=dev), active)
    outs = [logits.cpu()]
    decode = build_paged_decode_step(cfg)
    for _ in range(4):
        token = logits.argmax(-1)                    # [B, 1]
        logits, cache = decode(params, cache, token, active)
        outs.append(logits.cpu())
    return outs


def phase_parity(cfg) -> None:
    from repro_torch.models import model as model_lib
    p_cpu = model_lib.init(cfg, torch.Generator().manual_seed(0), "cpu")

    def to_cuda(t):
        return ({k: to_cuda(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(DEVICE))
    p_gpu = to_cuda(p_cpu)
    r = np.random.default_rng(4)
    B, C, page, num_pages = 2, 32, 16, 9
    prompts = r.integers(3, cfg.vocab_size, (B, C)).astype(np.int32)
    table = np.zeros((B, num_pages - 1), np.int32)
    table[:, :3] = r.permutation(np.arange(1, num_pages))[:6].reshape(B, 3)
    t0 = time.perf_counter()
    gpu = _run_parity(cfg, p_gpu, DEVICE, prompts, table, num_pages, page)
    t1 = time.perf_counter()
    cpu = _run_parity(cfg, p_cpu, "cpu", prompts, table, num_pages, page)
    t2 = time.perf_counter()
    diff = max((g - c).abs().max().item() for g, c in zip(gpu, cpu))
    spread = max(c.std().item() for c in cpu)
    tok_g = [g.argmax(-1).flatten().tolist() for g in gpu]
    tok_c = [c.argmax(-1).flatten().tolist() for c in cpu]
    if not all(torch.isfinite(g).all() for g in gpu):
        raise AssertionError("non-finite logits on the card")
    if tok_g != tok_c:
        raise AssertionError(f"greedy tokens differ: card {tok_g} vs cpu "
                             f"{tok_c}")
    if diff > PARITY_ATOL:
        raise AssertionError(f"card vs CPU logits differ by {diff:.3g} "
                             f"> {PARITY_ATOL}")
    print(f"phase 4 card vs CPU: qwen3-0.6b full f32 (TF32 off), prefill "
          f"{B}x{C} + 4 decode steps: greedy tokens equal {tok_g}; logits "
          f"max abs diff {diff:.3g} <= {PARITY_ATOL} (logit std "
          f"{spread:.3g}); card {t1 - t0:.2f}s, cpu {t2 - t1:.2f}s")


def main() -> None:
    card = phase_device_and_build()
    timing = phase_kernel_vs_plain()
    launches = phase_main_path()
    from repro_torch.configs import get_config
    phase_parity(get_config("qwen3-0.6b").replace(param_dtype="float32",
                                                  compute_dtype="float32"))
    kernels = [dict(
        name="paged_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:81",
        launches=launches, **timing)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
