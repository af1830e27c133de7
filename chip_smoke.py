#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  The phases run in order, each prints one line of its numbers,
and any failure exits non-zero:

1. device and build: the hand-written CUDA kernels are compiled from the
   checkout's sources with ``nvcc`` into ``build/kernels/``;
2. kernel vs plain: the paged-decode kernel (each row's attended range
   split over a thread-block cluster) against its plain PyTorch version
   on the card on every case (f32 atol/rtol 2e-5, bf16 2e-2, a len == 0
   row exactly zero), then timed at both paged paths' launches (qwen3-0.6b,
   G = 2, and qwen3-moe-30b-a3b, G = 8), and at G = 8 with every row at
   128 and at 129 tokens (either side of the split's pass boundary),
   beside its bound, the plain version and
   ``scaled_dot_product_attention`` on the gathered K/V:
   device time from ``torch.profiler`` (the kernels' own time; the JSON
   line's numbers are the qwen3 launch's) and time per call between CUDA
   events (which also holds the host's time to issue each call where that
   is longer);
3. the main path: ``repro_torch.launch.serve.main`` serves 8 requests
   with the full-width, full-depth qwen3-0.6b (bf16, random weights from
   a seed); every request must complete, the paged-prefill kernel must
   have been launched once per layer per prefill-chunk call and the
   paged-decode kernel once per layer per decode step;
4. card vs CPU: the same full-width qwen3-0.6b in f32 (TF32 off), one
   32-token prefill chunk for 2 rows and 4 decode steps, on the card
   (kernel) and on the CPU (plain): greedy tokens equal, logits within
   ``PARITY_ATOL``;
5. the dense kernels vs plain: the flash-attention prefill (bf16 on the
   tensor cores, f32 on the CUDA cores) and the dense decode-attention
   (split over a thread-block cluster) kernels against their plain
   PyTorch versions on the card on every case (f32 2e-5, bf16 2e-2),
   then each timed at every served launch shape (qwen3-0.6b, zamba2-2.7b,
   qwen3-moe-30b-a3b, gemma2-27b at 128 and 4,160 tokens with its window,
   softcap and scale, whisper-large-v3's D 64 and G 1, pixtral-12b's S
   132 and its decode past the cache, and qwen3-0.6b's heads on one of
   two model ranks, Hq 8 / Hkv 4, as phase 30 launches them) beside its
   bound, the share of the
   bound reached, the plain version and ``scaled_dot_product_attention``
   (none where the launch has a softcap), with the decode split plan
   (splits, cluster, blocks);
6. the dense main path: ``repro_torch.launch.serve.main`` with
   ``--backend dense`` serves the same 8 requests; the flash kernel must
   have been launched once per layer per prefill call and the decode
   kernel once per layer per decode step;
7. card vs CPU on the dense path: the full-width qwen3-0.6b in f32, a
   ``prefill`` of 2 rows x 32 tokens and 4 ``decode_step``s: greedy
   tokens equal, logits within ``PARITY_ATOL``;
8. the SSD-scan kernel vs plain: the Mamba2 chunked-scan kernel against
   its plain PyTorch version on the card, y and the final state (f32
   1e-4, bf16 5e-2), with each bf16 case's max error against the plain
   version in f32; both served launches must take the tensor-core route
   (``kernel.py::route``); then timed at both SSM main paths' shapes
   beside its bound and the plain version (no single PyTorch call
   computes the scan, so there is no library time), and at one model
   rank's launch of each on a model axis of two (phase 33's);
9. the SSM main path: ``repro_torch.launch.serve.main`` with
   ``--arch mamba2-780m --backend dense`` serves 8 requests of 192-384
   prompt tokens with the full-width, full-depth model; the SSD kernel
   must have been launched once per layer per prefill call and no
   attention kernel at all; then a decode step and a served prefill
   (8 x 384 tokens) are profiled (device busy, the SSD kernel's share,
   kernels per call);
10. the hybrid main path: the same with zamba2-2.7b (phase 6's load);
    the SSD kernel once per mamba layer per prefill call, the flash and
    dense-decode kernels once per application of the shared attention
    per prefill call and decode step; the same profiles (8 x 128);
11. card vs CPU on the SSM and hybrid paths in f32: mamba2-780m at full
    width and depth and zamba2-2.7b at full width and 12 of its 54
    layers, a ``prefill`` of 2 rows x 160 tokens and 4 ``decode_step``s;
12. the RMSNorm kernels vs plain: ``rmsnorm_fwd`` and the two fused row
    kernels (``add_rmsnorm_fwd``: the residual add and the next norm;
    ``gated_rmsnorm_fwd``: Mamba2's ``y * silu(z)`` and its norm) on every
    case of ``kernels/rmsnorm/cases.py`` (widths 16 to 5120, d not a
    multiple of the 16-byte vector, 1 to 1024 rows, one to three leading
    axes, strided row views; the gated kernel also at mamba2's train
    launch and on rows that walk its plan's loops), the fused
    ``qk_norm_rope_fwd`` (qk-norm and RoPE of q and k) on every case of
    its list (every path's heads and positions, D 128, 80 and 64, strided
    heads, no rows, qwen3-0.6b's train launch, heads spread over warps),
    in four (x, w) dtype pairs (tolerance by x's dtype: f32 2e-5, bf16
    2e-2); each fused
    kernel must also equal the unfused card sequence it replaces (the
    RMSNorm kernel beside torch's eager ops) in every element.  Then each
    is timed at the paths' shapes beside its bound, the plain version, the
    unfused card sequence (with the count of elements that differ from
    it, which must be 0) and, for ``rmsnorm_fwd``,
    ``torch.nn.functional.rms_norm`` (and whether that call gives the same
    bf16 values to 1 ulp); then the gated norm split over ranks by
    columns (Mamba2 under tensor parallelism: ``gated_rmsnorm_sumsq`` /
    ``_scale`` forward, ``gated_rmsnorm_dot`` / ``_scale_bwd`` backward)
    on every case of ``SPLIT_CASES`` (2 or 4 ranks of 24 to 2,560 columns,
    the four dtype pairs): each rank's entries against their plain
    versions and the ranks' outputs side by side against the whole-row
    ``gated_rmsnorm_fwd`` / ``_bwd``, each timed at phase 33's launch;
13. the MoE paged main path: ``repro_torch.launch.serve.main`` serves 8
    requests with the full-width, full-depth qwen3-moe-30b-a3b (48
    layers, 128 experts, bf16, random weights from a seed) inside a
    64 GB budget; no step may be forced over it; phase 3's launch
    checks;
14. the MoE dense main path: the same with ``--backend dense``;
15. card vs CPU on both MoE paths in f32: qwen3-moe-30b-a3b at full width
    and 2 of its 48 layers, 2 rows x 32 tokens and 4 decode steps, with
    the smallest gap between the k-th and (k+1)-th router probabilities
    printed (a routing flip would show as a greedy-token or logit
    mismatch, never hidden by a looser bound);
16. the RMSNorm backward kernels vs plain: ``rmsnorm_bwd``,
    ``add_rmsnorm_bwd``, ``gated_rmsnorm_bwd`` (on every case of
    RMSNORM_BWD_CASES) and ``qk_norm_rope_bwd`` (on every case of
    QK_ROPE_BWD_CASES), in the four (x, w) dtype pairs, against their plain
    formulas and against torch.autograd of the plain forwards (TOL by x's
    dtype, a weight gradient by the looser of x's and w's, relative to
    its largest value);
    each call repeated on the same inputs must give the same bits (dw's
    partial rows summed in a fixed order).  Then each timed at the train
    step's launch (the row kernel and dw's sum also apart) beside its
    bound and its plain formula and, for ``rmsnorm_bwd``, the backward of
    ``torch.nn.functional.rms_norm`` under autograd;
17. the training main path: ``repro_torch.launch.train.main`` trains the
    full-width, full-depth qwen3-0.6b (bf16 params, fp32 Adam moments,
    random weights from a seed) for 20 steps of 8 x 1024 tokens of the
    synthetic stream: the mean loss of the last 5 steps must be below the
    first 5's, each RMSNorm forward and backward kernel must launch
    exactly its count (``train_norm_launches``: the forward, the
    recompute of every layer under ``remat="full"``, the backward) and no
    attention or SSD kernel at all (the train mode takes their plain
    versions); the step-20 checkpoint must restore bit for bit and
    ``--resume`` continue from it.  Step seconds, tokens/s and peak
    memory per step, and a profile of one step (device busy, idle share,
    kernels, the RMSNorm kernels' share, the top device ops); then a
    short mamba2-780m run (full width, 8 of its 48 layers, 4 x 512) runs
    the gated norm's kernels and the plain SSD scan;
18. card vs CPU in f32: one train step (gradients and the AdamW update)
    of full-width qwen3-0.6b (full depth) and mamba2-780m (8 layers),
    2 rows x 64 tokens: loss, grad norm, every gradient leaf and the
    parameters after the step within the bounds stated beside
    ``PARITY_ATOL``'s;
19. gemma2-27b's dense path: ``repro_torch.launch.serve.main`` with
    ``--backend dense`` serves 8 requests with the full-width, full-depth
    model (46 layers in 23 local/global pairs, 54.5 GB in bf16) inside a
    64 GB budget, with phase 6's launch checks (the post-norms add two
    ``rmsnorm_fwd`` per layer) and decode-step profile;
20. gemma2-27b's long context: 2 requests of up to 4,160 prompt tokens
    (a 4,160-position prefill) and 16 new, so the local layers' window of
    4,096 masks the first keys in prefill and in every decode step; the
    same checks, and a decode step profiled at 2 rows of 4,160 tokens;
21. whisper-large-v3's dense path (32 + 32 layers, 8 encoder frames per
    request): the flash kernel in the decoder's self-attention only (the
    encoder and the cross-attention take the plain path), the encoder's
    norms in every prefill;
22. pixtral-12b's dense path (40 layers, 4 patch embeddings per
    request): its last decode steps write past the cache onto the last
    slot, as JAX clamps them, and at least one must;
23. card vs CPU in f32 on the dense path: gemma2-27b at full width and 2
    of its 46 layers, 1 row x 4,160 tokens (the window binds in prefill
    and decode), whisper-large-v3 at full width and depth (2 x 32
    tokens, 8 frames), pixtral-12b at full width and 2 of its 40 layers
    decoding past the cache; greedy tokens equal, logits within
    ``PARITY_ATOL``;
24. training: ``repro_torch.launch.train.main`` trains gemma2-27b (full
    width, 2 of its 46 layers, 4 x 512) and whisper-large-v3 (full width
    and depth, 8 x 512, half of it encoder frames) for 6 steps each: the
    loss falls (mean of the last 3 below the first 3), each norm kernel
    launches exactly its count and no attention or SSD kernel;
25. phase 18's card-vs-CPU train step for both;
26. scale-out on the card machine's torch: 4 gloo ranks spawned on the
    CPU as a (2, 2) mesh (``tests/scaleout_ranks.py``, no JAX) run
    ``moe_ffn_ep`` against ``moe_ffn`` at factor 32 with ``tp_dispatch``
    off and on (outputs and the gradients of x and all four weights),
    ``pipeline_apply`` and its gradients against sequential application,
    the sharded train step against the one-rank step (the dense smoke,
    the MoE smoke under expert parallelism, and the dense smoke
    accumulated over 2 microbatches of a loss mask that counts different
    tokens in each) and ``restore(..., shardings=)`` onto the mesh
    (``SCALEOUT_TOL``);
27. training on a one-rank NCCL mesh: ``repro_torch.launch.train.main``
    with ``--mesh 1x1 --ep-moe`` trains full-width qwen3-moe-30b-a3b (2
    of its 48 layers, 128 experts, k 8, bf16 params, fp32 moments) for 6
    steps of 8 x 512: each loss equal to the run without a mesh (within
    ``TRAIN_LOSS_ATOL``), ``moe_ffn_ep`` in every MoE layer of every step
    (twice under remat) with two forward all-to-alls each, each RMSNorm
    kernel exactly its count; step time, peak memory and a profiled step
    (idle share, the NCCL kernels' share), each beside the card's name
    and power limit;
28. the feature probe: ``repro_torch.core.features.extract_features``
    (the port's step run once on fake tensors by
    ``utils/step_analyzer.py``) of the train and the serve step of
    full-width qwen3-0.6b, qwen3-moe-30b-a3b, mamba2-780m and gemma2-27b
    at 2 x 64 tokens: 22 finite values each, no kernel launched and no
    device memory allocated, each vector's FLOPs, bytes and peak
    temporaries with its seconds; then the memory model against the
    card: the probe's argument + peak temporary + output bytes of
    full-width qwen3-0.6b (bf16) training at 8 x 1,024 and decoding at
    batch 8 against a 161-slot cache, beside ``max_memory_allocated`` of
    one real step of each on the card (the argument bytes must be the
    bytes the inputs hold, and what the allocator gave them no more than
    its blocks' slack), and each real step's time beside the probe's roofline
    ``max(compute_s, memory_s)``, with the card's name and power limit;
    the real steps launch exactly their RMSNorm and dense-decode counts;
29. tensor-parallel training on two ranks that share the card (spawned,
    gloo: NCCL refuses two ranks on one card): full-width qwen3-0.6b
    through ``launch/train.py --mesh 1x2``, (a) in f32 at 4 of its 28
    layers, 2 steps of 4 x 256, held to the run without a mesh (losses
    within ``TRAIN_LOSS_ATOL``, parameters by ``TP_PARAM_ATOL``), and (b)
    in bf16 with fp32 moments at full depth, 6 steps of 4 x 1,024: the
    loss falls, each rank launches exactly each RMSNorm kernel's count,
    taking the compute tensors gathers no parameter; each rank's step
    time and peak memory, and a step with its all-reduces timed (their
    share of it), beside the card's name and power limit;
30. tensor-parallel serving on the same two ranks: full-width,
    full-depth qwen3-0.6b through the sharded prefill (8 rows x 128
    tokens) and 16 greedy decode steps (``train/sharded_serve.py``), in
    f32 (every token equal to the one-rank ``build_serve_step`` run's)
    and in bf16 (logits within ``TP_BF16_LOGIT_RTOL`` of the one-rank
    steps fed the same tokens); on each rank the flash kernel 28 times
    per prefill and the dense decode kernel 28 times per step at Hq 8 /
    Hkv 4, the KV cache held as the rank's 4 heads;
31. the sequence-split KV cache: (a) the dense decode kernel with its
    log-sum-exp on each of 16 ranges of 2,048 of 32,768 slots (the
    decode_32k cell's layout at M = 16) at qwen3-0.6b's heads and at
    gemma2-27b's local layers (window 4,096: ranges fall outside it), f32
    and bf16: each range's o and lse against the plain version, an
    empty range exactly o = 0 and lse = -inf, the ranges merged against
    the whole call; one rank's launch timed with and without the lse,
    in bf16 and f32;
    (b) full-width qwen3-0.6b (4 of its 28 layers) served by 16 gloo
    ranks that share the card on a (1, 16) mesh, where its 8 kv heads
    do not split over 16 ranks and ``cache_specs`` splits the cache over
    the sequence (each rank every kv head of 16 of 256 slots): a prompt
    of 44 tokens over ranks 0-2's slots and 5 decode steps, the last
    into rank 3's, in f32 (every greedy token equal to the one-rank run's) and bf16
    (logits within ``TP_BF16_LOGIT_RTOL``); per rank the flash kernel
    once per layer per prefill (phase 5's ``qwen3-seq16`` shape) and the
    decode kernel with its lse once per layer per step, and per step and
    layer one q all-gather and one all-to-all of the partials;
32. the dry-run (``python -m repro_torch.launch.dryrun``'s entry point,
    in a process of its own after phase 31, on the host's CPU):
    qwen3-0.6b's train_4k, prefill_32k and decode_32k and mamba2-780m's
    long_500k cells on the 16x16 and 2x16x16 meshes at full width and
    depth, on the card machine's torch (fake tensors, rank 0 of a fake
    process group): every cell ``ok`` with 22 finite features, the
    decode cell's KV cache per device the whole cache's over M x D and
    one all-to-all per layer; each cell's per-device peak, roofline
    terms and dominant term;
33. the Mamba2 layers split by heads over two gloo ranks sharing the
    card on a (1, 2) mesh: (a) full-width mamba2-780m (4 of its 48
    layers, 24 of 48 SSM heads a rank) and zamba2-2.7b (6 of 54, one
    shared application; 40 of 80 SSM heads, 16 of 32 attention heads)
    through the sharded prefill of 8 rows and 4 greedy decode steps, in
    f32 (every token equal to the one-rank run's) and bf16 (logits
    within ``TP_BF16_LOGIT_RTOL``): per rank the SSD kernel once per
    layer per prefill at phase 8's ``*-tp2`` case, the split gated norm
    once per layer per call, the rank's heads of the SSM state held;
    (b) mamba2-780m (4 layers, f32) trained through ``launch/train.py
    --mesh 1x2``: losses and grad norms within phase 29's bounds of the
    run without a mesh, every leaf's gradient within ``TRAIN_GRAD_RTOL``
    of one rank's, each norm kernel its count (the gated norm split),
    only ``in_proj``, ``conv_w`` and ``conv_b`` gathered; each rank's
    times and peaks beside the card's name and power limit;
34. the tools (``repro_torch.tools``, each through its entry point on
    the card): ``shakeout_models`` over every arch and
    ``shakeout_decode`` over its six, every line ``OK``, the flash,
    dense decode, SSD-scan and forward RMSNorm kernels each launched;
    ``quickstart`` (the ~100M dense config, f32) for 20 steps of 8 x 256
    with a checkpoint every 10: the loss falls, and a run resumed from
    its step-10 checkpoint ends with the same last 10 losses, parameters
    and moments bit for bit; ``serving_demo`` serves 12 of 12 requests;
    ``roofline`` and ``colocation`` over phase 32's records: every
    cell's fraction finite, both binding-axis assertions hold;
35. the paged-prefill kernel vs plain: the chunk call's kernel (each
    row's chunk of queries over its own pages, read through the page
    table) against its plain version (the page gather and the masked
    softmax) on the card on every case of
    ``kernels/paged_prefill/cases.py`` (G 1 to 8, D 16 to 128, ragged
    starts, partial chunks, rows that are not prefilling, lengths on and
    one past a page edge, softcap, the chat cell's call; f32 2e-5, bf16
    2e-2; a row that is not prefilling exactly zero), NaN planted in
    every pool slot no row attends changing nothing, then timed at the
    chat cell's chunk call and at qwen3-0.6b's chunk of 128 beside its
    bound, the plain version and ``scaled_dot_product_attention`` over the
    prefilling rows' live pages, gathered beforehand.

The timing helpers, timers, bounds and the attention kernels' cases of
phases 2, 5, 8, 12, 16 and 35 are ``repro_torch.tools.kernel_bench``'s
(``python -m repro_torch.tools.kernel_bench`` times the same rows on
its own), loaded from this checkout's file.

Every path (phases 3, 6, 9, 10, 13, 14, 17, 19 to 22, 24, 27, 28's
real steps, 29 (b), 30, 31 (b), 33 and 34) runs an
RMSNorm kernel for every norm (the fused ones wherever a neighbour is
absorbed), and each runs with every kernel's launch count set to 0 just
before it and read
just after: each kernel of the path must have been launched exactly its
per-call count times the path's calls, and no other kernel at all (in
phase 34, each kernel of the shakeouts' calls at least once).  Each
path's decode-step profile must show no ``cos`` or ``sin`` kernel, and
the paths without Mamba2 layers no ``cat`` kernel (RoPE's eager ops).
The attention cases of phases 2 and 5 include qwen3-moe's heads (G = 8)
before any MoE path runs.  Each phase prints its seconds and the total
is printed at the end.

The last three lines are the card's name and power limit as
``nvidia-smi`` gives them, a JSON line describing each kernel, and the
JSON status line.

    python3 chip_smoke.py --kernel-times [SRC]

builds the kernels and runs the timing of phases 2, 5, 8, 12, 16 and
35 alone (``kernel_bench.time_all``: the paged kernel at G = 2 and 8,
the paged-prefill kernel at both chunk calls (none where SRC lacks it),
flash and dense decode at every served shape, the SSD scan at both SSM
launches and one model rank's of each, the RMSNorm kernels and the
unfused sequences at the paths' shapes, the split gated norm's entries,
the backward kernels at the train step's launches, row kernel and dw
sum apart), with the ``repro_torch`` package of the checkout whose
``src`` directory is SRC (another commit unpacked with ``git archive``,
say), so that two versions of the kernels are timed on one card in one
call.  The timing code is this tree's
(``kernel_bench.py`` is loaded from its file and imports the kernels
inside its timers), so SRC needs no ``repro_torch.tools``.

    python3 chip_smoke.py --paged-prefill

builds the kernels and runs phase 35 alone.

    python3 chip_smoke.py --tools

builds the kernels and runs phases 32 (whose records phase 34 reads)
and 34 alone.

    python3 chip_smoke.py --tp

builds the kernels and runs phases 29 and 30 alone.

    python3 chip_smoke.py --seq-split

builds the kernels and runs phases 31 and 32 alone.

    python3 chip_smoke.py --mamba-tp

builds the kernels and runs the split gated norm's part of phase 12,
phase 8 and phase 33 alone.

    python3 chip_smoke.py --norm-fwd

builds the kernels and runs phase 12 alone (the forward RMSNorm kernels
on every case, the card-only cases among them, and their times at the
paths' launches, the train launches among them; the split gated norm's
entries).

    python3 chip_smoke.py --norm-times [SRC]

runs phase 12's timing alone with the package of SRC as
``--kernel-times`` takes it (parent, change, change, parent in one call
gives both sides' spread).

    python3 chip_smoke.py --norm-bwd

builds the kernels and runs phase 16 (the backward kernels on every case
and at the train step's launches) and the split gated norm's part of
phase 12 alone.

    python3 chip_smoke.py --train-profile [SRC]

builds the kernels and runs phase 17's qwen3-0.6b training (20 steps of
8 x 1024) and its step profile alone, with the package of SRC as
``--kernel-times`` takes it.

    python3 chip_smoke.py --prefill-profiles [SRC]

builds the kernels and profiles one served prefill of mamba2-780m and of
zamba2-2.7b (phases 9 and 10's prefill profiles) with the package of SRC
in the same way.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def _kernel_bench():
    """This checkout's ``src/repro_torch/tools/kernel_bench.py``, loaded
    from its file: the timing helpers, timers, bounds and the attention
    kernels' cases.  It imports the package only inside its functions, so
    ``--kernel-times SRC`` (SRC's ``src`` first on ``sys.path``) times
    SRC's kernels with this tree's timing code, also where SRC has no
    ``repro_torch.tools``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_kernel_bench",
        ROOT / "src" / "repro_torch" / "tools" / "kernel_bench.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


kb = _kernel_bench()
card_line, timed, bound, _us, _rand = (kb.card_line, kb.timed, kb.bound,
                                       kb.us, kb.rand)


def _json(row: dict) -> dict:
    """A timed row's numbers for the kernels line."""
    return {k: row[k] for k in kb.JSON_KEYS}


TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: phases 4 and 7: f32 logits on the card vs the CPU.  Both sides
#: compute in f32, but in another order (cuBLAS vs the CPU BLAS, the
#: kernels' online softmax over tiles vs one softmax over the row);
#: relative rounding of ~1e-6 per product, compounded over 28 layers,
#: stays orders of magnitude below this bound on logits of order 1, and
#: far below the gap between the top two logits that decides each
#: greedy token.
PARITY_ATOL = 2e-3
#: phase 18: f32 card vs CPU, one train step.  Both sides compute in f32
#: (TF32 off) but sum in other orders (cuBLAS vs the CPU BLAS, the norm
#: kernels' row sums vs torch's), through 28 layers forward and back:
#: the loss is held to TRAIN_LOSS_ATOL (an absolute error on losses near
#: 12), the grad norm to TRAIN_GRAD_RTOL relative, and each gradient leaf
#: to TRAIN_GRAD_RTOL of its largest value.  After the AdamW step (lr
#: TRAIN_LR at count 1, where each element moves by lr * g / (|g| + eps)
#: + weight decay) a parameter whose |g| is above 1e-4 (so eps is
#: negligible beside it), above 1e-4 of its leaf's largest and above 10
#: times that leaf's gradient error moves the same on both sides, to
#: 1e-6 (f32 rounding of values near 1); any other may move by at most
#: twice the step's size (the gradient's sign is noise there).
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_LR = 1e-3

#: where phases 2, 4, 5 and 7 put the kernel's side (the card)
DEVICE = "cuda"

MAIN_ARGV = ["--arch", "qwen3-0.6b", "--requests", "8", "--prompt-len",
             "128", "--decode-steps", "32", "--budget-gb", "8",
             "--device", "cuda"]
#: RMSNorm kernel launches per model call (a prefill, prefill chunk or
#: decode step) of each served arch, by kernel: the stack's first pre-norm
#: (rmsnorm_fwd); every later pre-norm and the final norm, each adding the
#: previous block's output (add_rmsnorm_fwd: two per attention layer or
#: shared-attention application, one per Mamba2 layer); each attention
#: layer's qk-norm and RoPE (qk_norm_rope_fwd); each Mamba2 layer's gated
#: norm (gated_rmsnorm_fwd).  tests/test_torch_rmsnorm.py counts them on
#: the CPU.
NORMS_PER_CALL = {
    "qwen3-0.6b": {"rmsnorm_fwd": 1, "add_rmsnorm_fwd": 28 * 2,
                   "qk_norm_rope_fwd": 28},
    "mamba2-780m": {"rmsnorm_fwd": 1, "add_rmsnorm_fwd": 48,
                    "gated_rmsnorm_fwd": 48},
    "zamba2-2.7b": {"rmsnorm_fwd": 1, "add_rmsnorm_fwd": 9 * 2 + 54,
                    "qk_norm_rope_fwd": 9, "gated_rmsnorm_fwd": 54},
    "qwen3-moe-30b-a3b": {"rmsnorm_fwd": 1, "add_rmsnorm_fwd": 48 * 2,
                          "qk_norm_rope_fwd": 48},
    # gemma2 adds the two post-norms of each layer (rmsnorm_fwd); whisper's
    # decoder has three pre-norms per layer (self-attention,
    # cross-attention, MLP) and RoPE in its self-attention only
    "gemma2-27b": {"rmsnorm_fwd": 1 + 46 * 2, "add_rmsnorm_fwd": 46 * 2,
                   "qk_norm_rope_fwd": 46},
    "whisper-large-v3": {"rmsnorm_fwd": 1, "add_rmsnorm_fwd": 32 * 3,
                         "qk_norm_rope_fwd": 32},
    "pixtral-12b": {"rmsnorm_fwd": 1, "add_rmsnorm_fwd": 40 * 2,
                    "qk_norm_rope_fwd": 40},
}
#: what a prefill launches on top of NORMS_PER_CALL: whisper's encoder
#: (its first pre-norm; its other pre-norms and its final norm, each
#: adding the previous block's output).  tests/test_torch_gemma2.py,
#: test_torch_encdec.py and test_torch_pixtral.py count the new archs'
#: norms on the CPU.
NORMS_PER_PREFILL = {"whisper-large-v3": {"rmsnorm_fwd": 1,
                                          "add_rmsnorm_fwd": 32 * 2}}


def norm_launches(arch: str, pre: int, dec: int) -> dict:
    """Each RMSNorm kernel's launches over ``pre`` prefill (or prefill
    chunk) calls and ``dec`` decode steps."""
    extra = NORMS_PER_PREFILL.get(arch, {})
    return {k: n * (pre + dec) + extra.get(k, 0) * pre
            for k, n in NORMS_PER_CALL[arch].items()}


def norms_line(counts: dict, arch: str, pre: int, dec: int) -> str:
    extra = NORMS_PER_PREFILL.get(arch, {})
    return ", ".join(
        f"{k[:-4]} {counts[k]} = {n} x ({pre} + {dec})"
        + (f" + {extra[k]} x {pre}" if k in extra else "")
        for k, n in NORMS_PER_CALL[arch].items())


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

def phase_kernel_vs_plain() -> dict:
    """The paged kernel against its plain version on every case (f32 and
    bf16; a len == 0 row must be exactly zero), then timed at every
    launch of ``kernel_bench.PAGED_TIMED``."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    errs, worst = [], 0.0
    for seed, (name, (B, P, page, Hq, Hkv, D, lens), window, cap) in \
            enumerate(kb.CASES):
        arrs = kb.paged_case(B, P, page, Hq, Hkv, D, lens, seed=seed)
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, ln = kb.paged_on(arrs, dtype)
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

    print(f"phase 2 kernel vs plain: {len(errs)} cases ok, max abs err "
          f"{worst:.3g} [{' '.join(errs)}]")
    row = kb.time_paged_launches("phase 2")[0]
    return dict(max_abs_err=worst, **_json(row))


# --- phase 3 -----------------------------------------------------------------

def launchers() -> dict:
    """Each kernel's launcher, by kernel name (each carries ``.launches``,
    which it bumps where it launches its kernel and nowhere else)."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_fwd
    from repro_torch.kernels.paged_prefill.kernel import paged_prefill_fwd
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
    return {f.__name__: f for f in (
        paged_attention_fwd, paged_prefill_fwd, flash_attention_fwd,
        decode_attention_fwd,
        ssd_scan_fwd, rms.rmsnorm_fwd, rms.add_rmsnorm_fwd,
        rms.qk_norm_rope_fwd, rms.gated_rmsnorm_fwd, rms.rmsnorm_bwd,
        rms.add_rmsnorm_bwd, rms.qk_norm_rope_bwd, rms.gated_rmsnorm_bwd,
        rms.gated_rmsnorm_sumsq, rms.gated_rmsnorm_scale,
        rms.gated_rmsnorm_dot, rms.gated_rmsnorm_scale_bwd)}


def serve_counted(argv):
    """``serve.main(argv)`` with every kernel's launch count set to 0 just
    before and read just after, and the device's peak memory reset:
    (output, {kernel name: launches})."""
    from repro_torch.launch import serve
    gc.collect()           # free what earlier phases left, then reset
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fns = launchers()
    for f in fns.values():
        f.launches = 0
    out = serve.main(argv)
    return out, {name: f.launches for name, f in fns.items()}


def check_served(out, cfg, n: int = 8) -> None:
    if out["summary"]["completed"] != n:
        raise AssertionError(f"served {out['summary']['completed']}/{n} "
                             f"requests")
    for r in out["engine"].requests:
        if len(r.tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens "
                                 f"of {r.max_new_tokens}, or out of vocab")


def check_launches(counts: dict, want: dict, cfg, layers: int) -> None:
    """Every kernel's launches on a path equal ``want`` (the others 0),
    at the arch's published depth."""
    full = {name: want.get(name, 0) for name in counts}
    if cfg.num_layers != layers or counts != full:
        raise AssertionError(f"launches {counts}; want {full} "
                             f"({cfg.num_layers} layers, want {layers})")


def phase_paged_path(n: int, arch: str, argv, layers: int) -> dict:
    """A paged main path at full width and depth: 8 requests complete,
    none forced over the budget; the paged-prefill kernel runs once per
    layer per prefill-chunk call, the paged-decode kernel once per layer
    per decode step and the RMSNorm kernel once per norm per call
    (prefill chunks and decode steps); no other kernel."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    out, counts = serve_counted(argv)
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary, backends = out["summary"], out["backends"]
    check_served(out, cfg)
    pre = sum(be.prefill_calls for be in backends)
    dec = sum(be.decode_calls for be in backends)
    check_launches(counts, {"paged_attention_fwd": layers * dec,
                            "paged_prefill_fwd": layers * pre,
                            **norm_launches(arch, pre, dec)}, cfg, layers)
    if dec == 0 or summary["forced_steps"]:
        raise AssertionError(f"{dec} decode steps, {summary['forced_steps']} "
                             f"steps forced over the budget")
    dec_s = sum(be.decode_seconds for be in backends)
    tok = summary["good_tokens"]
    print(f"phase {n} main path: {arch} full ({cfg.num_layers} layers, "
          f"d={cfg.d_model}, {cfg.param_dtype}) served "
          f"{summary['completed']}/8 requests, {tok} tokens in "
          f"{out['wall_s']:.2f}s wall ({tok / out['wall_s']:.1f} tok/s); "
          f"{pre} prefill-chunk calls, {dec} decode steps, mean "
          f"{1e3 * dec_s / dec:.2f} ms/step; paged-prefill kernel launched "
          f"{counts['paged_prefill_fwd']} = {layers} x {pre}, paged-decode "
          f"kernel {counts['paged_attention_fwd']} = {layers} x {dec}, "
          f"{norms_line(counts, arch, pre, dec)}; none forced over budget; "
          f"peak device memory {peak:.2f} GiB")
    decode_step_profile(backends[0], f"phase {n} decode-step profile")
    return counts


def decode_step_profile(be, label: str, batch: int = 8,
                        steps: int = 5) -> None:
    """Where a paged decode step's time goes: the backend's weights and
    page pool size, every row of the batch live (context 128 on distinct
    pages)."""
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
    state = {"cache": cache}

    def step():
        logits, state["cache"] = decode(be.params, state["cache"], token,
                                        active)
        return logits
    profile_steps(label, step, batch, ctx, steps, absent=rope_kernels(cfg))


def rope_kernels(cfg) -> tuple:
    """Names (substrings) of the eager kernels RoPE launched before the
    fusion, which a decode step of ``cfg`` must not run: ``cos`` and
    ``sin``, and ``cat`` where no Mamba2 layer runs one (its conv step
    concatenates the window)."""
    names = ("cos_kernel", "sin_kernel")
    if cfg.family not in ("ssm", "hybrid"):
        names += ("CatArrayBatchedCopy",)
    return names


def profile_steps(label: str, step, batch: int, ctx: int,
                  steps: int = 5, unit: str = "step",
                  share: str = "", absent: tuple = ()) -> None:
    """``torch.profiler`` over ``steps`` calls of ``step`` (one decode
    step, or one prefill, returning its logits), each ending in the greedy
    read-back as in serving; timed first without the profiler and then
    under it.  Device busy time is the sum of the kernels' times (one
    stream, so they do not overlap).  With ``share``, also the time and
    share of busy of the kernels whose name holds it.  No kernel's name
    may hold any of ``absent``."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for _ in range(steps):
        step().argmax(-1).cpu()
    plain_wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step().argmax(-1).cpu()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"{label}: {1e3 * plain_wall:.2f} ms per {unit} (host clock, "
              f"batch {batch}); the profiler saw no device time: busy and "
              f"idle share not measured")
        return
    found = sorted({e.name[:80] for e in kernels
                    if any(a in e.name for a in absent)})
    if found:
        raise AssertionError(f"{label}: kernels that must not run: {found}")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    named = ""
    if share:
        ms = sum(t for n, t in by_name.items() if share in n)
        named = (f"; {share!r} kernels {ms:.3f} ms per {unit}, "
                 f"{ms / (1e3 * busy / steps):.3f} of busy")
    print(f"{label}: batch {batch}, context {ctx}: "
          f"{1e3 * plain_wall:.2f} ms per {unit} (host clock; "
          f"{1e3 * wall / steps:.2f} under the profiler), device busy "
          f"{1e3 * busy / steps:.3f} ms per {unit} ({len(kernels) // steps} "
          f"kernels): idle share {1 - busy / steps / plain_wall:.3f} of an "
          f"unprofiled {unit}, {1 - busy / wall:.3f} of the profiled "
          f"window{named}{'; none named ' if absent else ''}"
          f"{'/'.join(absent)}; top kernels ms/{unit}: "
          + "; ".join(f"{n[:100]} {t:.3f}" for n, t in top))


def prefill_profile(be, label: str, prompt: int, batch: int = 8,
                    steps: int = 3) -> None:
    """Where a dense-cache prefill's time goes: the backend's weights and
    cache length, ``batch`` rows of ``prompt`` tokens (the served prefill's
    padded length), with the SSD kernels' share of device busy time."""
    from repro_torch.train.step import build_prefill_step
    prefill = build_prefill_step(be.cfg, be.max_len)
    tokens = torch.full((batch, prompt), 7, dtype=torch.long,
                        device=be.device)

    def step():
        return prefill(be.params, {"tokens": tokens})[0]
    step().argmax(-1).cpu()  # a fresh process's set-up stays out of it
    profile_steps(label, step, batch, prompt, steps, unit="prefill",
                  share="ssd_scan")


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


def to_card(tree):
    """A copy of a param tree on the card."""
    return ({k: to_card(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(DEVICE))


def check_parity(label: str, gpu, cpu) -> str:
    """Greedy tokens equal and logits within ``PARITY_ATOL``, card vs
    CPU; returns the numbers for the phase's line."""
    diff = max((g - c).abs().max().item() for g, c in zip(gpu, cpu))
    spread = max(c.std().item() for c in cpu)
    tok_g = [g.argmax(-1).flatten().tolist() for g in gpu]
    tok_c = [c.argmax(-1).flatten().tolist() for c in cpu]
    if not all(torch.isfinite(g).all() for g in gpu):
        raise AssertionError(f"{label}: non-finite logits on the card")
    if tok_g != tok_c:
        raise AssertionError(f"{label}: greedy tokens differ: card {tok_g} "
                             f"vs cpu {tok_c}")
    if diff > PARITY_ATOL:
        raise AssertionError(f"{label}: card vs CPU logits differ by "
                             f"{diff:.3g} > {PARITY_ATOL}")
    return (f"greedy tokens equal {tok_g}; logits max abs diff {diff:.3g} "
            f"<= {PARITY_ATOL} (logit std {spread:.3g})")


def phase_parity(cfg, p_cpu) -> None:
    p_gpu = to_card(p_cpu)
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
    print(f"phase 4 card vs CPU: qwen3-0.6b full f32 (TF32 off), prefill "
          f"{B}x{C} + 4 decode steps: {check_parity('phase 4', gpu, cpu)}; "
          f"card {t1 - t0:.2f}s, cpu {t2 - t1:.2f}s")


# --- phase 5 -----------------------------------------------------------------

def _check_close(name, dtype, out, ref, errs) -> float:
    a, b = out.float(), ref.float()
    err = (a - b).abs().max().item()
    tol = TOL[dtype]
    if not torch.allclose(a, b, atol=tol, rtol=tol):
        raise AssertionError(f"{name} {dtype}: kernel vs plain max abs err "
                             f"{err:.3g} > {tol}")
    errs.append(f"{name}/{str(dtype)[6:]}={err:.2g}")
    return err


def phase_dense_kernels_vs_plain() -> dict:
    """Both dense kernels against their plain versions on every case (f32
    and bf16), then timed at every served launch shape (bf16; 28 sets of
    inputs cycled so each launch reads from device memory, as a step
    does)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.kernel import split_plan
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    L = get_config("qwen3-0.6b").num_layers

    # flash prefill: correctness
    errs, worst = [], 0.0
    for seed, case in enumerate(kb.FLASH_CASES):
        name, (B, S, Hq, Hkv, D), causal = case[:3]
        o = kb.case_opts(case)
        r = np.random.default_rng(seed)
        arrs = [r.normal(0, 1, (B, S, H, D)).astype(np.float32)
                for H in (Hq, Hkv, Hkv)]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(a).to(DEVICE, dt) for a in arrs)
            got = fa_ops.flash_attention(q, k, v, causal=causal,
                                         window=o["window"],
                                         attn_softcap=o["softcap"],
                                         scale=o["scale"])
            ref = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                causal=causal, **o).transpose(1, 2)
            torch.cuda.synchronize()
            worst = max(worst, _check_close(name, dt, got, ref, errs))
    print(f"phase 5 flash kernel vs plain: {len(errs)} cases ok, max abs "
          f"err {worst:.3g} [{' '.join(errs)}]")
    flash_err = worst

    # dense decode: correctness
    errs, worst = [], 0.0
    for seed, case in enumerate(kb.DECODE_CASES):
        name, (B, S, Hq, Hkv, D, lens) = case[:2]
        o = kb.case_opts(case)
        r = np.random.default_rng(100 + seed)
        arrs = [r.normal(0, 1, (B, 1, Hq, D)).astype(np.float32),
                r.normal(0, 1, (B, S, Hkv, D)).astype(np.float32),
                r.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)]
        ends = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        ln = torch.clamp(ends, max=S)
        for dt in (torch.float32, torch.bfloat16):
            q, kc, vc = (torch.from_numpy(a).to(DEVICE, dt) for a in arrs)
            got = da_ops.decode_attention(q, kc, vc, ends - 1,
                                          window=o["window"],
                                          attn_softcap=o["softcap"],
                                          scale=o["scale"])
            ref = decode_attention_ref(q.transpose(1, 2), kc, vc, ln,
                                       ends=ends, **o).transpose(1, 2)
            torch.cuda.synchronize()
            if not torch.all(got[ln == 0] == 0):
                raise AssertionError(f"{name}: a len == 0 row is not zero")
            worst = max(worst, _check_close(name, dt, got, ref, errs))
    print(f"phase 5 decode kernel vs plain: {len(errs)} cases ok, max abs "
          f"err {worst:.3g} [{' '.join(errs)}]")
    rows = kb.time_served_shapes("phase 5", L)
    cases = {name: shape for name, shape, *_ in kb.DECODE_CASES}
    plans = []
    for path, name in kb.TIMED:
        B, S, Hq, Hkv, D, _ = cases[name]
        p = split_plan(S, B, Hkv)
        plans.append(f"{path} (S {S}, Hkv {Hkv}): {p.splits} splits of "
                     f"{p.tokens} slots, cluster {p.cluster}, {p.blocks} "
                     f"blocks")
    print(f"phase 5 decode split plan: {'; '.join(plans)}")
    # the JSON line carries each kernel's main path (qwen3-0.6b) launch
    main = {r["kernel"]: r for r in rows if r["launch"] == kb.TIMED[0][0]}
    return {"flash_attention_fwd": dict(
                max_abs_err=flash_err, **_json(main["flash_attention_fwd"])),
            "decode_attention_fwd": dict(
                max_abs_err=worst, **_json(main["decode_attention_fwd"]))}


# --- phase 6 -----------------------------------------------------------------

def phase_dense_path(n: int, arch: str, argv, layers: int,
                     requests: int = 8, profile_batch: int = 8,
                     profile_ctx: int = 128):
    """A dense-cache main path of a decoder stack at full width and
    depth: ``requests`` requests complete, none forced over the budget;
    the flash kernel runs once per layer per prefill call, the dense
    decode kernel once per layer per decode step and the RMSNorm kernel
    once per norm per call; no other kernel.  Then a decode step is
    profiled at ``profile_batch`` rows of ``profile_ctx`` tokens.
    Returns (the launch counts, the requests, the backends' positions at
    each decode step, the cache length)."""
    from repro_torch.configs import get_config
    from repro_torch.serve.backends import TorchBackend
    cfg = get_config(arch)
    positions, real = [], TorchBackend.decode

    def decode(be, running):
        positions.append(be.position)
        return real(be, running)
    TorchBackend.decode = decode
    try:
        out, counts = serve_counted(argv)
    finally:
        TorchBackend.decode = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary, backends = out["summary"], out["backends"]
    check_served(out, cfg, requests)
    pre = sum(be.prefill_calls for be in backends)
    dec = sum(be.decode_calls for be in backends)
    fl, de = counts["flash_attention_fwd"], counts["decode_attention_fwd"]
    check_launches(counts, {"flash_attention_fwd": layers * pre,
                            "decode_attention_fwd": layers * dec,
                            **norm_launches(arch, pre, dec)}, cfg, layers)
    if pre == 0 or dec == 0 or summary["forced_steps"]:
        raise AssertionError(f"{pre} prefill calls, {dec} decode steps, "
                             f"{summary['forced_steps']} steps forced over "
                             f"the budget")
    dec_s = sum(be.decode_seconds for be in backends)
    tok = summary["good_tokens"]
    reqs = out["engine"].requests
    print(f"phase {n} dense path: {arch} full ({layers} layers, "
          f"d={cfg.d_model}, {cfg.param_dtype}) served "
          f"{summary['completed']}/{requests} requests (prompts "
          f"{min(r.prompt_len for r in reqs)}-"
          f"{max(r.prompt_len for r in reqs)} tokens), {tok} tokens in "
          f"{out['wall_s']:.2f}s wall ({tok / out['wall_s']:.1f} tok/s); "
          f"{pre} prefill calls, flash kernel launched {fl} = {layers} x "
          f"{pre}; {dec} decode steps, mean {1e3 * dec_s / dec:.2f} "
          f"ms/step, decode kernel launched {de} = {layers} x {dec}; "
          f"{norms_line(counts, arch, pre, dec)}; none forced over budget; "
          f"peak device memory {peak:.2f} GiB")
    dense_decode_profile(backends[0], f"phase {n} dense decode-step profile",
                         profile_batch, ctx=profile_ctx)
    return counts, reqs, positions, backends[0].max_len


def dense_decode_profile(be, label: str, batch: int = 8, steps: int = 5,
                         ctx: int = 128) -> None:
    """Where a dense-cache decode step's time goes: the backend's weights
    and cache length, every row of the batch at context ``ctx`` (or
    less, to leave room for the steps in the cache); an encdec cache
    holds 8 encoder frames, as the backend's prefills give it."""
    from repro_torch.models import model as model_lib
    from repro_torch.train.step import build_decode_step
    ctx, dev = min(ctx, be.max_len - 2 * steps), be.device
    cache = model_lib.init_cache(be.cfg, batch, be.max_len, device=dev,
                                 cross_len=8)
    cache["len"] = torch.tensor(ctx, dtype=torch.int32, device=dev)
    token = torch.full((batch, 1), 7, dtype=torch.long, device=dev)
    decode = build_decode_step(be.cfg)
    state = {"cache": cache}

    def step():
        logits, state["cache"] = decode(be.params, state["cache"], token)
        return logits
    profile_steps(label, step, batch, ctx, steps,
                  absent=rope_kernels(be.cfg))
    del state, cache


# --- phase 7 -----------------------------------------------------------------

def _run_dense_parity(cfg, params, device, prompts, max_len, extra=None):
    """A prefill of ``prompts`` (with ``extra``'s numpy arrays in the
    batch: the vlm's patch embeddings, the encdec's encoder frames) and 4
    greedy decode steps on ``device``: the 5 logits, on the CPU."""
    from repro_torch.train.step import build_decode_step, build_prefill_step
    dev = torch.device(device)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             (extra or {}).items()}
    batch["tokens"] = torch.from_numpy(prompts).long().to(dev)
    logits, cache = build_prefill_step(cfg, max_len)(params, batch)
    outs = [logits.cpu()]
    decode = build_decode_step(cfg)
    for _ in range(4):
        token = logits.argmax(-1)                    # [B, 1]
        logits, cache = decode(params, cache, token)
        outs.append(logits.cpu())
    return outs


def phase_dense_parity(cfg, p_cpu) -> None:
    p_gpu = to_card(p_cpu)
    r = np.random.default_rng(7)
    B, C = 2, 32
    prompts = r.integers(3, cfg.vocab_size, (B, C)).astype(np.int32)
    max_len = C + 8
    t0 = time.perf_counter()
    gpu = _run_dense_parity(cfg, p_gpu, DEVICE, prompts, max_len)
    t1 = time.perf_counter()
    cpu = _run_dense_parity(cfg, p_cpu, "cpu", prompts, max_len)
    t2 = time.perf_counter()
    print(f"phase 7 dense card vs CPU: qwen3-0.6b full ({cfg.num_layers} "
          f"layers) f32 (TF32 off), prefill {B}x{C} + 4 decode steps: "
          f"{check_parity('phase 7', gpu, cpu)}; card {t1 - t0:.2f}s, cpu "
          f"{t2 - t1:.2f}s")


# --- phase 8 -----------------------------------------------------------------

def phase_ssd_kernel_vs_plain() -> dict:
    """The SSD-scan kernel against its plain version on the card (y and
    the final state), every case with B and C as views into one
    projection as the model passes them, with each case's route
    (``kernel.py::route``) and, for bf16, its max error against the plain
    version in f32 on the same inputs (the cost of the tensor-core
    route's bf16 roundings); both served launches must take the tensor
    cores.  Then timed at both SSM main paths' launches.  Returns the
    timing of each main case, by name, and the launch keys
    (``kernel_bench.ssd_key``)
    the main paths must match."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.cases import (SSD_CASES, SSD_MAIN,
                                                    SSD_TOL, SSD_TP,
                                                    ssd_case_on)
    from repro_torch.kernels.ssd_scan.kernel import TENSOR_CORES, route
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    errs, worst, vs32 = [], 0.0, []
    for seed, (name, (B, S, H, P, G, N, chunk), init) in \
            enumerate(SSD_CASES):
        for dt in (torch.float32, torch.bfloat16):
            xb, a, Bm, Cm, s0 = ssd_case_on(DEVICE, dt, B, S, H, P, G, N,
                                            init, seed)
            y, st = ssd_ops.ssd_scan(xb, a, Bm, Cm, chunk=chunk,
                                     initial_state=s0)
            yr, sr = ssd_scan_ref(xb, a, Bm, Cm, chunk=chunk,
                                  initial_state=s0)
            torch.cuda.synchronize()
            if y.dtype != dt or st.dtype != torch.float32:
                raise AssertionError(f"{name}: y {y.dtype}, state {st.dtype}")
            tol = SSD_TOL[dt]
            for what, got, ref in (("y", y, yr), ("state", st, sr)):
                a_, b_ = got.float(), ref.float()
                err = (a_ - b_).abs().max().item()
                if not torch.allclose(a_, b_, atol=tol, rtol=tol):
                    raise AssertionError(f"{name} {dt} {what}: kernel vs "
                                         f"plain max abs err {err:.3g} > "
                                         f"{tol}")
                worst = max(worst, err)
            path = route(dt, chunk, P, N)
            errs.append(f"{name}/{str(dt)[6:]}"
                        f"{'/tc' if path == TENSOR_CORES else ''}="
                        f"{(y.float() - yr.float()).abs().max().item():.2g}")
            if dt == torch.bfloat16:
                # the same bf16 inputs through the plain version in f32
                # (no rounding of y): the tensor-core route's own roundings
                # (L, the scaled xb, the state's copy, y) must stay inside
                # the bf16 tolerance, |err| <= tol + tol * |ref|
                y32, s32 = ssd_scan_ref(xb.float(), a, Bm.float(),
                                        Cm.float(), chunk=chunk,
                                        initial_state=s0)
                used = []
                for what, got, ref in (("y", y.float(), y32),
                                       ("state", st, s32)):
                    diff = (got - ref).abs()
                    frac = (diff / (tol + tol * ref.abs())).max().item()
                    if frac > 1:
                        raise AssertionError(f"{name} bf16 {what}: kernel "
                                             f"vs the f32 plain version "
                                             f"past the tolerance {tol}")
                    used.append(f"{what} {diff.max().item():.3g} "
                                f"({frac:.2f} of tol)")
                vs32.append(f"{name} {', '.join(used)}")
    print(f"phase 8 ssd kernel vs plain: {len(errs)} cases ok (y and final "
          f"state; /tc = tensor-core route), max abs err {worst:.3g} "
          f"[{' '.join(errs)}]")
    print(f"phase 8 ssd bf16 kernel vs the f32 plain version, max abs err "
          f"and the largest share used of the tolerance (atol = rtol = "
          f"{SSD_TOL[torch.bfloat16]}): {'; '.join(vs32)}")
    out, keys = {}, {}
    cases = {name: (shape, init) for name, shape, init in SSD_CASES}
    for arch, name in SSD_MAIN.items():
        (B, S, H, P, G, N, chunk), init = cases[name]
        if route(torch.bfloat16, chunk, P, N) != TENSOR_CORES:
            raise AssertionError(f"{arch}'s SSD launch {name} does not take "
                                 f"the tensor cores")
        row, keys[arch] = kb.time_ssd("phase 8", name)
        out[name] = dict(max_abs_err=worst, **_json(row))
    # one model rank's launch on a model axis of two (phase 33's prefill)
    for name in SSD_TP.values():
        kb.time_ssd("phase 8", name)
    return out, keys


# --- phases 9 and 10 ----------------------------------------------------------

SSM_ARGV = ["--arch", "mamba2-780m", "--backend", "dense", "--requests", "8",
            "--prompt-len", "384", "--decode-steps", "32", "--budget-gb", "8",
            "--device", "cuda"]
HYBRID_ARGV = ([a if a != "qwen3-0.6b" else "zamba2-2.7b" for a in MAIN_ARGV]
               + ["--backend", "dense"])
#: (phase, arch, argv, Mamba2 layers, shared-attention applications): the
#: SSM path serves prompts of 192-384 tokens, which its one prefill call
#: pads to the longest (384 with the default seed: three chunks of 128),
#: the hybrid path phase 6's load
SSM_PATHS = [(9, "mamba2-780m", SSM_ARGV, 48, 0),
             (10, "zamba2-2.7b", HYBRID_ARGV, 54, 9)]


def phase_ssm_path(n, arch, argv, layers, apps, ssd_key_want) -> dict:
    """An SSM-family main path at full width and depth: 8 requests must
    complete, the SSD kernel must run once per Mamba2 layer per prefill
    call, and every such launch at the shapes, strides and initial state
    phase 8 checked and timed (``ssd_key_want``), the flash and
    dense-decode kernels once per application of the shared attention per
    prefill call and decode step (none for mamba2), and the paged kernel
    never."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.cases import SSD_MAIN
    cfg = get_config(arch)
    launch, seen = ssd_ops.ssd_scan_fwd, set()

    def recorded(xb, a, B_mat, C_mat, *, chunk, initial_state=None):
        seen.add(kb.ssd_key(xb, B_mat, chunk, initial_state))
        return launch(xb, a, B_mat, C_mat, chunk=chunk,
                      initial_state=initial_state)

    ssd_ops.ssd_scan_fwd = recorded
    try:
        out, counts = serve_counted(argv)
    finally:
        ssd_ops.ssd_scan_fwd = launch
    if seen != {ssd_key_want}:
        raise AssertionError(f"SSD launches at {seen}; phase 8 checked and "
                             f"timed {ssd_key_want}")
    summary, backends = out["summary"], out["backends"]
    check_served(out, cfg)
    pre = sum(be.prefill_calls for be in backends)
    dec = sum(be.decode_calls for be in backends)
    n_apps = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
              else 0)
    check_launches(counts, {"flash_attention_fwd": apps * pre,
                            "decode_attention_fwd": apps * dec,
                            "ssd_scan_fwd": layers * pre,
                            **norm_launches(arch, pre, dec)}, cfg, layers)
    if n_apps != apps or pre == 0 or dec == 0:
        raise AssertionError(f"{n_apps} shared-attention applications (want "
                             f"{apps}), {pre} prefill calls, {dec} decode "
                             f"steps")
    dec_s = sum(be.decode_seconds for be in backends)
    tok = summary["good_tokens"]
    print(f"phase {n} {cfg.family} path: {arch} full ({layers} layers, "
          f"d={cfg.d_model}, {apps} shared-attention applications, "
          f"{cfg.param_dtype}) served {summary['completed']}/8 requests, "
          f"{tok} tokens in {out['wall_s']:.2f}s wall "
          f"({tok / out['wall_s']:.1f} tok/s); {pre} prefill calls, {dec} "
          f"decode steps, mean {1e3 * dec_s / dec:.2f} ms/step; launches "
          f"{counts} = ssd {layers} x {pre}, flash {apps} x {pre}, decode "
          f"{apps} x {dec}, {norms_line(counts, arch, pre, dec)}, every "
          f"SSD launch at phase 8's "
          f"{SSD_MAIN[arch]} case; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    dense_decode_profile(backends[0],
                         f"phase {n} {cfg.family} decode-step profile")
    prefill_profile(backends[0], f"phase {n} {cfg.family} prefill profile",
                    ssd_key_want[0][1])
    return counts


# --- phase 11 ----------------------------------------------------------------

#: (arch, layers or None for the published depth): zamba2 keeps its full
#: width but runs 12 of its 54 layers (2 shared-attention applications),
#: so the CPU side stays within the run's memory and time
SSM_PARITY = [("mamba2-780m", None), ("zamba2-2.7b", 12)]


def phase_ssm_parity() -> None:
    """Card vs CPU in f32 (TF32 off) on the SSM and hybrid paths: a
    ``prefill`` of 2 rows x 160 tokens (two chunks of 128, the second
    ragged) and 4 ``decode_step``s; greedy tokens equal, logits within
    ``PARITY_ATOL``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    for seed, (arch, layers) in enumerate(SSM_PARITY):
        cfg = get_config(arch).replace(param_dtype="float32",
                                       compute_dtype="float32")
        full = cfg.num_layers
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        p_cpu = model_lib.init(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
        r = np.random.default_rng(11 + seed)
        B, C = 2, 160
        prompts = r.integers(3, cfg.vocab_size, (B, C)).astype(np.int32)
        t0 = time.perf_counter()
        gpu = _run_dense_parity(cfg, to_card(p_cpu), DEVICE, prompts, C + 8)
        t1 = time.perf_counter()
        cpu = _run_dense_parity(cfg, p_cpu, "cpu", prompts, C + 8)
        t2 = time.perf_counter()
        depth = (f"{cfg.num_layers} layers" if layers is None else
                 f"{cfg.num_layers} of its {full} layers (depth cut)")
        print(f"phase 11 {cfg.family} card vs CPU: {arch} full width "
              f"(d={cfg.d_model}), {depth}, f32 (TF32 off), prefill {B}x{C} "
              f"+ 4 decode steps: {check_parity('phase 11', gpu, cpu)}; "
              f"card {t1 - t0:.2f}s, cpu {t2 - t1:.2f}s")
        del p_cpu, gpu, cpu
        gc.collect()
        torch.cuda.empty_cache()


# --- phase 12 ----------------------------------------------------------------

#: the RMSNorm kernels, and the timed shape of each (``cases.py``'s
#: RMSNORM_TIMED or FUSED_TIMED) whose numbers go into the JSON line: the
#: MoE path's decode step, and zamba2's prefill for the gated norm
NORM_JSON = {"rmsnorm_fwd": "qwen3-moe decode",
             "add_rmsnorm_fwd": "qwen3-moe decode",
             "qk_norm_rope_fwd": "qwen3-moe paged decode",
             "gated_rmsnorm_fwd": "zamba2 prefill"}


def phase_rmsnorm_kernel_vs_plain() -> dict:
    """The RMSNorm kernels against their plain versions on the card, in
    four (x, w) dtype pairs: ``rmsnorm_fwd`` and ``add_rmsnorm_fwd`` on
    every case of ``RMSNORM_CASES``, ``gated_rmsnorm_fwd`` on every case
    of ``GATED_FWD_CASES`` (those and the train launch and the plan's
    loops), ``qk_norm_rope_fwd`` on every case of ``QK_ROPE_FWD_CASES``
    (``QK_ROPE_CASES``, the train launch and the plan's loops); each fused
    kernel must also equal the unfused card sequence in every element.
    Then timed (``kernel_bench.time_norm_kernels``).  Returns the JSON
    numbers of each kernel, by name."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_ref,
                                                 gated_rmsnorm_ref,
                                                 qk_norm_rope_ref,
                                                 rmsnorm_ref)
    C = kb.norm_cases()
    worst = {name: 0.0 for name in NORM_JSON}
    cases = {name: 0 for name in NORM_JSON}
    differ = {name: 0 for name in NORM_JSON}

    def check(name, label, xdt, got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref, strict=True):
            if g.shape != r.shape or g.dtype != xdt:
                raise AssertionError(f"{name} {label}: {g.shape} {g.dtype}")
            if g.numel():                                 # else no rows
                worst[name] = max(worst[name], _check_close(
                    f"{name} {label}", xdt, g, r, []))
        cases[name] += 1

    for seed, (case, shape, layout) in enumerate(C.RMSNORM_CASES):
        for xdt, wdt in C.RMSNORM_DTYPES:
            label = f"{case}/w{str(wdt)[6:]}"
            x, w = C.rmsnorm_case_on(DEVICE, xdt, wdt, shape, layout, seed)
            check("rmsnorm_fwd", label, xdt, rms_ops.rmsnorm(x, w, 1e-6),
                  rmsnorm_ref(x, w, 1e-6))
            a, b, w = C.pair_case_on(DEVICE, xdt, wdt, shape, layout, seed)
            got = rms_ops.add_rmsnorm(a, b, w, 1e-6)
            check("add_rmsnorm_fwd", label, xdt, got,
                  add_rmsnorm_ref(a, b, w, 1e-6))
            differ["add_rmsnorm_fwd"] += kb.differ(
                got, C.add_rmsnorm_unfused(a, b, w, 1e-6))
            got = rms_ops.gated_rmsnorm(a, b, w, 1e-6)
            check("gated_rmsnorm_fwd", label, xdt, got,
                  gated_rmsnorm_ref(a, b, w, 1e-6))
            differ["gated_rmsnorm_fwd"] += kb.differ(
                got, C.gated_rmsnorm_unfused(a, b, w, 1e-6))
    # the gated kernel's card-only cases, after the shared ones
    for seed, (case, shape, layout) in enumerate(C.GATED_FWD_CASES):
        if seed < len(C.RMSNORM_CASES):
            continue
        for xdt, wdt in C.RMSNORM_DTYPES:
            label = f"{case}/w{str(wdt)[6:]}"
            a, b, w = C.pair_case_on(DEVICE, xdt, wdt, shape, layout, seed)
            got = rms_ops.gated_rmsnorm(a, b, w, 1e-6)
            check("gated_rmsnorm_fwd", label, xdt, got,
                  gated_rmsnorm_ref(a, b, w, 1e-6))
            differ["gated_rmsnorm_fwd"] += kb.differ(
                got, C.gated_rmsnorm_unfused(a, b, w, 1e-6))
    theta = C.QK_ROPE_THETA
    for seed, (case, dims, positions, norm, layout) in \
            enumerate(C.QK_ROPE_FWD_CASES):
        for xdt, wdt in C.RMSNORM_DTYPES:
            args = C.qk_rope_case_on(DEVICE, xdt, wdt, dims, positions, norm,
                                     layout, seed)
            got = rms_ops.qk_norm_rope(*args, theta, 1e-6)
            check("qk_norm_rope_fwd", f"{case}/w{str(wdt)[6:]}", xdt, got,
                  qk_norm_rope_ref(*args, theta, 1e-6))
            differ["qk_norm_rope_fwd"] += kb.differ(
                got, C.qk_norm_rope_unfused(*args, theta, 1e-6))
    torch.cuda.synchronize()
    for name in NORM_JSON:
        unfused = ("" if name == "rmsnorm_fwd" else
                   f"; {differ[name]} elements differ from the unfused card "
                   f"sequence")
        print(f"phase 12 {name} vs plain: {cases[name]} cases ok (shapes, "
              f"layouts and (x, w) dtype pairs), max abs err "
              f"{worst[name]:.3g} (tol f32 {TOL[torch.float32]}, bf16 "
              f"{TOL[torch.bfloat16]}){unfused}")
    if any(differ.values()):
        raise AssertionError(f"fused kernels differ from the unfused card "
                             f"sequences: {differ}")
    rows = {(r["kernel"], r["launch"]): r
            for r in kb.time_norm_kernels("phase 12", C)}
    return {name: dict(max_abs_err=worst[name], **_json(rows[name, at]))
            for name, at in NORM_JSON.items()}


def phase_split_norm_vs_plain() -> dict:
    """The split gated norm's four entries (Mamba2 under tensor
    parallelism: each rank's columns of a row, the sums over the ranks
    between the launches) on every case of ``SPLIT_CASES`` in the four
    (x, w) dtype pairs: each rank's outputs against the plain versions
    fed the kernels' sums, and the ranks' outputs side by side against
    the whole-row ``gated_rmsnorm_fwd`` / ``_bwd`` (``cases.py::
    split_check``'s bounds).  Then timed (``kernel_bench.
    time_split_norm``).  Returns the JSON numbers of each entry, by
    name."""
    C = kb.norm_cases()
    worst = {}
    n = 0
    for seed, case in enumerate(C.SPLIT_CASES):
        for xdt, wdt in C.RMSNORM_DTYPES:
            errs = C.split_check(DEVICE, xdt, wdt, case, seed)
            bad = {k: v for k, v in errs.items() if not v[1]}
            if bad:
                raise AssertionError(f"split gated norm {case[0]} "
                                     f"{xdt}/{wdt}: {bad}")
            for k, (err, _) in errs.items():
                key = k.split("[")[0]
                worst[key] = max(worst.get(key, float("-inf")), err)
            n += 1
    torch.cuda.synchronize()
    print(f"phase 12 split gated norm (gated_rmsnorm_sumsq, _scale, _dot, "
          f"_scale_bwd) vs plain and vs the whole-row kernels: {n} cases ok "
          f"(widths 24 to 2,560 a rank, 2 or 4 ranks, four (x, w) dtype "
          f"pairs); the largest excess over each bound's ulps (<= its f32 "
          f"floor; the sums relative): "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    timing = {r["kernel"]: r for r in kb.time_split_norm("phase 12", C)}
    errs = {"gated_rmsnorm_sumsq": worst["sumsq"],
            "gated_rmsnorm_scale": max(worst["scale"],
                                       worst["scale vs whole"]),
            "gated_rmsnorm_dot": worst["dot"],
            "gated_rmsnorm_scale_bwd": max(
                worst[k] for k in worst if k[:2] in ("dy", "dz", "dw"))}
    return {e: dict(max_abs_err=errs[e], **_json(timing[e]))
            for e in timing}


# --- phases 13, 14 and 15 ----------------------------------------------------

MOE = "qwen3-moe-30b-a3b"
#: 8 requests of 64-128 prompt tokens and 16-32 new tokens; the budget is
#: the estimator's 56.9 GB weight intercept plus room for the 8 requests
MOE_ARGV = ["--arch", MOE, "--requests", "8", "--prompt-len", "128",
            "--decode-steps", "32", "--budget-gb", "64", "--device", "cuda"]


def phase_moe_parity() -> None:
    """Card vs CPU in f32 (TF32 off) on both MoE paths: qwen3-moe at full
    width and 2 of its 48 layers, random weights from one CPU generator,
    2 rows x 32 tokens (a prefill chunk, or a prefill) and 4 decode
    steps; greedy tokens equal, logits within ``PARITY_ATOL``.  Prints
    the smallest gap seen between the k-th and (k+1)-th router
    probability of any token on either side."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_mod
    cfg = get_config(MOE).replace(param_dtype="float32",
                                  compute_dtype="float32", num_layers=2)
    t0 = time.perf_counter()
    p_cpu = model_lib.init(cfg, torch.Generator().manual_seed(5), "cpu")
    p_gpu = to_card(p_cpu)
    t_init = time.perf_counter() - t0
    r = np.random.default_rng(13)
    B, C, page, num_pages = 2, 32, 16, 9
    prompts = r.integers(3, cfg.vocab_size, (B, C)).astype(np.int32)
    table = np.zeros((B, num_pages - 1), np.int32)
    table[:, :3] = r.permutation(np.arange(1, num_pages))[:6].reshape(B, 3)
    runs = {"prefill chunk + 4 paged decode steps": lambda p, dev:
            _run_parity(cfg, p, dev, prompts, table, num_pages, page),
            "prefill + 4 dense decode steps": lambda p, dev:
            _run_dense_parity(cfg, p, dev, prompts, C + 8)}
    real, gaps = moe_mod.router_topk, []

    def recorded(logits, k):
        top = torch.topk(torch.softmax(logits.float(), -1), k + 1).values
        gaps.append((top[:, k - 1] - top[:, k]).min().item())
        return real(logits, k)

    moe_mod.router_topk = recorded
    try:
        for kind, run in runs.items():
            t0 = time.perf_counter()
            gpu = run(p_gpu, DEVICE)
            t1 = time.perf_counter()
            cpu = run(p_cpu, "cpu")
            t2 = time.perf_counter()
            print(f"phase 15 moe card vs CPU: {MOE} full width "
                  f"(d={cfg.d_model}, {cfg.num_experts} experts, top "
                  f"{cfg.experts_per_token}), 2 of its 48 layers (depth "
                  f"cut), f32 (TF32 off), {B}x{C} {kind}: "
                  f"{check_parity('phase 15', gpu, cpu)}; card "
                  f"{t1 - t0:.2f}s, cpu {t2 - t1:.2f}s")
    finally:
        moe_mod.router_topk = real
    print(f"phase 15 smallest gap between the k-th and (k+1)-th router "
          f"probability over {len(gaps)} router calls (card and CPU): "
          f"{min(gaps):.3g}; weights drawn in {t_init:.2f}s")
    del p_cpu, p_gpu
    gc.collect()
    torch.cuda.empty_cache()


# --- phase 16 ----------------------------------------------------------------

def phase_rmsnorm_bwd_vs_plain() -> dict:
    """The four RMSNorm backward kernels on the card against their plain
    formulas and against torch.autograd of the plain forwards, on every
    case of ``kernels/rmsnorm/cases.py`` (the row kernels on
    RMSNORM_BWD_CASES, the qk-norm-RoPE one on QK_ROPE_BWD_CASES: the
    forward's cases and train-size ones that walk the launch plan's
    loops) in the four
    (x, w) dtype pairs (TOL by x's dtype, a weight gradient by the looser
    of x's and w's, relative to its largest value: a bf16 x rounds the
    terms its sum adds); each call made twice on the same
    inputs must give the same bits (dw's fixed-order sum).  Then each is
    timed at the train step's launch (``BWD_TIMED``; each entry has one).
    Returns the JSON
    numbers of each backward kernel, by name."""
    C = kb.norm_cases()
    worst = {e: [0.0, 0.0] for e in C.BWD_ENTRIES}
    cases = {e: 0 for e in C.BWD_ENTRIES}
    differ = {e: 0 for e in C.BWD_ENTRIES}
    for entry in C.BWD_ENTRIES:
        case_list = (C.QK_ROPE_BWD_CASES if entry == "qk_norm_rope_bwd"
                     else C.RMSNORM_BWD_CASES)
        for seed, case in enumerate(case_list):
            for xdt, wdt in C.RMSNORM_DTYPES:
                kernel, plain, auto = C.bwd_case(entry, DEVICE, xdt, wdt,
                                                 case, seed)
                got = kernel()
                for i, want in enumerate((plain(), auto())):
                    err, ok = C.bwd_max_err(got, want, TOL[xdt],
                                            max(TOL[xdt], TOL[wdt]))
                    if not ok:
                        raise AssertionError(
                            f"{entry} {case[0]} {xdt}/{wdt}: kernel vs "
                            f"{('plain', 'autograd')[i]} err {err:.3g}")
                    worst[entry][i] = max(worst[entry][i], err)
                again = kernel()
                differ[entry] += sum(int((g != a).sum()) for g, a in
                                     zip(got, again) if g is not None)
                cases[entry] += 1
    torch.cuda.synchronize()
    for entry in C.BWD_ENTRIES:
        print(f"phase 16 {entry} vs plain: {cases[entry]} cases ok "
              f"(shapes, layouts and (x, w) dtype pairs), max err vs the "
              f"plain formula {worst[entry][0]:.3g}, vs autograd of the "
              f"plain forward {worst[entry][1]:.3g} (tol f32 "
              f"{TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}; dw "
              f"relative to max|dw| at the looser of x's and w's); a "
              f"second call on the same inputs: "
              f"{differ[entry]} elements differ")
    if any(differ.values()):
        raise AssertionError(f"backward kernels are not deterministic: "
                             f"{differ}")
    timing = {r["kernel"]: r
              for r in kb.time_norm_bwd_kernels("phase 16", C)}
    return {e: dict(max_abs_err=worst[e][0], **_json(timing[e]))
            for e in C.BWD_ENTRIES}


# --- phases 17 and 18 --------------------------------------------------------

#: phase 17's train runs: the checkpoint directory (gitignored), the
#: qwen3-0.6b main path and the short mamba2-780m run (full width, 8 of
#: its 48 layers, to keep the phase short)
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
TRAIN_STEPS = 20
TRAIN_ARGV = ["--arch", "qwen3-0.6b", "--device", "cuda", "--steps",
              str(TRAIN_STEPS), "--batch", "8", "--seq", "1024", "--seed",
              "0", "--ckpt-every", str(TRAIN_STEPS)]
MAMBA_TRAIN_ARGV = ["--arch", "mamba2-780m", "--layers", "8", "--device",
                    "cuda", "--steps", "6", "--batch", "4", "--seq", "512",
                    "--seed", "0", "--ckpt-every", "1000"]


def train_norm_launches(cfg, steps: int) -> dict:
    """Each RMSNorm kernel's launches in ``steps`` train steps of ``cfg``
    under ``remat="full"``.  One forward runs every norm once (F): the
    first layer's pre-norm and the final norm are ``rmsnorm_fwd`` (the
    train mode's hidden is summed before the final norm), every other
    pre-norm ``add_rmsnorm_fwd``, each attention layer's qk-norm and RoPE
    ``qk_norm_rope_fwd``, each Mamba2 layer's gate ``gated_rmsnorm_fwd``
    and gemma2's two post-norms per layer ``rmsnorm_fwd``; whisper's
    encoder adds its first pre-norm, its other pre-norms and its final
    norm, and its decoder has three pre-norms per layer.  The backward
    recomputes every layer (or gemma2's layer pair: F less the norms
    outside the layers, the final norm and whisper's encoder final norm)
    and runs each norm's backward once (F)."""
    L = cfg.num_layers
    if cfg.family == "encdec":
        per_fwd = {"rmsnorm": 3, "add_rmsnorm": 5 * L - 1,
                   "qk_norm_rope": L}
        outside = {"rmsnorm": 1, "add_rmsnorm": 1}
    else:
        apps = {"ssm": 0, "hybrid": L // max(cfg.attn_every, 1)}.get(
            cfg.family, L)
        mamba = L if cfg.family in ("ssm", "hybrid") else 0
        post = 2 * apps if cfg.use_post_norm else 0
        per_fwd = {"rmsnorm": 2 + post, "add_rmsnorm": 2 * apps + mamba - 1,
                   "qk_norm_rope": apps, "gated_rmsnorm": mamba}
        outside = {"rmsnorm": 1}
    assert cfg.remat == "full", cfg.remat
    out = {}
    for op, n in per_fwd.items():
        if n:
            out[f"{op}_fwd"] = steps * (2 * n - outside.get(op, 0))
            out[f"{op}_bwd"] = steps * n
    return out


def train_counted(argv):
    """``train.main(argv)`` with every kernel's launch count set to 0
    just before and read just after, and the peak memory reset."""
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fns = launchers()
    for f in fns.values():
        f.launches = 0
    out = train.main(argv)
    return out, {name: f.launches for name, f in fns.items()}


def check_train_run(label: str, out, counts, cfg, steps: int) -> None:
    want = train_norm_launches(cfg, steps)
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{label}: launches {counts}; want {full} (no "
                             f"attention or SSD kernel in a train step)")
    losses = out["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")


def train_step_profile(out, label: str, step_s: float,
                       argv=TRAIN_ARGV) -> dict:
    """``torch.profiler`` over one train step from the run's final state
    (the next step's batch; ``argv`` the run's): host ms, device busy,
    the idle share of an unprofiled step (``step_s``, the run's median)
    and of the profiled one, kernels per step, the RMSNorm kernels' and
    the NCCL collectives' shares of busy and the top device ops.
    Returns the device ms by kernel name (empty where the profiler saw
    no device time)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    cfg, step_fn = out["cfg"], out["step_fn"]
    B, S, at = (int(argv[argv.index(a) + 1])
                for a in ("--batch", "--seq", "--steps"))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in make_batch(
        cfg, ShapeConfig("t", "train", S, B), DataConfig(), at).items()}
    state = [out["params"], out["opt"]]
    out["params"] = out["opt"] = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state[0], state[1], _ = step_fn(state[0], state[1], batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"{label}: {1e3 * wall:.1f} ms per step (host clock, under "
              f"the profiler); the profiler saw no device time: busy and "
              f"idle share not measured")
        return {}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    norm = sum(t for n, t in by_name.items()
               if "norm_kernel" in n or "norm_bwd_kernel" in n
               or "sum_partials_kernel" in n or "qk_norm_rope" in n)
    norm_bwd = sum(t for n, t in by_name.items()
                   if "bwd_kernel" in n or "sum_partials_kernel" in n)
    nccl = sum(t for n, t in by_name.items() if "nccl" in n.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: {1e3 * step_s:.1f} ms per step (host clock; "
          f"{1e3 * wall:.1f} under the profiler), device busy {busy:.1f} ms "
          f"({len(kernels)} kernels): idle share "
          f"{max(0.0, 1 - busy / (1e3 * step_s)):.3f} of an unprofiled "
          f"step, {1 - busy / (1e3 * wall):.3f} of the profiled one; "
          f"RMSNorm kernels "
          f"{norm:.2f} ms, {norm / busy:.4f} of busy (the backward "
          f"kernels and dw sums {norm_bwd:.2f} ms, {norm_bwd / busy:.4f} "
          f"of busy); NCCL kernels "
          f"{nccl:.3f} ms, {nccl / busy:.4f} of busy; top device ops ms: "
          + "; ".join(f"{n[:90]} {t:.2f}" for n, t in top))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return by_name


def phase_train_path() -> dict:
    """The training main path: ``repro_torch.launch.train.main`` trains
    full-width, full-depth qwen3-0.6b (bf16, random weights from a seed)
    for ``TRAIN_STEPS`` steps of 8 x 1024 tokens; the loss must fall
    (mean of the last 5 below the first 5), each RMSNorm kernel launch
    exactly its count and no attention or SSD kernel launch.  The
    checkpoint of the last step must restore bit for bit, and
    ``--resume`` must continue from it.  Then one step is profiled, and a
    short mamba2-780m run (``MAMBA_TRAIN_ARGV``) checks the gated norm's
    kernels and the plain SSD route.  Returns both runs' launch counts
    (the qwen3 run's, then the mamba2 run's)."""
    from repro_torch.checkpoint.checkpoint import latest_step, restore
    from repro_torch.configs import get_config
    from repro_torch.utils.tree import tree_leaves
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    argv = TRAIN_ARGV + ["--ckpt-dir", str(TRAIN_CKPT)]
    out, counts = train_counted(argv)
    cfg = out["cfg"]
    check_train_run("phase 17 qwen3-0.6b", out, counts, cfg, TRAIN_STEPS)
    tok = out["tokens_per_step"]
    for i, (s, peak) in enumerate(zip(out["step_s"], out["peak_bytes"])):
        print(f"phase 17 qwen3-0.6b step {i}: loss {out['losses'][i]:.4f}, "
              f"{s:.3f} s (host clock after synchronize), {tok / s:.0f} "
              f"tokens/s, peak device memory {peak / 2**30:.2f} GiB")
    losses = out["losses"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"phase 17: the loss did not fall: first 5 "
                             f"{first:.4f}, last 5 {last:.4f}")
    steady = sorted(out["step_s"][2:])[len(out["step_s"][2:]) // 2]
    C = {k: counts[k] for k in counts if counts[k]}
    print(f"phase 17 train main path: qwen3-0.6b full ({cfg.num_layers} "
          f"layers, d={cfg.d_model}, {cfg.param_dtype} params, fp32 Adam "
          f"moments, remat {cfg.remat}) trained {TRAIN_STEPS} steps of "
          f"8 x 1024 tokens: mean loss of the first 5 steps {first:.4f}, "
          f"of the last 5 {last:.4f}; median step (from step 2) "
          f"{steady:.3f} s, {tok / steady:.0f} tokens/s; peak device "
          f"memory {max(out['peak_bytes']) / 2**30:.2f} GiB; launches "
          f"{C} = per step {train_norm_launches(cfg, 1)} x {TRAIN_STEPS}; "
          f"flash, decode, paged and SSD kernels 0")
    # the checkpoint: step 20 restores bit for bit, and --resume continues
    if latest_step(str(TRAIN_CKPT)) != TRAIN_STEPS:
        raise AssertionError(f"phase 17: checkpoint step "
                             f"{latest_step(str(TRAIN_CKPT))}")
    tmpl = {"params": out["params"], "m": out["opt"].m, "v": out["opt"].v,
            "count": out["opt"].count}
    t0 = time.perf_counter()
    restored, step = restore(str(TRAIN_CKPT), tmpl)
    t_restore = time.perf_counter() - t0
    bad = sum(int((a != b).sum()) for a, b in zip(tree_leaves(restored),
                                                   tree_leaves(tmpl)))
    if bad or int(restored["count"]) != TRAIN_STEPS:
        raise AssertionError(f"phase 17: the checkpoint restores {bad} "
                             f"differing elements, count "
                             f"{int(restored['count'])}")
    del restored, tmpl
    train_step_profile(out, "phase 17 qwen3-0.6b train-step profile",
                       steady)
    del out
    resumed, _ = train_counted(argv + ["--steps", str(TRAIN_STEPS + 2),
                                       "--resume"])
    if resumed["start"] != TRAIN_STEPS or len(resumed["losses"]) != 2:
        raise AssertionError(f"phase 17: --resume started at "
                             f"{resumed['start']}, ran "
                             f"{len(resumed['losses'])} steps")
    print(f"phase 17 checkpoint: step {TRAIN_STEPS} (params, fp32 m and v, "
          f"count) restored bit for bit in {t_restore:.1f}s; --resume "
          f"--steps {TRAIN_STEPS + 2} continued from step "
          f"{resumed['start']} (losses {resumed['losses']})")
    del resumed
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    mout, mcounts = train_counted(MAMBA_TRAIN_ARGV
                                  + ["--ckpt-dir", str(TRAIN_CKPT)])
    mcfg, msteps = mout["cfg"], len(mout["losses"])
    check_train_run("phase 17 mamba2-780m", mout, mcounts, mcfg, msteps)
    if not mout["losses"][-1] < mout["losses"][0]:
        raise AssertionError(f"phase 17 mamba2: losses {mout['losses']}")
    ms = sorted(mout["step_s"][1:])[len(mout["step_s"][1:]) // 2]
    print(f"phase 17 mamba2-780m train: full width (d={mcfg.d_model}, "
          f"d_inner {mcfg.d_inner}), {mcfg.num_layers} of its "
          f"{get_config('mamba2-780m').num_layers} layers (depth cut to "
          f"keep the phase short), {msteps} steps of 4 x 512 tokens: losses "
          + ", ".join(f"{x:.3f}" for x in mout["losses"])
          + f"; median step {ms:.3f} s; peak device memory "
          f"{max(mout['peak_bytes']) / 2**30:.2f} GiB; launches "
          f"{ {k: v for k, v in mcounts.items() if v} }; attention and SSD "
          f"kernels 0 (the plain SSD scan)")
    del mout
    gc.collect()
    torch.cuda.empty_cache()
    return [counts, mcounts]


TRAIN_PARITY = [("qwen3-0.6b", None), ("mamba2-780m", 8)]


def _train_step_on(cfg, tc, params, batch, device):
    """One step on ``device``: (loss, grad norm, grads, new params), the
    trees left on ``device`` (so two f32 copies of a 2-billion-parameter
    tree never sit in host memory at once; the comparison takes the CPU's
    leaves to the card one at a time)."""
    from repro_torch.train import optim
    from repro_torch.train.step import build_loss_fn, value_and_grad
    from repro_torch.utils.tree import tree_map
    p = tree_map(lambda t: t.to(device), params)
    b = {k: v.to(device) for k, v in batch.items()}
    (loss, metrics), grads = value_and_grad(build_loss_fn(cfg), p, b)
    new, _, om = optim.adamw_update(p, grads, optim.init_opt_state(p, tc),
                                    tc)
    return float(loss), float(om["grad_norm"]), grads, new


def phase_train_parity(n: int = 18, archs=None,
                       init_device: str = "cpu") -> None:
    """One train step (value_and_grad + AdamW) of each arch of ``archs``
    (default ``TRAIN_PARITY``: full-width qwen3-0.6b at full depth and
    mamba2-780m at 8 of 48 layers) in f32, 2 rows x 64 tokens (the
    encdec's split into 32 tokens and 32 encoder frames, as
    ``data/pipeline.py`` splits it), the same params from one generator
    on ``init_device`` (the card draws billions of them in a second where
    the CPU takes tens), on the card and on the CPU; held to the bounds
    above."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as model_lib
    from repro_torch.utils.tree import flatten_with_paths, tree_map
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=100)
    for arch, layers in archs or TRAIN_PARITY:
        cfg = get_config(arch).replace(param_dtype="float32",
                                       compute_dtype="float32")
        if layers:
            cfg = cfg.replace(num_layers=layers)
        params = model_lib.init(
            cfg, torch.Generator(device=init_device).manual_seed(7),
            init_device)
        params = tree_map(lambda t: t.cpu(), params)
        batch = {k: torch.from_numpy(v) for k, v in make_batch(
            cfg, ShapeConfig("t", "train", 64, 2), DataConfig(), 0).items()}
        t0 = time.perf_counter()
        gl, gn, gg, gp = _train_step_on(cfg, tc, params, batch, DEVICE)
        t1 = time.perf_counter()
        cl, cn, cg, cp = _train_step_on(cfg, tc, params, batch, "cpu")
        t2 = time.perf_counter()
        if not (abs(gl - cl) <= TRAIN_LOSS_ATOL
                and abs(gn - cn) <= TRAIN_GRAD_RTOL * cn):
            raise AssertionError(f"phase {n} {arch}: loss {gl} vs {cl}, "
                                 f"grad norm {gn} vs {cn}")
        worst, strict, loose, n_strict, n_all = 0.0, 0.0, 0.0, 0, 0
        lr = TRAIN_LR
        for (path, g), (_, c), (_, p1), (_, p2), (_, p0) in zip(
                flatten_with_paths(gg), flatten_with_paths(cg),
                flatten_with_paths(gp), flatten_with_paths(cp),
                flatten_with_paths(params)):
            # compared on the card, one leaf of the CPU's trees at a time
            # (the same arithmetic, in seconds rather than minutes for a
            # tree of two billion parameters)
            c, p2, p0 = (t.to(DEVICE) for t in (c, p2, p0))
            scale = c.abs().max().item()
            err = (g - c).abs().max().item()
            rel = err / max(scale, 1e-30)
            worst = max(worst, rel)
            if rel > TRAIN_GRAD_RTOL:
                raise AssertionError(f"phase {n} {arch}: grad {path} max err "
                                     f"{err:.3g}, {rel:.3g} of its max")
            diff = (p1 - p2).abs()
            big = c.abs() >= max(1e-4 * scale, 10 * err, 1e-4)
            strict = max(strict, diff[big].max().item() if big.any() else 0)
            loose = max(loose, diff.max().item())
            n_strict += int(big.sum())
            n_all += big.numel()
            if (big.any() and diff[big].max().item() > 1e-6
                    * max(1.0, p0.abs().max().item())) \
                    or diff.max().item() > 2 * lr + 1e-6:
                raise AssertionError(f"phase {n} {arch}: param {path} after "
                                     f"the step differs by "
                                     f"{diff.max().item():.3g}")
        print(f"phase {n} {arch} card vs CPU, one train step in f32 (TF32 "
              f"off), full width, {cfg.num_layers} layers"
              f"{' (depth cut)' if layers else ''}, 2 x 64 tokens: loss "
              f"{gl:.6f} vs {cl:.6f} (|d| {abs(gl - cl):.3g} <= "
              f"{TRAIN_LOSS_ATOL}); grad norm {gn:.6f} vs {cn:.6f}; worst "
              f"grad leaf {worst:.3g} of its max (<= {TRAIN_GRAD_RTOL}); "
              f"after AdamW: {n_strict} of {n_all} params with a clear "
              f"gradient within {strict:.3g} (<= 1e-6), every param within "
              f"{loose:.3g} (<= 2 lr = {2 * lr:g}); card {t1 - t0:.1f}s, "
              f"cpu {t2 - t1:.1f}s")
        del params, gg, gp, cg, cp
        gc.collect()
        torch.cuda.empty_cache()


# --- phases 19 to 25: the remaining families -------------------------------

GEMMA2, WHISPER, PIXTRAL = "gemma2-27b", "whisper-large-v3", "pixtral-12b"
#: 8 requests of 64-128 prompt tokens and 16-32 new tokens, as phase 6
#: serves qwen3-0.6b; each budget holds the estimator's weights (gemma2
#: 50.7 GB, whisper 3.6, pixtral 22.8) and the 8 requests' KV
FAMILY_ARGV = ["--backend", "dense", "--requests", "8", "--prompt-len",
               "128", "--decode-steps", "32", "--device", "cuda"]
FAMILY_PATHS = [(19, GEMMA2, ["--budget-gb", "64"], 46),
                (21, WHISPER, ["--budget-gb", "16"], 32),
                (22, PIXTRAL, ["--budget-gb", "32"], 40)]
#: gemma2's long context: 2 requests of up to 4,160 prompt tokens and
#: 16 new; seed 167 draws prompts of 3,676 and 4,145 tokens, so the batch
#: prefills at 4,160 positions and the local layers' window (4,096)
#: masks the first keys in prefill and in every decode step
GEMMA2_LONG_ARGV = ["--arch", GEMMA2, "--backend", "dense", "--requests",
                    "2", "--prompt-len", "4160", "--decode-steps", "16",
                    "--budget-gb", "64", "--seed", "167", "--device", "cuda"]
#: phase 23: (arch, layers (None: all), (rows, prompt tokens), cache
#: slots); gemma2's 4,160-token prompt passes its window in prefill and
#: decode, pixtral's 32 tokens and 4 patches fill 36 of 38 slots, so its
#: last two decode steps write past the cache's end (clamped)
FAMILY_PARITY = [(GEMMA2, 2, (1, 4160), 4168), (WHISPER, None, (2, 32), 40),
                 (PIXTRAL, 2, (2, 32), 38)]
#: phase 24: (arch, the train CLI's extra argv); gemma2 at 2 of its 46
#: layers (46 layers' fp32 AdamW moments alone are 218 GB), whisper at
#: full depth with half of each sequence encoder frames
FAMILY_TRAIN = [(GEMMA2, ["--layers", "2", "--batch", "4"]),
                (WHISPER, ["--batch", "8"])]
FAMILY_TRAIN_STEPS = 6
#: phase 25: (arch, layers)
FAMILY_TRAIN_PARITY = [(GEMMA2, 2), (WHISPER, None)]


def phase_family_path(n: int, arch: str, extra, layers: int) -> dict:
    """A remaining family's dense main path (``phase_dense_path``); for
    pixtral, whose cache ``len`` counts its 4 patches ahead of the
    backend's position, the last decode steps must write past the cache's
    end (onto its last slot, as JAX clamps them)."""
    counts, _, positions, max_len = phase_dense_path(
        n, arch, ["--arch", arch] + FAMILY_ARGV + extra, layers)
    if arch == PIXTRAL:
        past = sum(p + 4 >= max_len for p in positions)
        if not past:
            raise AssertionError(f"phase {n}: no decode step wrote past the "
                                 f"cache (positions up to {max(positions)}"
                                 f", {max_len} slots)")
        print(f"phase {n} {arch}: {past} of {len(positions)} decode steps "
              f"wrote past the cache's {max_len} slots (len = position + "
              f"4 patches), onto its last slot")
    return counts


def phase_gemma2_long() -> dict:
    """gemma2-27b at full width and depth with a 4,160-position prefill
    (``GEMMA2_LONG_ARGV``): 2/2 requests, the same launch checks as
    ``phase_dense_path``, and a decode step profiled at 2 rows of 4,160
    tokens."""
    counts, reqs, positions, _ = phase_dense_path(
        20, GEMMA2, GEMMA2_LONG_ARGV, 46, requests=2, profile_batch=2,
        profile_ctx=4160)
    window = 4096
    if max(r.prompt_len for r in reqs) <= window or min(positions) < window:
        raise AssertionError(f"phase 20: the window does not bind: prompts "
                             f"{[r.prompt_len for r in reqs]}, decode "
                             f"positions {min(positions)}-{max(positions)}")
    print(f"phase 20 gemma2-27b long context: decode positions "
          f"{min(positions)}-{max(positions)}, past the local layers' "
          f"window of {window}")
    return counts


def phase_family_parity() -> None:
    """Card vs CPU in f32 (TF32 off) on the dense path of each
    FAMILY_PARITY arch at full width, random weights from one generator
    on the card, copied to the CPU: a prefill and 4 decode steps; greedy
    tokens equal, logits within ``PARITY_ATOL``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.utils.tree import tree_map
    for arch, layers, (B, C), max_len in FAMILY_PARITY:
        full = get_config(arch)
        cfg = full.replace(param_dtype="float32", compute_dtype="float32",
                           num_layers=layers or full.num_layers)
        t0 = time.perf_counter()       # drawn on the card, copied over
        p_cpu = tree_map(lambda t: t.cpu(), model_lib.init(
            cfg, torch.Generator(device=DEVICE).manual_seed(11), DEVICE))
        t_init = time.perf_counter() - t0
        r = np.random.default_rng(17)
        prompts = r.integers(3, cfg.vocab_size, (B, C)).astype(np.int32)
        extra = {}
        if cfg.family == "vlm":
            extra["patch_embeds"] = r.normal(
                0, 0.02, (B, 4, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            extra["enc_embeds"] = r.normal(
                0, 0.02, (B, 8, cfg.d_model)).astype(np.float32)
        t0 = time.perf_counter()
        gpu = _run_dense_parity(cfg, to_card(p_cpu), DEVICE, prompts,
                                max_len, extra)
        t1 = time.perf_counter()
        cpu = _run_dense_parity(cfg, p_cpu, "cpu", prompts, max_len, extra)
        t2 = time.perf_counter()
        what = {"vlm": " + 4 patches (the last 2 decode steps past the "
                       "cache's end)",
                "encdec": " + 8 encoder frames"}.get(cfg.family, "")
        print(f"phase 23 {arch} card vs CPU: full width (d={cfg.d_model}), "
              f"{cfg.num_layers} of its {full.num_layers} layers"
              f"{' (depth cut)' if layers else ''}, f32 (TF32 off), prefill "
              f"{B}x{C}{what} into {max_len} slots + 4 decode steps: "
              f"{check_parity('phase 23', gpu, cpu)}; weights drawn in "
              f"{t_init:.1f}s, card {t1 - t0:.2f}s, cpu {t2 - t1:.2f}s")
        del p_cpu, gpu, cpu
        gc.collect()
        torch.cuda.empty_cache()


def phase_family_train() -> list:
    """``repro_torch.launch.train.main`` on each FAMILY_TRAIN arch at full
    width (bf16 params, fp32 Adam moments, random weights from a seed)
    for ``FAMILY_TRAIN_STEPS`` steps of 512 tokens: the mean loss of the
    last 3 steps below the first 3's, each RMSNorm forward and backward
    kernel launched exactly its count (``train_norm_launches``) and no
    attention or SSD kernel.  Returns each run's launch counts."""
    from repro_torch.configs import get_config
    out_counts = []
    for arch, extra in FAMILY_TRAIN:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
        argv = ["--arch", arch, "--device", "cuda", "--steps",
                str(FAMILY_TRAIN_STEPS), "--seq", "512", "--seed", "0",
                "--ckpt-every", "1000", "--ckpt-dir", str(TRAIN_CKPT)] + extra
        out, counts = train_counted(argv)
        cfg, steps = out["cfg"], FAMILY_TRAIN_STEPS
        check_train_run(f"phase 24 {arch}", out, counts, cfg, steps)
        losses = out["losses"]
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        if not last < first:
            raise AssertionError(f"phase 24 {arch}: the loss did not fall: "
                                 f"{losses}")
        med = sorted(out["step_s"][1:])[len(out["step_s"][1:]) // 2]
        tok = out["tokens_per_step"]
        full = get_config(arch).num_layers
        cut = (" (depth cut: the fp32 moments of all of them exceed the "
               "card)" if cfg.num_layers < full else "")
        frames = ("half of them encoder frames, " if cfg.family == "encdec"
                  else "")
        print(f"phase 24 {arch} train: full width (d={cfg.d_model}), "
              f"{cfg.num_layers} of its {full} layers{cut}, {steps} steps "
              f"of {tok} tokens ({frames}remat {cfg.remat}): losses "
              + ", ".join(f"{x:.3f}" for x in losses)
              + f" (mean of the first 3 {first:.4f}, of the last 3 "
              f"{last:.4f}); median step (from step 1) {med:.3f} s, "
              f"{tok / med:.0f} tokens/s; peak device memory "
              f"{max(out['peak_bytes']) / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in counts.items() if v} } = per step "
              f"{train_norm_launches(cfg, 1)} x {steps}; attention and SSD "
              f"kernels 0")
        out_counts.append(counts)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return out_counts


# --- phases 26 and 27: scale-out -------------------------------------------

#: phase 26: the sharded steps (arch, expert-parallel, config overrides[,
#: options]), each 2 steps of 4 x 16 tokens at smoke size in f32: the
#: dense model, the MoE under expert parallelism at a capacity where
#: nothing drops without the aux term (whose mean over shards is not the
#: global batch's: tests/test_torch_sharded_train.py holds it to JAX's
#: sharded step), and the dense model accumulated over 2 microbatches of
#: batches whose rows count different tokens, each against the one-rank
#: step within SCALEOUT_TOL
SCALEOUT_RUNS = [("qwen3-0.6b", False, {}),
                 ("qwen3-moe-30b-a3b", True,
                  {"capacity_factor": 4.0, "router_aux_weight": 0.0}),
                 ("qwen3-0.6b", False, {},
                  {"microbatch": 2, "masked": True})]
#: phase 26's bounds, f32: the expert-parallel MoE's output (its
#: gradients 10x), the pipeline's output, the sharded steps' losses and
#: parameters (tests/test_distributed.py's bounds)
SCALEOUT_TOL = {"moe_y": 1e-5, "moe_grad": 1e-4, "pipeline": 1e-5,
                "step": 1e-4}
#: phase 27: full-width qwen3-moe-30b-a3b at 2 of its 48 layers on a
#: one-rank NCCL mesh with the expert-parallel MoE, and the same run
#: without a mesh
EP_STEPS = 6
EP_ARGV = ["--arch", MOE, "--layers", "2", "--device", "cuda", "--steps",
           str(EP_STEPS), "--batch", "8", "--seq", "512", "--seed", "0",
           "--ckpt-every", "1000"]


def _max_err(a, b) -> float:
    return float((torch.as_tensor(a).float()
                  - torch.as_tensor(b).float()).abs().max())


def _check(label: str, err: float, tol: float) -> float:
    if not err <= tol:
        raise AssertionError(f"phase 26 {label}: max err {err:.3g} > {tol}")
    return err


def phase_scaleout_ranks() -> None:
    """Four gloo ranks on the CPU as a (2, 2) mesh, spawned from this
    process with the card machine's torch (``tests/scaleout_ranks.py``,
    which imports no JAX): ``moe_ffn_ep`` against the port's ``moe_ffn``
    at factor 32 with ``tp_dispatch`` off and on (outputs and the
    gradients of x and all four weights), ``pipeline_apply`` against
    sequential application (2 stages on (2, 2), 4 on (4, 1), the stage
    parameters as slices and as DTensors), the sharded train steps of
    ``SCALEOUT_RUNS`` against the one-rank step, and ``restore(...,
    shardings=)`` of a checkpoint saved without a mesh onto the (2, 2)
    mesh.  Any failing rank or check fails the phase."""
    sys.path.insert(0, str(ROOT / "tests"))
    import scaleout_ranks
    from repro_torch.checkpoint.checkpoint import save
    from repro_torch.models.moe import moe_ffn
    from repro_torch.utils.tree import flatten_with_paths
    tmp = ROOT / "build" / "scaleout"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    rng = np.random.default_rng(0)
    # tests/test_torch_moe_ep.py's shapes and distributions
    N, d, E, f, k = 64, 16, 8, 24, 2
    z = {"x": rng.normal(1, 1, (N, d)), "r": rng.normal(0, 1, (N, d)),
         "wr": rng.normal(0, 1.0, (d, E)), "wg": rng.normal(0, 0.3, (E, d, f)),
         "wu": rng.normal(0, 0.3, (E, d, f)),
         "wd": rng.normal(0, 0.3, (E, f, d))}
    z = {n: a.astype(np.float32) for n, a in z.items()}
    np.savez(tmp / "moe.npz", **z)
    pz = {"W": rng.normal(0, 0.3, (4, 16, 16)),
          "b": rng.normal(0, 0.1, (4, 16)),
          "x": rng.normal(0, 1, (6, 2, 16)),
          "r": rng.normal(0, 1, (6, 2, 16))}
    pz = {n: a.astype(np.float32) for n, a in pz.items()}
    np.savez(tmp / "pipe.npz", **pz)
    saved = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "b": torch.ones(8), "h": torch.randn(4, 6).to(torch.bfloat16)}
    save(str(tmp / "ckpt"), 1, saved)
    B, S, steps = 4, 16, 2
    t0 = time.perf_counter()
    ranks = scaleout_ranks.spawn(
        "smoke_rank", tmp, str(tmp / "moe.npz"), k, str(tmp / "pipe.npz"),
        str(tmp / "ckpt"), SCALEOUT_RUNS, B, S, steps)
    t_ranks = time.perf_counter() - t0
    # the expert-parallel MoE against the dense path on the whole input
    w = {n: torch.from_numpy(z[n]).requires_grad_(True)
         for n in ("x", "wr", "wg", "wu", "wd")}
    y = moe_ffn(*w.values(), k=k, capacity_factor=32.0).y
    torch.sum(y * torch.from_numpy(z["r"])).backward()
    moe_y = moe_g = 0.0
    for r in ranks:
        di, mi = r["moe_ep"]["coord"]
        rows, e = slice(32 * di, 32 * di + 32), slice(4 * di, 4 * di + 4)
        c = slice(12 * mi, 12 * mi + 12)
        want = {"x": w["x"].grad[rows], "wr": w["wr"].grad,
                "wg": w["wg"].grad[e, :, c], "wu": w["wu"].grad[e, :, c],
                "wd": w["wd"].grad[e, c, :]}
        for case, o in r["moe_ep"]["out"].items():
            moe_y = max(moe_y, _check(f"moe_ffn_ep {case} y", _max_err(
                o["y"], y.detach()[rows]), SCALEOUT_TOL["moe_y"]))
            for n, g in want.items():
                moe_g = max(moe_g, _check(f"moe_ffn_ep {case} grad {n}",
                                          _max_err(o[n], g),
                                          SCALEOUT_TOL["moe_grad"]))
    # the pipeline and its gradients against sequential application
    pipe = pipe_g = 0.0
    for stages in (2, 4):
        seq = {n: torch.from_numpy(pz[n][:stages] if n != "x" else pz[n])
               .requires_grad_(True) for n in ("W", "b", "x")}
        ref = seq["x"]
        for st in range(stages):
            ref = torch.tanh(ref @ seq["W"][st] + seq["b"][st])
        torch.sum(ref * torch.from_numpy(pz["r"])).backward()
        for r in ranks:
            st = r["pipeline"][f"stage{stages}"]
            for held in ("", "_dtensor"):
                key = f"pipe{stages}{held}"
                pipe = max(pipe, _check(f"pipeline {key}", _max_err(
                    r["pipeline"][key], ref.detach()),
                    SCALEOUT_TOL["pipeline"]))
                for n, want in (("W", seq["W"].grad[st]),
                                ("b", seq["b"].grad[st]),
                                ("x", seq["x"].grad)):
                    pipe_g = max(pipe_g, _check(
                        f"pipeline {key} grad {n}",
                        _max_err(r["pipeline"][f"{key}_g{n}"], want),
                        SCALEOUT_TOL["pipeline"]))
    # the sharded steps against the one-rank step
    lines = []
    for i, (arch, ep, over, *opts) in enumerate(SCALEOUT_RUNS):
        ms, params = scaleout_ranks.one_rank_steps(arch, over, B, S, steps,
                                                   dict(*opts))
        got = ranks[0]["steps"][i]
        loss = max(abs(a["total_loss"] - b["total_loss"])
                   for a, b in zip(got["metrics"], ms))
        _check(f"{arch} sharded step loss", loss, SCALEOUT_TOL["step"])
        perr = max(_max_err(a, b) for (_, a), (_, b) in zip(
            flatten_with_paths(got["params"]), flatten_with_paths(params)))
        _check(f"{arch} sharded step params", perr, SCALEOUT_TOL["step"])
        for r in ranks:
            if r["steps"][i]["metrics"] != got["metrics"]:
                raise AssertionError(f"phase 26 {arch}: the ranks' metrics "
                                     f"differ")
        lines.append(f"{arch}{' --ep-moe' if ep else ''}"
                     f"{' ' + str(dict(*opts)) if opts else ''} loss |d| "
                     f"{loss:.3g}, params {perr:.3g}")
    # the elastic restore: every rank's slices, and the whole leaves
    for r in ranks:
        di, mi = r["restore"]["coord"]
        got = r["restore"]["tree"]
        want = {"w": saved["w"][:, 4 * mi:4 * mi + 4], "b": saved["b"],
                "h": saved["h"][2 * di:2 * di + 2, 3 * mi:3 * mi + 3]}
        for n, leaf in saved.items():
            if not (torch.equal(got[n][0].view(torch.int16)
                                if leaf.dtype == torch.bfloat16
                                else got[n][0],
                                want[n].view(torch.int16)
                                if leaf.dtype == torch.bfloat16 else want[n])
                    and torch.equal(got[n][2].float(), leaf.float())):
                raise AssertionError(f"phase 26 restore {n} on rank "
                                     f"{(di, mi)}: {got[n][1]}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 26 scale-out on 4 gloo ranks (CPU, torch "
          f"{torch.__version__}), (2, 2) mesh: moe_ffn_ep vs moe_ffn at "
          f"factor 32, tp_dispatch off and on, y max err {moe_y:.3g} (<= "
          f"{SCALEOUT_TOL['moe_y']}), grads {moe_g:.3g} (<= "
          f"{SCALEOUT_TOL['moe_grad']}); pipeline_apply vs sequential "
          f"(2 and 4 stages) {pipe:.3g}, its gradients (stage W, b and x) "
          f"{pipe_g:.3g}; sharded steps vs one rank, "
          f"{steps} steps of {B} x {S}: " + "; ".join(lines)
          + f"; restore onto the mesh: 4 ranks' slices exact; ranks "
          f"{t_ranks:.1f}s")


def ep_launches(cfg, steps: int) -> dict:
    """moe_ffn_ep's calls in ``steps`` train steps under ``remat="full"``
    (each MoE layer's forward, then its recompute in the backward) and
    its forward all-to-alls (two per call: the exchange and its
    reverse)."""
    assert cfg.remat == "full", cfg.remat
    calls = 2 * cfg.num_layers * steps
    return {"calls": calls, "all_to_all": 2 * calls}


def phase_ep_train() -> dict:
    """``repro_torch.launch.train.main`` with ``--mesh 1x1 --ep-moe``:
    full-width qwen3-moe-30b-a3b (2 of its 48 layers, 128 experts, k 8,
    bf16 params, fp32 moments) on a one-rank NCCL mesh, ``EP_STEPS``
    steps of 8 x 512 tokens, then the same run without a mesh.  With D =
    1 the capacity per source shard is the global one, so each step's
    loss must equal the run without a mesh within TRAIN_LOSS_ATOL;
    ``moe_ffn_ep`` must run in every MoE layer of every step (twice
    under remat) with two forward all-to-alls each, and each RMSNorm
    kernel exactly its count.  Prints the state's size, step time, peak
    memory and a profiled step (idle share, the NCCL kernels' share),
    each beside the card's name and power limit.  Returns the mesh run's
    launch counts."""
    import torch.distributed as dist
    # the process group outlives the run (its state and step function are
    # profiled after it): set up here, so the driver takes it over
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
        world_size=1)
    try:
        return _ep_train()
    finally:
        dist.destroy_process_group()


def _ep_train() -> dict:
    from repro_torch.models import moe_ep
    from repro_torch.train.sharded import gather_state
    from repro_torch.utils.tree import tree_bytes, tree_size
    card = card_line()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    argv = EP_ARGV + ["--ckpt-dir", str(TRAIN_CKPT)]
    mesh_argv = argv + ["--mesh", "1x1", "--ep-moe"]
    moe_ep.moe_ffn_ep.calls = moe_ep._exchange.launches = 0
    out, counts = train_counted(mesh_argv)
    ep = {"calls": moe_ep.moe_ffn_ep.calls,
          "all_to_all": moe_ep._exchange.launches}
    cfg = out["cfg"]
    check_train_run("phase 27 --mesh 1x1 --ep-moe", out, counts, cfg,
                    EP_STEPS)
    if ep != ep_launches(cfg, EP_STEPS):
        raise AssertionError(f"phase 27: moe_ffn_ep {ep}; want "
                             f"{ep_launches(cfg, EP_STEPS)}")
    whole = gather_state(out["params"])
    n_params, p_bytes = tree_size(whole), tree_bytes(whole)
    del whole
    losses, peak = out["losses"], max(out["peak_bytes"])
    med = sorted(out["step_s"][1:])[len(out["step_s"][1:]) // 2]
    tok = out["tokens_per_step"]
    by_name = train_step_profile(
        out, f"phase 27 --mesh 1x1 --ep-moe train-step profile [{card}]",
        med, mesh_argv)
    a2a = sum(t for n, t in by_name.items()
              if "sendrecv" in n.lower() or "alltoall" in n.lower())
    busy = sum(by_name.values())
    del out
    gc.collect()
    torch.cuda.empty_cache()
    ref, ref_counts = train_counted(argv)
    check_train_run("phase 27 without a mesh", ref, ref_counts, ref["cfg"],
                    EP_STEPS)
    diff = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
    if not diff <= TRAIN_LOSS_ATOL:
        raise AssertionError(f"phase 27: losses {losses} on the mesh, "
                             f"{ref['losses']} without (|d| {diff:.3g})")
    ref_med = sorted(ref["step_s"][1:])[len(ref["step_s"][1:]) // 2]
    ref_peak = max(ref["peak_bytes"])
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    a2a_share = (f"{a2a:.3f} ms, {a2a / busy:.4f} of device busy"
                 if busy else "not measured (no device time)")
    print(f"phase 27 --mesh 1x1 --ep-moe: {MOE} full width (d "
          f"{cfg.d_model}, {cfg.num_experts} experts, k "
          f"{cfg.experts_per_token}), {cfg.num_layers} of its 48 layers, "
          f"{n_params / 1e9:.3f} B params ({p_bytes / 2**30:.2f} GiB bf16, "
          f"fp32 moments {8 * n_params / 2**30:.2f} GiB), one NCCL rank, "
          f"{EP_STEPS} steps of 8 x 512: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; without a mesh max |d| {diff:.3g} (<= {TRAIN_LOSS_ATOL}); "
          f"moe_ffn_ep calls {ep['calls']}, forward all-to-alls "
          f"{ep['all_to_all']} = {ep_launches(cfg, 1)} x {EP_STEPS}; norm "
          f"launches {train_norm_launches(cfg, 1)} x {EP_STEPS}; median "
          f"step (from step 1) {med:.3f} s, {tok / med:.0f} tokens/s "
          f"[{card}]; without a mesh {ref_med:.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB, without a mesh {ref_peak / 2**30:.2f} "
          f"GiB [{card}]; the all-to-alls' kernels {a2a_share} [{card}]")
    return counts


# --- phase 28: the feature probe -------------------------------------------

#: the archs phase 28 probes at full width (a dense, an MoE, an SSM and a
#: local/global model), each for the train and the serve step
PROBE_ARCHS = ["qwen3-0.6b", MOE, "mamba2-780m", GEMMA2]
#: the memory model's steps of full-width qwen3-0.6b: (kind, seq, batch):
#: phase 17's train shape, and a decode at batch 8 against the 161-slot
#: cache of the dense serving paths; real steps timed per kind
MEMORY_STEPS = [("train", 1024, 8), ("decode", 161, 8)]
MEMORY_STEP_RUNS = 3


def _allocator_slack(tensors) -> int:
    """The most bytes the caching allocator may hold for ``tensors``
    beyond their own: each rounded up to a 512-byte block, and a block
    from the large pool (above 1 MiB) kept whole when what would be left
    after splitting it is at most 1 MiB."""
    return sum(511 + (2**20 if t.numel() * t.element_size() > 2**20 else 0)
               for t in tensors)


def phase_feature_probe() -> list:
    """The feature probe on full-width models, then the memory model and
    the roofline against real steps on the card.  Returns the real
    steps' launch counts (train, then decode)."""
    from repro_torch.configs import get_config
    from repro_torch.core.features import (features_from_record,
                                           probe_record)
    card = card_line()
    fns = launchers()
    before = {n: f.launches for n, f in fns.items()}
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    for arch in PROBE_ARCHS:
        cfg = get_config(arch)
        for kind in ("train", "decode"):
            t0 = time.perf_counter()
            rec = probe_record(cfg, kind)
            sec = time.perf_counter() - t0
            f = features_from_record(rec)
            if f.shape != (22,) or not np.all(np.isfinite(f)):
                raise AssertionError(f"phase 28 {arch} {kind}: {f}")
            c = rec["step_cost"]
            print(f"phase 28 probe {arch} {kind} (full width, 2 x 64, "
                  f"torch {torch.__version__}): {c.flops:.6g} FLOPs, "
                  f"{c.hbm_bytes:.6g} bytes, peak temporaries "
                  f"{c.peak_temp_bytes / 2**30:.3f} GiB, arguments "
                  f"{c.argument_bytes / 2**30:.3f} GiB, {c.op_count} ops, "
                  f"loops {[lp['trip'] for lp in c.loops]}; {sec:.1f}s")
    after = {n: f.launches for n, f in fns.items()}
    torch.cuda.synchronize()
    if after != before or torch.cuda.memory_allocated() != mem0:
        raise AssertionError(f"phase 28: the probes launched {after} "
                             f"(before {before}) or allocated "
                             f"{torch.cuda.memory_allocated() - mem0} B")
    counts = [_memory_step(kind, seq, batch, card)
              for kind, seq, batch in MEMORY_STEPS]
    print(f"phase 28: {len(PROBE_ARCHS) * 2} probes, no kernel launched, "
          f"device memory unchanged [{card}]")
    return counts


def _memory_step(kind: str, seq: int, batch: int, card: str) -> dict:
    """Full-width qwen3-0.6b (bf16): the probe's record of the ``kind``
    step at ``batch`` x ``seq``, then the same step on the card from
    ``concrete_inputs``, its peak memory and time beside the record's;
    returns its launch counts."""
    from repro_torch.configs import concrete_inputs, get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core.features import probe_record
    from repro_torch.models import model as model_lib
    from repro_torch.train import optim
    from repro_torch.train.step import build_serve_step, build_train_step
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    rec = probe_record(cfg, kind, seq, batch)
    probe_s = time.perf_counter() - t0
    c, rl = rec["step_cost"], rec["roofline"]
    predicted = c.argument_bytes + c.peak_temp_bytes + c.output_bytes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = model_lib.init(cfg, torch.Generator().manual_seed(0), DEVICE)
    inputs = concrete_inputs(cfg, ShapeConfig("probe", kind, seq, batch),
                             device=DEVICE)
    if kind == "train":
        tc = TrainConfig()
        args = [params, optim.init_opt_state(params, tc), inputs]
        step = build_train_step(cfg, tc)
        want = train_norm_launches(cfg, 1)
    else:
        args = [params, inputs["token"], inputs["cache"]]
        step = build_serve_step(cfg)
        want = {"decode_attention_fwd": cfg.num_layers,
                **norm_launches("qwen3-0.6b", 0, 1)}
    torch.cuda.synchronize()
    arg_alloc = torch.cuda.memory_allocated() - base
    leaves = [t for a in args for t in tree_leaves(a)]
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves)
    if arg_bytes != c.argument_bytes or not (
            0 <= arg_alloc - arg_bytes <= _allocator_slack(leaves)):
        raise AssertionError(
            f"phase 28 {kind}: the probe's argument bytes "
            f"{c.argument_bytes}, the inputs' {arg_bytes}, allocated "
            f"{arg_alloc} (at most {_allocator_slack(leaves)} more)")
    fns = launchers()
    for f in fns.values():
        f.launches = 0
    peaks, secs = [], []
    for i in range(MEMORY_STEP_RUNS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del out
    counts = {name: f.launches for name, f in fns.items()}
    full = {name: want.get(name, 0) * MEMORY_STEP_RUNS for name in counts}
    if counts != full:
        raise AssertionError(f"phase 28 {kind} step: launches {counts}; "
                             f"want {full}")
    del args, params, inputs
    gc.collect()
    torch.cuda.empty_cache()
    # the first run builds the kernels and warms cuBLAS: the last runs'
    peak, sec = max(peaks[1:]), min(secs[1:])
    bound = max(rl["compute_s"], rl["memory_s"])
    G = 2**30
    print(f"phase 28 memory model, qwen3-0.6b full (bf16) {kind} at "
          f"{batch} x {seq} [{card}]: probe (torch {torch.__version__}, "
          f"{probe_s:.1f}s) arguments {c.argument_bytes / G:.3f} + peak "
          f"temporaries {c.peak_temp_bytes / G:.3f} + outputs "
          f"{c.output_bytes / G:.3f} = {predicted / G:.3f} GiB; the card's "
          f"max_memory_allocated over a step {peak / G:.3f} GiB (runs "
          + ", ".join(f"{p / G:.3f}" for p in peaks)
          + f"), measured / predicted {peak / predicted:.3f}; the "
          f"inputs hold the probe's {arg_bytes} argument bytes exactly "
          f"(the allocator {arg_alloc}: {arg_alloc - arg_bytes} of "
          f"blocks' slack); step {1e3 * sec:.2f} ms (host "
          f"clock after synchronize, runs "
          + ", ".join(f"{1e3 * x:.2f}" for x in secs)
          + f") beside the probe's roofline max(compute "
          f"{1e3 * rl['compute_s']:.3f}, memory {1e3 * rl['memory_s']:.3f}"
          f") = {1e3 * bound:.3f} ms, ratio {sec / bound:.2f}; "
          f"{c.flops:.6g} FLOPs, {c.hbm_bytes:.6g} eager bytes; launches "
          f"{ {k: v for k, v in counts.items() if v} } = per step "
          f"{want} x {MEMORY_STEP_RUNS}")
    return counts


# --- phases 29 and 30: tensor parallelism, two ranks on one card ---------

#: phase 29: full-width qwen3-0.6b through ``launch/train.py --mesh 1x2``
#: by two ranks that share cuda:0 over gloo: (a) f32 at 4 of its 28
#: layers, 2 steps of 4 x 256 tokens, against the run without a mesh; (b)
#: bf16 params and fp32 moments at full depth, 6 steps of 4 x 1,024
TP_MESH = ["--mesh", "1x2"]
TP_F32_ARGV = ["--arch", "qwen3-0.6b", "--layers", "4", "--dtype",
               "float32", "--device", "cuda", "--steps", "2", "--batch",
               "4", "--seq", "256", "--seed", "0", "--ckpt-every", "1000"]
TP_BF16_ARGV = ["--arch", "qwen3-0.6b", "--device", "cuda", "--steps", "6",
                "--batch", "4", "--seq", "1024", "--seed", "0",
                "--ckpt-every", "1000"]
TP_CKPT = ROOT / "build" / "tp_ckpt"
#: phase 29 (a)'s bounds: each loss within
#: TRAIN_LOSS_ATOL of the run without a mesh, the grad norm within
#: TRAIN_GRAD_RTOL of it; every parameter whose gradient is at least
#: TP_CLEAR in both steps within TP_PARAM_ATOL, every other within 2 lr
#: per step (AdamW divides such a gradient by one near its epsilon, 1e-8,
#: so the last bits of the gradient, which another order of sums changes,
#: move it by up to a step's size)
TP_PARAM_ATOL, TP_CLEAR = 1e-4, 1e-6
#: phase 30: full-width, full-depth qwen3-0.6b served by the same two
#: ranks on a (1, 2) mesh: the sharded prefill of 8 rows x 128 tokens,
#: then 16 greedy decode steps, in f32 and in bf16
TP_SERVE_ROWS, TP_SERVE_PROMPT, TP_SERVE_STEPS = 8, 128, 16
#: phase 30's bf16 bound: each step's logits
#: on the mesh against the one-rank steps fed the same tokens, max abs
#: error over the largest |logit| of the one-rank side.  The mesh sums
#: each block's two partial products in bf16 where one rank sums the
#: whole product in fp32 before rounding: one bf16 rounding (2^-8
#: relative) more per block output, 56 of them through 28 layers,
#: compounding as a random walk to ~0.03 of the activations' scale.
TP_BF16_LOGIT_RTOL = 0.1


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _tp_rank_init(rank: int, world: int, port: int) -> None:
    """A spawned rank: ``src`` importable, torchrun's environment (every
    rank local, more ranks than cards), cuda:0, TF32 off, and the gloo
    process group (NCCL refuses two ranks on one card)."""
    import os
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)


def _spawn_tp(fn, *args, world: int = 2) -> list:
    """``fn(rank, world, port, out_dir, *args)`` in ``world`` spawned
    ranks; each rank's saved result, in rank order.  A failing rank fails
    the call (and the phase)."""
    import torch.multiprocessing as mp
    out_dir = ROOT / "build" / "tp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    mp.start_processes(fn, args=(world, _free_port(), str(out_dir), *args),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _timed_collectives_step(out, argv) -> dict:
    """One more train step from the run's final state (the next batch),
    each ``torch.distributed.all_reduce`` timed between synchronizes: the
    step's seconds, the collectives' seconds, count and bytes."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    B, S, at = (int(argv[argv.index(a) + 1])
                for a in ("--batch", "--seq", "--steps"))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in make_batch(
        out["cfg"], ShapeConfig("t", "train", S, B), DataConfig(),
        at).items()}
    orig, spent = dist.all_reduce, {"s": 0.0, "n": 0, "bytes": 0}

    def timed(t, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(t, *a, **k)
        torch.cuda.synchronize()
        spent["s"] += time.perf_counter() - t0
        spent["n"] += 1
        spent["bytes"] += t.numel() * t.element_size()
        return res
    dist.all_reduce = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["step_fn"](out["params"], out["opt"], batch)
        torch.cuda.synchronize()
        spent["step_s"] = time.perf_counter() - t0
    finally:
        dist.all_reduce = orig
    return spent


def _gloo_on_cuda(world: int) -> dict:
    """Each collective the tensor-parallel steps issue, over the gloo
    group on CUDA tensors, against its expected value: all-reduce (sum,
    max, min; f32, bf16, int32), all-gather, all-to-all (the sequence
    split's exchange of partials), and ``train/sharded.py::
    gather`` of a DTensor split over 'model' (its all-gather over the
    mesh's group).  Raises where gloo refuses one or it computes another
    value."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.train.sharded import gather
    r = dist.get_rank()
    got = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for op, want in ((dist.ReduceOp.SUM, sum(range(1, world + 1))),
                         (dist.ReduceOp.MAX, world), (dist.ReduceOp.MIN, 1)):
            t = torch.full((3,), r + 1, dtype=dt, device=DEVICE)
            dist.all_reduce(t, op=op)
            got[f"all_reduce {op} {str(dt)[6:]}"] = bool(
                torch.all(t == want))
    parts = [torch.empty(2, device=DEVICE) for _ in range(world)]
    dist.all_gather(parts, torch.full((2,), float(r), device=DEVICE))
    got["all_gather"] = all(bool(torch.all(p == i))
                            for i, p in enumerate(parts))
    # rank r sends r * world + j to rank j (the sequence split's exchange)
    recv = torch.empty(world, device=DEVICE)
    dist.all_to_all_single(recv, torch.arange(
        world, dtype=torch.float32, device=DEVICE) + r * world)
    got["all_to_all_single"] = recv.tolist() == [
        float(i * world + r) for i in range(world)]
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    d = DTensor.from_local(torch.full((2,), float(r), device=DEVICE), mesh,
                           (Replicate(), Shard(0)), run_check=False)
    full = gather(d)
    got["gather of a DTensor"] = full.is_cuda and full.tolist() == [
        float(i) for i in range(world) for _ in range(2)]
    if not all(got.values()):
        raise AssertionError(f"gloo on CUDA tensors: {got}")
    return got


def _tp_train_rank(rank, world, port, out_dir, f32_argv, bf16_argv):
    """A rank of phase 29: ``train.main`` of ``f32_argv`` (rank 0 saves
    the final params gathered whole) and of ``bf16_argv``, each with its
    launch counts; the compute tensors of the bf16 state taken under a
    collective counter; one more step with its collectives timed."""
    import torch.distributed as dist
    _tp_rank_init(rank, world, port)
    from repro_torch.train.sharded import gather_state
    from repro_torch.utils.step_analyzer import CollectiveCounter
    from repro_torch.utils.tree import tree_map
    res = {}
    try:
        res["gloo"] = _gloo_on_cuda(world)
        out, counts = train_counted(f32_argv)
        res["f32"] = {"losses": out["losses"],
                      "grad_norms": out["grad_norms"], "counts": counts}
        full = gather_state(out["params"])
        if rank == 0:
            torch.save(tree_map(lambda t: t.cpu(), full),
                       Path(out_dir) / "f32_params.pt")
        del out, full
        out, counts = train_counted(bf16_argv)
        with CollectiveCounter() as c:
            compute = out["step_fn"].compute_leaves(out["params"])
        del compute
        res["bf16"] = {"losses": out["losses"], "step_s": out["step_s"],
                       "peak_bytes": out["peak_bytes"], "counts": counts,
                       "tokens": out["tokens_per_step"],
                       "layers": out["cfg"].num_layers,
                       "tp_leaves": out["step_fn"].tp_leaves,
                       "gathers": dict(c.counts),
                       "timed": _timed_collectives_step(out, bf16_argv)}
        del out
    finally:
        dist.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def _tp_grad_masks(cfg, tc, argv, steps: int):
    """The run without a mesh stepped by hand: for each leaf, whether its
    gradient is at least TP_CLEAR in every step (the phase's strict
    elements)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as model_lib
    from repro_torch.train import optim
    from repro_torch.train.step import (build_loss_fn, build_train_step,
                                        value_and_grad)
    from repro_torch.utils.tree import tree_map
    B, S = (int(argv[argv.index(a) + 1]) for a in ("--batch", "--seq"))
    p = model_lib.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                       DEVICE)
    o = optim.init_opt_state(p, tc)
    step, loss_fn, masks = build_train_step(cfg, tc), build_loss_fn(cfg), None
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(DEVICE) for k, v in make_batch(
            cfg, ShapeConfig("t", "train", S, B), DataConfig(), i).items()}
        g = value_and_grad(loss_fn, p, b)[1]
        clear = tree_map(lambda t: t.abs() >= TP_CLEAR, g)
        masks = clear if masks is None else tree_map(
            torch.logical_and, masks, clear)
        del g
        p, o, _ = step(p, o, b)
    return masks


def phase_tp_train() -> dict:
    """Two ranks that share cuda:0 train full-width qwen3-0.6b through
    ``launch/train.py --mesh 1x2`` (``_tp_train_rank``): (a) in f32 at 4
    layers, held to the run without a mesh by the bounds above; (b) in
    bf16 at full depth, where the loss must fall (mean of the last 3
    steps below the first 3), each rank launch exactly each RMSNorm
    kernel's count and no attention or SSD kernel, and taking the
    compute tensors gather nothing (every leaf is split or replicated on
    (1, 2)).  Prints each rank's step time, peak memory and the timed
    step's collectives, beside the card's name and power limit.  Returns
    the bf16 runs' launch counts summed over the ranks."""
    from repro_torch.utils.tree import flatten_with_paths
    card = card_line()
    shutil.rmtree(TP_CKPT, ignore_errors=True)
    ck = ["--ckpt-dir", str(TP_CKPT)]
    t0 = time.perf_counter()
    ranks = _spawn_tp(_tp_train_rank, TP_F32_ARGV + TP_MESH + ck,
                      TP_BF16_ARGV + TP_MESH + ck)
    t_ranks = time.perf_counter() - t0
    got = torch.load(ROOT / "build" / "tp" / "f32_params.pt",
                     weights_only=False)
    ref, ref_counts = train_counted(TP_F32_ARGV + ck)
    cfg, tc, steps = ref["cfg"], ref["tc"], len(ref["losses"])
    check_train_run("phase 29 (a) without a mesh", ref, ref_counts, cfg,
                    steps)
    for r in ranks:
        check_train_run("phase 29 (a) on the mesh", r["f32"],
                        r["f32"]["counts"], cfg, steps)
        if r["f32"]["losses"] != ranks[0]["f32"]["losses"]:
            raise AssertionError("phase 29 (a): the ranks' losses differ")
    loss_d = max(abs(a - b) for a, b in zip(ranks[0]["f32"]["losses"],
                                            ref["losses"]))
    gn_d = max(abs(a - b) / b for a, b in zip(ranks[0]["f32"]["grad_norms"],
                                              ref["grad_norms"]))
    if not (loss_d <= TRAIN_LOSS_ATOL and gn_d <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"phase 29 (a): losses {ranks[0]['f32']} on "
                             f"the mesh, {ref['losses']} without")
    masks = dict(flatten_with_paths(_tp_grad_masks(cfg, tc, TP_F32_ARGV,
                                                   steps)))
    strict = loose = 0.0
    n_strict = n_all = 0
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(ref["params"])):
        d = (a.to(DEVICE) - b).abs()
        m = masks[path]
        strict = max(strict, d[m].max().item() if m.any() else 0.0)
        loose = max(loose, d.max().item())
        n_strict += int(m.sum())
        n_all += m.numel()
    if not (strict <= TP_PARAM_ATOL
            and loose <= 2 * TRAIN_LR * steps + 1e-6):
        raise AssertionError(f"phase 29 (a): params differ by {strict:.3g} "
                             f"(clear gradients), {loose:.3g} (all)")
    del got, ref, masks
    gc.collect()
    torch.cuda.empty_cache()
    # (b): bf16 at full depth
    b_steps = int(TP_BF16_ARGV[TP_BF16_ARGV.index("--steps") + 1])
    from repro_torch.configs import get_config
    bcfg = get_config("qwen3-0.6b")
    want = train_norm_launches(bcfg, b_steps)
    lines, summed = [], {}
    for i, r in enumerate(ranks):
        b = r["bf16"]
        check_train_run(f"phase 29 (b) rank {i}", b, b["counts"], bcfg,
                        b_steps)
        first, last = np.mean(b["losses"][:3]), np.mean(b["losses"][-3:])
        if not last < first:
            raise AssertionError(f"phase 29 (b) rank {i}: the loss did not "
                                 f"fall: {b['losses']}")
        if b["gathers"]:
            raise AssertionError(f"phase 29 (b) rank {i}: taking the "
                                 f"compute tensors issued {b['gathers']}")
        med = sorted(b["step_s"][1:])[len(b["step_s"][1:]) // 2]
        t = b["timed"]
        lines.append(
            f"rank {i}: losses " + ", ".join(f"{x:.4f}" for x in
                                             b["losses"])
            + f"; median step (from step 1) {med:.3f} s, "
            f"{b['tokens'] / med:.0f} tokens/s per rank; peak "
            f"{max(b['peak_bytes']) / 2**30:.2f} GiB; a timed step "
            f"{t['step_s']:.3f} s, of it {t['n']} all-reduces "
            f"({t['bytes'] / 2**20:.1f} MiB) {t['s']:.3f} s = "
            f"{t['s'] / t['step_s']:.3f}")
        for k, v in b["counts"].items():
            summed[k] = summed.get(k, 0) + v
    local, reduced = ranks[0]["bf16"]["tp_leaves"]
    print(f"phase 29 gloo (torch {torch.__version__}) on CUDA tensors, "
          f"each checked on both ranks: " + ", ".join(ranks[0]["gloo"]))
    print(f"phase 29 (a) --mesh 1x2 f32, qwen3-0.6b full width, "
          f"{cfg.num_layers} layers, {steps} steps of 4 x 256, two gloo "
          f"ranks on one card vs the run without a mesh: loss |d| "
          f"{loss_d:.3g} (<= {TRAIN_LOSS_ATOL}), grad norm {gn_d:.3g} of it "
          f"(<= {TRAIN_GRAD_RTOL}); {n_strict} of {n_all} params with "
          f"clear gradients within {strict:.3g} (<= {TP_PARAM_ATOL}), every "
          f"param within {loose:.3g} (<= 2 lr x {steps}) [{card}]")
    print(f"phase 29 (b) --mesh 1x2 bf16, full depth ({bcfg.num_layers} "
          f"layers), {b_steps} steps of 4 x 1,024, two gloo ranks on "
          f"cuda:0, {len(local)} leaves split over 'model' "
          f"({sorted(p.rsplit('/', 1)[-1] for p in local)}), "
          f"{len(reduced)} replicated with gradients summed over it; no "
          f"parameter all-gather; norm launches per rank {want}: "
          + "; ".join(lines) + f"; ranks {t_ranks:.1f}s [{card}]")
    shutil.rmtree(TP_CKPT, ignore_errors=True)
    return summed


def _tp_prompts(cfg, rows: int, prompt: int):
    rng = np.random.default_rng(29)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (rows, prompt)).astype(np.int32)).to(DEVICE)


def _serve_cfg(dtype: str):
    from repro_torch.configs import get_config
    return get_config("qwen3-0.6b").replace(param_dtype=dtype,
                                            compute_dtype=dtype)


def _tp_serve_rank(rank, world, port, out_dir, rows, prompt, steps):
    """A rank of phase 30: for f32 and bf16, the sharded prefill of the
    prompts and ``steps`` decode steps, each greedy over the
    vocab-parallel logits, on a (1, world) mesh: the tokens of each step,
    (bf16) the logits gathered over 'model', the launch counts, the
    seconds of the prefill and of each step, and the peak memory."""
    import torch.distributed as dist
    _tp_rank_init(rank, world, port)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.sharding import serve_shardings
    from repro_torch.models import model as model_lib
    from repro_torch.models.tp import gather_last, tp_mesh_context
    from repro_torch.train.sharded import distribute
    from repro_torch.train.sharded_serve import (build_sharded_decode_step,
                                                 build_sharded_prefill_step,
                                                 greedy)
    from repro_torch.utils.tree import tree_map
    res = {}
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        for dtype in ("float32", "bfloat16"):
            cfg = _serve_cfg(dtype)
            params = model_lib.init(
                cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
            max_len = prompt + steps
            sh = serve_shardings(cfg, mesh, params, model_lib.init_cache(
                cfg, rows, max_len, abstract_only=True), rows)
            p = tree_map(distribute, params, sh["params"])
            del params
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            prefill = build_sharded_prefill_step(cfg, max_len, sh)
            decode = build_sharded_decode_step(cfg, sh)
            fns = launchers()
            for f in fns.values():
                f.launches = 0
            tokens = _tp_prompts(cfg, rows, prompt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(p, {"tokens": tokens})
            tok = greedy(logits, cfg)
            torch.cuda.synchronize()
            secs = [time.perf_counter() - t0]
            toks, lgs = [tok.to_local().cpu()], []

            def whole(lg):
                with tp_mesh_context(mesh):
                    return gather_last(lg.to_local()).cpu()
            counts = {n: f.launches for n, f in fns.items()}
            if dtype == "bfloat16":
                lgs.append(whole(logits))
            for f in fns.values():
                f.launches = 0
            for _ in range(steps):
                t0 = time.perf_counter()
                logits, cache = decode(p, cache, tok)
                tok = greedy(logits, cfg)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                toks.append(tok.to_local().cpu())
                if dtype == "bfloat16":
                    lgs.append(whole(logits))
            res[dtype] = {"tokens": toks, "logits": lgs, "secs": secs,
                          "prefill_counts": counts,
                          "decode_counts": {n: f.launches
                                            for n, f in fns.items()},
                          "peak": torch.cuda.max_memory_allocated(),
                          "kv_local": tuple(cache["k"].to_local().shape)}
            del p, cache, logits
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def phase_tp_serve() -> dict:
    """Two ranks that share cuda:0 serve full-width, full-depth
    qwen3-0.6b through the sharded prefill and decode steps
    (``_tp_serve_rank``): on each rank the flash kernel once per layer
    in the prefill and the dense decode kernel once per layer per step,
    at the rank's Hq 8 / Hkv 4 heads (phase 5 held both to their plain
    versions at those shapes, ``qwen3-tp2``), and each RMSNorm kernel its
    count; the KV cache held as the rank's 4 heads.  In f32 every
    greedy token equals the one-rank ``build_prefill_step`` /
    ``build_serve_step`` run's; in bf16 each step's logits are within
    ``TP_BF16_LOGIT_RTOL`` of the one-rank steps fed the same tokens.
    Returns the launch counts summed over the ranks and both dtypes."""
    from repro_torch.models import model as model_lib
    from repro_torch.train.step import (build_decode_step,
                                        build_prefill_step,
                                        build_serve_step)
    card = card_line()
    rows, prompt, steps = TP_SERVE_ROWS, TP_SERVE_PROMPT, TP_SERVE_STEPS
    t0 = time.perf_counter()
    ranks = _spawn_tp(_tp_serve_rank, rows, prompt, steps)
    t_ranks = time.perf_counter() - t0
    L = _serve_cfg("float32").num_layers
    want_pre = dict(norm_launches("qwen3-0.6b", 1, 0),
                    flash_attention_fwd=L)
    want_dec = dict(norm_launches("qwen3-0.6b", 0, steps),
                    decode_attention_fwd=L * steps)
    summed = {}
    for i, r in enumerate(ranks):
        for dtype, x in r.items():
            for counts, want in ((x["prefill_counts"], want_pre),
                                 (x["decode_counts"], want_dec)):
                full = {n: want.get(n, 0) for n in counts}
                if counts != full:
                    raise AssertionError(f"phase 30 rank {i} {dtype}: "
                                         f"launches {counts}; want {full}")
                for n, v in counts.items():
                    summed[n] = summed.get(n, 0) + v
            if x["kv_local"][3] != 4:
                raise AssertionError(f"phase 30: rank {i}'s cache blocks "
                                     f"{x['kv_local']}")
            for a, b in zip(x["tokens"], ranks[0][dtype]["tokens"]):
                if not torch.equal(a, b):
                    raise AssertionError(f"phase 30 {dtype}: the ranks' "
                                         f"tokens differ")
    max_len = prompt + steps
    # f32: the one-rank steps' own greedy tokens
    cfg = _serve_cfg("float32")
    params = model_lib.init(cfg, torch.Generator(device=DEVICE)
                            .manual_seed(0), DEVICE)
    logits, cache = build_prefill_step(cfg, max_len)(
        params, {"tokens": _tp_prompts(cfg, rows, prompt)})
    tok = torch.argmax(logits, -1).to(torch.int32)
    serve = build_serve_step(cfg)
    f32_same = [torch.equal(tok.cpu(), ranks[0]["float32"]["tokens"][0])]
    for _ in range(steps):
        tok, cache = serve(params, tok, cache)
        f32_same.append(torch.equal(tok.cpu(),
                                    ranks[0]["float32"]["tokens"][
                                        len(f32_same)]))
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    if not all(f32_same):
        raise AssertionError(f"phase 30 f32: greedy tokens equal the one-"
                             f"rank run's at steps {f32_same}")
    # bf16: the one-rank steps fed the mesh's tokens
    cfg = _serve_cfg("bfloat16")
    params = model_lib.init(cfg, torch.Generator(device=DEVICE)
                            .manual_seed(0), DEVICE)
    got = ranks[0]["bfloat16"]
    logits, cache = build_prefill_step(cfg, max_len)(
        params, {"tokens": _tp_prompts(cfg, rows, prompt)})
    decode = build_decode_step(cfg)
    rel, agree = [], 0
    for i in range(steps + 1):
        ref = logits.float().cpu()
        rel.append(float((got["logits"][i] - ref).abs().max()
                         / ref.abs().max()))
        agree += int((torch.argmax(ref, -1).to(torch.int32)
                      == got["tokens"][i]).sum())
        if i < steps:
            logits, cache = decode(params, cache,
                                   got["tokens"][i].to(DEVICE))
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    if not max(rel) <= TP_BF16_LOGIT_RTOL:
        raise AssertionError(f"phase 30 bf16: logits differ by {rel} of "
                             f"the largest")
    times = []
    for i, r in enumerate(ranks):
        for dtype in ("float32", "bfloat16"):
            s = r[dtype]["secs"]
            dec = sorted(s[2:])[len(s[2:]) // 2]
            times.append(f"rank {i} {dtype}: prefill {1e3 * s[0]:.1f} ms, "
                         f"decode step (median from step 2) "
                         f"{1e3 * dec:.1f} ms, peak "
                         f"{r[dtype]['peak'] / 2**30:.2f} GiB")
    print(f"phase 30 sharded serving, qwen3-0.6b full width and depth "
          f"({L} layers) on a (1, 2) mesh of two gloo ranks on one card: "
          f"prefill of {rows} x {prompt} tokens and {steps} greedy decode "
          f"steps; per rank and dtype flash {want_pre['flash_attention_fwd']}"
          f" launches, dense decode {want_dec['decode_attention_fwd']} = "
          f"{L} x {steps}, at Hq 8 / Hkv 4, KV blocks "
          f"{ranks[0]['bfloat16']['kv_local']}; f32 greedy tokens equal "
          f"the one-rank run's at all {len(f32_same)} positions; bf16 "
          f"logits vs one rank fed the same tokens, max err "
          f"{max(rel):.4f} of the largest (<= {TP_BF16_LOGIT_RTOL}), "
          f"argmax agreeing on {agree} of {rows * (steps + 1)}; "
          + "; ".join(times) + f"; ranks {t_ranks:.1f}s [{card}]")
    return summed


# --- phases 31 and 32: the sequence-split KV cache, and the dry-run ------

#: phase 31's kernel cases: the decode_32k cell's layout at M = 16 (8 rows
#: of 32,768 slots in 16 ranges of 2,048, the ranges a sequence-split
#: cache gives the 16 model ranks), as qwen3-0.6b's heads (Hq 16, Hkv 8,
#: D 128) and gemma2-27b's local layers (Hq 32, Hkv 16, window 4,096,
#: softcap 50, scale 144^-0.5): (name, (B, Hq, Hkv, D), positions,
#: window, softcap, scale).  The rows' positions leave later ranges empty
#: (and, with the window, earlier ones too).
SEQ_SLOTS, SEQ_RANGES = 32_768, 16
SEQ_POSITIONS = [32_767, 30_000, 20_001, 16_384, 9_000, 4_095, 2_048, 5]
SEQ_CASES = [
    ("qwen3-0.6b", (8, 16, 8, 128), SEQ_POSITIONS, 0, 0.0, 128 ** -0.5),
    ("gemma2-27b-local", (8, 32, 16, 128), SEQ_POSITIONS, 4096, 50.0,
     kb.GEMMA2_SCALE),
]
#: the log-sum-exp's bound, kernel vs plain: both sum fp32 exponentials
#: over at most 2,048 slots, in another order; at |lse| up to ~20 that is
#: a few fp32 ulps of it, far below this
LSE_ATOL = 1e-4
#: phase 31's ranks: full-width qwen3-0.6b at SEQ_LAYERS of its 28
#: layers on a (1, 16) mesh of 16 gloo ranks sharing cuda:0, 8 rows, a
#: cache of 16 x 16 = 256 slots (each rank holds 16 of them, every kv
#: head), a 44-token prompt (ranks 0-2's slots) and 5 decode steps
#: (positions 44-48: the last write moves from rank 2's slots into rank
#: 3's),
#: in f32 and bf16.  The depth is cut, not the width: at 28 layers a
#: decode step took 7 s, each of its 113 gloo collectives ~60 ms across
#: 16 processes on the host's 8 cores (PERF.md, PR 23)
SEQ_WORLD, SEQ_ROWS, SEQ_PROMPT, SEQ_STEPS, SEQ_SLOTS_PER_RANK = \
    16, 8, 44, 5, 16
SEQ_LAYERS = 4


def _seq_cfg(dtype: str):
    return _serve_cfg(dtype).replace(num_layers=SEQ_LAYERS)


def _qwen3_norms(layers: int, calls: int) -> dict:
    """RMSNorm launches of ``calls`` model calls of qwen3-0.6b cut to
    ``layers`` layers (NORMS_PER_CALL's at full depth)."""
    return {"rmsnorm_fwd": calls, "add_rmsnorm_fwd": 2 * layers * calls,
            "qk_norm_rope_fwd": layers * calls}


def phase_seq_split_kernel() -> None:
    """The dense decode kernel with its log-sum-exp on each rank's range
    of a sequence-split cache (SEQ_CASES, f32 and bf16): each range's o
    and lse against the plain version (TOL; LSE_ATOL), a range that
    attends nothing exactly o = 0 and lse = -inf with no NaN, and the
    ranges merged (``models/tp.py::merge_lse``, the ranks' merge) against
    the whole call of the kernel and of the plain version (TOL).  Then
    one rank's launch (qwen3, range 0, bf16 and f32) timed with and
    without the lse beside its bound and the plain version (no
    PyTorch call returns the lse)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.tp import merge_lse
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    Sl = SEQ_SLOTS // SEQ_RANGES
    lines, worst = [], {"o": 0.0, "lse": 0.0, "merged": 0.0}
    for name, (B, Hq, Hkv, D), positions, window, cap, scale in SEQ_CASES:
        opts = dict(window=window, attn_softcap=cap, scale=scale)
        pos = torch.tensor(positions, dtype=torch.int32, device=DEVICE)
        for dt in (torch.float32, torch.bfloat16):
            q = _rand(gen, (B, 1, Hq, D), dt)
            ks = [_rand(gen, (B, Sl, Hkv, D), dt) for _ in range(SEQ_RANGES)]
            vs = [_rand(gen, (B, Sl, Hkv, D), dt) for _ in range(SEQ_RANGES)]
            parts, empty = [], 0
            for r in range(SEQ_RANGES):
                o, lse = da_ops.decode_attention(
                    q, ks[r], vs[r], pos, slot_offset=r * Sl,
                    return_lse=True, **opts)
                ends = pos + 1 - r * Sl
                po, pl = decode_attention_ref(
                    q.transpose(1, 2), ks[r], vs[r],
                    torch.clamp(ends, 0, Sl), scale=scale, window=window,
                    softcap=cap, ends=ends, return_lse=True)
                torch.cuda.synchronize()
                if torch.isnan(o).any() or torch.isnan(lse).any():
                    raise AssertionError(f"phase 31 {name} {dt} range {r}: "
                                         f"NaN")
                none = lse == -torch.inf
                if not torch.equal(none, pl == -torch.inf) or not torch.all(
                        o.transpose(1, 2)[none] == 0):
                    raise AssertionError(f"phase 31 {name} {dt} range {r}: "
                                         f"an empty range is not o = 0, "
                                         f"lse = -inf")
                empty += int(none.all(-1).sum())
                worst["o"] = max(worst["o"], _check_close(
                    f"{name} range {r}", dt, o, po.transpose(1, 2), []))
                d = (lse[~none] - pl[~none]).abs().max().item() \
                    if (~none).any() else 0.0
                if not d <= LSE_ATOL:
                    raise AssertionError(f"phase 31 {name} {dt} range {r}: "
                                         f"lse differs by {d:.3g}")
                worst["lse"] = max(worst["lse"], d)
                parts.append((o, lse))
            k, v = torch.cat(ks, 1), torch.cat(vs, 1)
            whole = da_ops.decode_attention(q, k, v, pos, **opts)
            plain = decode_attention_ref(
                q.transpose(1, 2), k, v, torch.clamp(pos + 1, max=SEQ_SLOTS),
                scale=scale, window=window, softcap=cap,
                ends=pos + 1).transpose(1, 2)
            merged = merge_lse(
                torch.stack([o[:, 0] for o, _ in parts]),
                torch.stack([lse for _, lse in parts]))[:, None]
            torch.cuda.synchronize()
            for ref in (whole, plain):
                worst["merged"] = max(worst["merged"], _check_close(
                    f"{name} merged", dt, merged, ref, []))
            lines.append(f"{name} {str(dt)[6:]}: {empty} of "
                         f"{B * SEQ_RANGES} (row, range) pairs attend "
                         f"nothing")
            del ks, vs, k, v, parts
    print(f"phase 31 decode kernel with lse on 16 ranges of {Sl} of "
          f"{SEQ_SLOTS} slots vs plain: o max abs err {worst['o']:.3g} "
          f"(<= TOL), lse {worst['lse']:.3g} (<= {LSE_ATOL}), the ranges "
          f"merged vs the whole call (kernel and plain) "
          f"{worst['merged']:.3g}; " + "; ".join(lines))
    # one rank's launch of the decode_32k cell: qwen3, range 0, bf16 and
    # f32
    B, Hq, Hkv, D = SEQ_CASES[0][1]
    L = 28
    pos = torch.tensor(SEQ_POSITIONS, dtype=torch.int32, device=DEVICE)
    lens = torch.clamp(pos + 1, 0, Sl)
    live = int(lens.sum())
    iters = 10 * L
    for dt in (torch.bfloat16, torch.float32):
        qs = [_rand(gen, (B, 1, Hq, D), dt) for _ in range(L)]
        kc = [_rand(gen, (B, Sl, Hkv, D), dt) for _ in range(L)]
        vc = [_rand(gen, (B, Sl, Hkv, D), dt) for _ in range(L)]
        t_lse = timed(lambda i: da_ops.decode_attention(
            qs[i % L], kc[i % L], vc[i % L], pos, return_lse=True), iters,
            "dense_decode")
        t_no = timed(lambda i: da_ops.decode_attention(
            qs[i % L], kc[i % L], vc[i % L], pos), iters, "dense_decode")
        t_plain = timed(lambda i: decode_attention_ref(
            qs[i % L].transpose(1, 2), kc[i % L], vc[i % L], lens,
            scale=D ** -0.5, ends=pos + 1, return_lse=True), L)
        es = dt.itemsize
        nbytes = live * Hkv * D * 2 * es + 2 * B * Hq * D * es \
            + B * Hq * 4 + B * 4
        bound_ms, bound_by = bound(nbytes, 4 * Hq * D * live, dt)
        print(f"phase 31 decode kernel, one rank's launch of decode_32k at "
              f"M = 16 (qwen3 (B {B}, S {Sl}, Hq {Hq}, Hkv {Hkv}, D {D}), "
              f"{live} live slots) {str(dt)[6:]}: with lse {_us(t_lse)}, "
              f"without {_us(t_no)}, plain (with lse) {_us(t_plain)}; "
              f"bound {bound_ms * 1e3:.3f} us ({bound_by}), "
              f"{bound_ms / t_lse['ms']:.3f} of it reached with lse; no "
              f"PyTorch call returns the lse")
        del qs, kc, vc
    gc.collect()
    torch.cuda.empty_cache()


def _seq_serve_rank(rank, world, port, out_dir, rows, prompt, steps,
                    slots):
    """A rank of phase 31: for f32 and bf16, full-width qwen3-0.6b's
    (SEQ_LAYERS layers) sharded prefill and ``steps`` decode steps on a
    (1, world) mesh whose
    cache ``cache_specs`` splits over the sequence: the tokens of each
    step, (rank 0, bf16) the logits gathered over 'model', the launch
    counts, one decode step's collectives, the seconds of the prefill and
    of each step, the peak memory and the cache block it holds."""
    import torch.distributed as dist
    _tp_rank_init(rank, world, port)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.sharding import serve_shardings
    from repro_torch.models import model as model_lib
    from repro_torch.models.tp import gather_last, tp_mesh_context
    from repro_torch.train.sharded import distribute
    from repro_torch.train.sharded_serve import (build_sharded_decode_step,
                                                 build_sharded_prefill_step,
                                                 greedy, kv_layouts)
    from repro_torch.utils.step_analyzer import CollectiveCounter
    from repro_torch.utils.tree import tree_map
    res = {}
    try:
        res["gloo"] = _gloo_on_cuda(world)
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        for dtype in ("float32", "bfloat16"):
            cfg = _seq_cfg(dtype)
            params = model_lib.init(
                cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
            max_len = world * slots
            sh = serve_shardings(cfg, mesh, params, model_lib.init_cache(
                cfg, rows, max_len, abstract_only=True), rows)
            p = tree_map(distribute, params, sh["params"])
            del params
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            prefill = build_sharded_prefill_step(cfg, max_len, sh)
            decode = build_sharded_decode_step(cfg, sh)
            fns = launchers()
            for f in fns.values():
                f.launches = 0
            tokens = _tp_prompts(cfg, rows, prompt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(p, {"tokens": tokens})
            tok = greedy(logits, cfg)
            torch.cuda.synchronize()
            secs = [time.perf_counter() - t0]
            toks, lgs = [tok.to_local().cpu()], []

            def whole(lg):
                with tp_mesh_context(mesh):
                    return gather_last(lg.to_local()).cpu()
            counts = {n: f.launches for n, f in fns.items()}
            keep = dtype == "bfloat16"
            if keep:
                lgs.append(whole(logits))
            for f in fns.values():
                f.launches = 0
            for i in range(steps):
                t0 = time.perf_counter()
                with CollectiveCounter() as coll:
                    logits, cache = decode(p, cache, tok)
                tok = greedy(logits, cfg)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                toks.append(tok.to_local().cpu())
                if keep:
                    lgs.append(whole(logits))
            res[dtype] = {"tokens": toks, "logits": lgs if rank == 0 else [],
                          "secs": secs, "prefill_counts": counts,
                          "decode_counts": {n: f.launches
                                            for n, f in fns.items()},
                          "collectives": dict(coll.counts),
                          "layout": kv_layouts(sh),
                          "peak": torch.cuda.max_memory_allocated(),
                          "kv_local": tuple(cache["k"].to_local().shape)}
            del p, cache, logits
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def phase_seq_split_serve() -> dict:
    """16 ranks that share cuda:0 serve full-width qwen3-0.6b (SEQ_LAYERS
    layers) on a (1, 16) mesh (``_seq_serve_rank``): its 8 kv heads do
    not split
    over 16 model ranks, so ``cache_specs`` splits the cache over the
    sequence and each rank holds every kv head of its 16 slots.  On each
    rank the flash kernel once per layer in the prefill (the rank's q
    head and the kv head it reads) and the decode kernel with its lse
    once per layer per step; per step and layer one all-gather of the q
    heads and one all-to-all of the partials.  In f32 every greedy token
    equals the one-rank run's; in bf16 each step's logits are within
    ``TP_BF16_LOGIT_RTOL`` of the one-rank steps fed the same tokens.
    Returns the launch counts summed over the ranks and both dtypes."""
    from repro_torch.models import model as model_lib
    from repro_torch.train.step import (build_decode_step,
                                        build_prefill_step,
                                        build_serve_step)
    card = card_line()
    world, rows, prompt, steps = SEQ_WORLD, SEQ_ROWS, SEQ_PROMPT, SEQ_STEPS
    t0 = time.perf_counter()
    ranks = _spawn_tp(_seq_serve_rank, rows, prompt, steps,
                      SEQ_SLOTS_PER_RANK, world=world)
    t_ranks = time.perf_counter() - t0
    f32 = _seq_cfg("float32")
    L, Hkv, hd = f32.num_layers, f32.num_kv_heads, f32.head_dim
    want_pre = dict(_qwen3_norms(L, 1), flash_attention_fwd=L)
    want_dec = dict(_qwen3_norms(L, steps), decode_attention_fwd=L * steps)
    # per decode step: wk and wv gathered whole (the replicated kv
    # route), the q heads gathered and the partials exchanged per layer,
    # two all-reduces per layer and the vocab-parallel embedding's (the
    # greedy sampling's two come after the step)
    want_coll = {"all-gather": 2 + L, "all-to-all": L,
                 "all-reduce": 2 * L + 1}
    summed = {}
    for i, r in enumerate(ranks):
        for dtype in ("float32", "bfloat16"):
            x = r[dtype]
            for counts, want in ((x["prefill_counts"], want_pre),
                                 (x["decode_counts"], want_dec)):
                full = {n: want.get(n, 0) for n in counts}
                if counts != full:
                    raise AssertionError(f"phase 31 rank {i} {dtype}: "
                                         f"launches {counts}; want {full}")
                for n, v in counts.items():
                    summed[n] = summed.get(n, 0) + v
            if x["layout"] != {"self": "sequence"} or x["kv_local"] != (
                    L, rows, SEQ_SLOTS_PER_RANK, Hkv, hd):
                raise AssertionError(f"phase 31 rank {i}: cache "
                                     f"{x['layout']}, block {x['kv_local']}")
            if x["collectives"] != want_coll:
                raise AssertionError(f"phase 31 rank {i}: a decode step's "
                                     f"collectives {x['collectives']}; want "
                                     f"{want_coll}")
            for a, b in zip(x["tokens"], ranks[0][dtype]["tokens"]):
                if not torch.equal(a, b):
                    raise AssertionError(f"phase 31 {dtype}: the ranks' "
                                         f"tokens differ")
    max_len = world * SEQ_SLOTS_PER_RANK
    cfg = f32
    params = model_lib.init(cfg, torch.Generator(device=DEVICE)
                            .manual_seed(0), DEVICE)
    logits, cache = build_prefill_step(cfg, max_len)(
        params, {"tokens": _tp_prompts(cfg, rows, prompt)})
    tok = torch.argmax(logits, -1).to(torch.int32)
    serve = build_serve_step(cfg)
    got = ranks[0]["float32"]["tokens"]
    f32_same = [torch.equal(tok.cpu(), got[0])]
    for _ in range(steps):
        tok, cache = serve(params, tok, cache)
        f32_same.append(torch.equal(tok.cpu(), got[len(f32_same)]))
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    if not all(f32_same):
        raise AssertionError(f"phase 31 f32: greedy tokens equal the one-"
                             f"rank run's at steps {f32_same}")
    cfg = _seq_cfg("bfloat16")
    params = model_lib.init(cfg, torch.Generator(device=DEVICE)
                            .manual_seed(0), DEVICE)
    got = ranks[0]["bfloat16"]
    logits, cache = build_prefill_step(cfg, max_len)(
        params, {"tokens": _tp_prompts(cfg, rows, prompt)})
    decode = build_decode_step(cfg)
    rel, agree = [], 0
    for i in range(steps + 1):
        ref = logits.float().cpu()
        rel.append(float((got["logits"][i] - ref).abs().max()
                         / ref.abs().max()))
        agree += int((torch.argmax(ref, -1).to(torch.int32)
                      == got["tokens"][i]).sum())
        if i < steps:
            logits, cache = decode(params, cache,
                                   got["tokens"][i].to(DEVICE))
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    if not max(rel) <= TP_BF16_LOGIT_RTOL:
        raise AssertionError(f"phase 31 bf16: logits differ by {rel} of "
                             f"the largest")
    times = []
    for dtype in ("float32", "bfloat16"):
        pre = [r[dtype]["secs"][0] for r in ranks]
        dec = sorted(s for r in ranks for s in r[dtype]["secs"][2:])
        peak = max(r[dtype]["peak"] for r in ranks)
        times.append(f"{dtype}: prefill {1e3 * min(pre):.1f}-"
                     f"{1e3 * max(pre):.1f} ms, decode step median "
                     f"{1e3 * dec[len(dec) // 2]:.1f} ms (from step 2, all "
                     f"ranks), peak {peak / 2**30:.2f} GiB a rank")
    print(f"phase 31 gloo (torch {torch.__version__}) on CUDA tensors, "
          f"rank 0: " + ", ".join(ranks[0]["gloo"]))
    print(f"phase 31 sequence-split serving, qwen3-0.6b full width, {L} of "
          f"its 28 layers, on a (1, {world}) mesh of {world} gloo ranks "
          f"on one card: cache {ranks[0]['bfloat16']['layout']}, blocks "
          f"{ranks[0]['bfloat16']['kv_local']} of {max_len} slots; prefill "
          f"of {rows} x {prompt} tokens (ranks 0-2's slots) and {steps} "
          f"greedy steps (positions {prompt}-{prompt + steps - 1}); per "
          f"rank and dtype flash {want_pre['flash_attention_fwd']}, decode "
          f"with lse {want_dec['decode_attention_fwd']} launches; a decode "
          f"step's collectives {want_coll}; f32 greedy tokens equal the "
          f"one-rank run's at all {len(f32_same)} positions; bf16 logits vs "
          f"one rank fed the same tokens, max err {max(rel):.4f} of the "
          f"largest (<= {TP_BF16_LOGIT_RTOL}), argmax agreeing on {agree} "
          f"of {rows * (steps + 1)}; " + "; ".join(times)
          + f"; ranks {t_ranks:.1f}s [{card}]")
    return summed


#: phase 32: the dry-run's cells, each run through the command line
#: (``python -m repro_torch.launch.dryrun``'s ``main``) on both meshes
DRYRUN_CELLS = [("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
                ("qwen3-0.6b", "decode_32k"), ("mamba2-780m", "long_500k")]
DRYRUN_OUT = ROOT / "build" / "dryrun.json"


def phase_dryrun() -> None:
    """The dry-run's cells (DRYRUN_CELLS on 16x16 and 2x16x16, full
    width and depth) on the card machine's torch, in a process of its
    own (fake tensors and a fake process group of 256 or 512 ranks, on
    the CPU, with no card visible): every cell ``ok``, the 22 features of
    each finite; the decode cell's collectives hold one all-to-all per
    layer (the sequence split's exchange) and its KV cache per device the
    whole cache's bytes over M x D.  Prints each cell's per-device peak,
    roofline terms and dominant term."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.features import features_from_record
    DRYRUN_OUT.unlink(missing_ok=True)
    code = ("import sys\nsys.path.insert(0, sys.argv[1])\n"
            "import torch\ntorch.set_num_threads(1)\n"
            "from repro_torch.launch.dryrun import main\n"
            f"for arch, shape in {DRYRUN_CELLS!r}:\n"
            "    main(['--arch', arch, '--shape', shape, '--mesh', 'both',"
            " '--out', sys.argv[2]])\n")
    run = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "src"), str(DRYRUN_OUT)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES=""))
    if run.returncode != 0:
        raise AssertionError(f"phase 32: the dry-run failed:\n"
                             f"{run.stdout[-4000:]}")
    recs = json.loads(DRYRUN_OUT.read_text())
    lines = []
    for arch, shape in DRYRUN_CELLS:
        for mp in ("single", "multi"):
            rec = recs.get(f"{arch}|{shape}|{mp}", {})
            if not rec.get("ok"):
                raise AssertionError(f"phase 32 {arch} {shape} {mp}: "
                                     f"{rec.get('error')}")
            if not np.all(np.isfinite(features_from_record(rec))):
                raise AssertionError(f"phase 32 {arch} {shape} {mp}: "
                                     f"features not finite")
            r, m = rec["roofline"], rec["memory"]
            extra = ""
            if (arch, shape) == ("qwen3-0.6b", "decode_32k"):
                cfg, sh = get_config(arch), SHAPES[shape]
                whole = 2 * cfg.num_layers * sh.global_batch * sh.seq_len \
                    * cfg.num_kv_heads * cfg.head_dim * 2
                per = whole // rec["chips"]
                counts = rec["collectives"]["counts"]
                if m["alias_bytes"] != per or counts.get(
                        "all-to-all") != cfg.num_layers:
                    raise AssertionError(f"phase 32 decode {mp}: KV "
                                         f"{m['alias_bytes']} B per device, "
                                         f"want {per}; collectives {counts}")
                extra = (f", KV {per / 2**20:.1f} MiB per device (the whole "
                         f"cache's over {rec['chips']}), collectives "
                         f"{counts}")
            lines.append(
                f"{arch} {shape} {rec['mesh']}: peak "
                f"{m['peak_bytes'] / 2**30:.2f} GiB (args "
                f"{m['argument_bytes'] / 2**30:.2f}, temp "
                f"{m['temp_bytes'] / 2**30:.2f}), compute "
                f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
                f"collective {r['collective_s']:.4g} s, dominant "
                f"{r['dominant']}, analyzed in {rec['timing']['lower_s']} s"
                + extra)
    print(f"phase 32 dry-run on torch {torch.__version__} (CPU, fake "
          f"tensors, rank 0 of a fake group), {len(lines)} cells ok, per "
          f"device: " + "; ".join(lines))


# --- phase 33: tensor-parallel Mamba2 layers, two ranks on one card -------

#: phase 33's served runs: (arch, layers) at full width, the SSM heads
#: split over a (1, 2) mesh of two gloo ranks sharing cuda:0 (mamba2-780m
#: 4 of its 48 layers, 24 of 48 heads a rank; zamba2-2.7b 6 of its 54, one
#: shared application, 40 of 80 SSM heads and 16 of 32 attention heads a
#: rank), the sharded prefill of 8 rows (the prompt the arch's SSD_TP case
#: scans) and MAMBA_TP_STEPS greedy decode steps, in f32 and bf16
MAMBA_TP_RUNS = [("mamba2-780m", 4), ("zamba2-2.7b", 6)]
MAMBA_TP_ROWS, MAMBA_TP_STEPS = 8, 4
#: phase 33 (b): mamba2-780m (4 layers, f32) through ``launch/train.py
#: --mesh 1x2``, against the run without a mesh at phase 29's bounds
MAMBA_TP_TRAIN_ARGV = ["--arch", "mamba2-780m", "--layers", "4", "--dtype",
                       "float32", "--device", "cuda", "--steps", "2",
                       "--batch", "4", "--seq", "256", "--seed", "0",
                       "--ckpt-every", "1000"]
MAMBA_TP_CKPT = ROOT / "build" / "mamba_tp_ckpt"


def _mamba_tp_cfg(arch: str, layers: int, dtype: str):
    from repro_torch.configs import get_config
    return get_config(arch).replace(num_layers=layers, param_dtype=dtype,
                                    compute_dtype=dtype)


def _mamba_tp_prompt(arch: str) -> int:
    from repro_torch.kernels.ssd_scan.cases import SSD_CASES, SSD_TP
    return next(c[1][1] for c in SSD_CASES if c[0] == SSD_TP[arch])


def _mamba_tp_rank(rank, world, port, out_dir, runs, rows, steps,
                   train_argv):
    """A rank of phase 33: for each (arch, layers) of ``runs`` and each of
    f32 and bf16, the sharded prefill of ``rows`` prompts and ``steps``
    greedy decode steps on a (1, world) mesh: each step's tokens, (bf16)
    the logits gathered over 'model', the launch counts of the prefill
    and of the decode steps, the SSD launches' keys, the seconds of the
    prefill and of each step, the peak memory and the shapes of the
    rank's SSM and conv states; then ``train.main(train_argv)`` with its
    launch counts and the collectives of taking its compute tensors."""
    import torch.distributed as dist
    _tp_rank_init(rank, world, port)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.sharding import serve_shardings
    from repro_torch.models import model as model_lib
    from repro_torch.models.tp import gather_last, tp_mesh_context
    from repro_torch.train.sharded import distribute
    from repro_torch.train.sharded_serve import (build_sharded_decode_step,
                                                 build_sharded_prefill_step,
                                                 greedy)
    from repro_torch.utils.step_analyzer import CollectiveCounter
    from repro_torch.utils.tree import tree_map
    res = {"serve": {}}
    launch, seen = ssd_ops.ssd_scan_fwd, set()

    def recorded(xb, a, B_mat, C_mat, *, chunk, initial_state=None):
        seen.add(kb.ssd_key(xb, B_mat, chunk, initial_state))
        return launch(xb, a, B_mat, C_mat, chunk=chunk,
                      initial_state=initial_state)
    ssd_ops.ssd_scan_fwd = recorded
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        for arch, layers in runs:
            prompt = _mamba_tp_prompt(arch)
            for dtype in ("float32", "bfloat16"):
                cfg = _mamba_tp_cfg(arch, layers, dtype)
                params = model_lib.init(
                    cfg, torch.Generator(device=DEVICE).manual_seed(0),
                    DEVICE)
                max_len = prompt + steps
                sh = serve_shardings(cfg, mesh, params, model_lib.init_cache(
                    cfg, rows, max_len, abstract_only=True), rows)
                p = tree_map(distribute, params, sh["params"])
                del params
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                prefill = build_sharded_prefill_step(cfg, max_len, sh)
                decode = build_sharded_decode_step(cfg, sh)
                fns = launchers()
                for f in fns.values():
                    f.launches = 0
                seen.clear()
                tokens = _tp_prompts(cfg, rows, prompt)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = prefill(p, {"tokens": tokens})
                tok = greedy(logits, cfg)
                torch.cuda.synchronize()
                secs = [time.perf_counter() - t0]
                counts = {n: f.launches for n, f in fns.items()}
                toks, lgs = [tok.to_local().cpu()], []

                def whole(lg):
                    with tp_mesh_context(mesh):
                        return gather_last(lg.to_local()).cpu()
                if dtype == "bfloat16":
                    lgs.append(whole(logits))
                for f in fns.values():
                    f.launches = 0
                for _ in range(steps):
                    t0 = time.perf_counter()
                    logits, cache = decode(p, cache, tok)
                    tok = greedy(logits, cfg)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    toks.append(tok.to_local().cpu())
                    if dtype == "bfloat16":
                        lgs.append(whole(logits))
                res["serve"][arch, dtype] = {
                    "tokens": toks, "logits": lgs, "secs": secs,
                    "prefill_counts": counts, "ssd_keys": set(seen),
                    "decode_counts": {n: f.launches
                                      for n, f in fns.items()},
                    "peak": torch.cuda.max_memory_allocated(),
                    "ssm_local": tuple(cache["ssm"].to_local().shape),
                    "conv_local": tuple(cache["conv"].to_local().shape)}
                del p, cache, logits
                gc.collect()
                torch.cuda.empty_cache()
        out, counts = train_counted(train_argv)
        with CollectiveCounter() as c:
            compute = out["step_fn"].compute_leaves(out["params"])
        del compute
        res["train"] = {"losses": out["losses"],
                        "grad_norms": out["grad_norms"],
                        "step_s": out["step_s"],
                        "peak_bytes": out["peak_bytes"], "counts": counts,
                        "tp_leaves": out["step_fn"].tp_leaves,
                        "gathers": dict(c.counts),
                        "grads": _tp_grad_errors(out, train_argv)}
        del out
    finally:
        ssd_ops.ssd_scan_fwd = launch
        dist.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def _tp_grad_errors(out, argv) -> dict:
    """The loss gradient of a train run's final state on its mesh (the
    TP step's compute tensors under its context, the summed leaves summed
    over 'model', the split ones gathered) against the one-rank gradient
    at the same parameters, on the next batch: per leaf, the largest
    error over the leaf's largest |g|, and the elements whose sign
    differs among those with |g| > 1e-8 (AdamW's first step moves each of
    them by lr, whichever way its sign points).  A collective."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.sharded import gather, gather_state
    from repro_torch.train.step import build_loss_fn, value_and_grad
    from repro_torch.utils.tree import flatten_with_paths, tree_unflatten
    cfg, step, params = out["cfg"], out["step_fn"], out["params"]
    B, S, at = (int(argv[argv.index(a) + 1])
                for a in ("--batch", "--seq", "--steps"))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in make_batch(
        cfg, ShapeConfig("t", "train", S, B), DataConfig(), at).items()}
    loss_fn = build_loss_fn(cfg)
    whole = gather_state(params)
    one = value_and_grad(loss_fn, whole, batch)[1]
    del whole
    with step.context():
        mesh_g = value_and_grad(loss_fn, tree_unflatten(
            params, step.compute_leaves(params)), batch)[1]
    local, summed = step.tp_leaves
    errs = {}
    for (path, a), (_, g), (_, p) in zip(flatten_with_paths(one),
                                         flatten_with_paths(mesh_g),
                                         flatten_with_paths(params)):
        if path in summed:
            dist.all_reduce(g)
        if path in local:
            g = gather(DTensor.from_local(g, p.device_mesh, p.placements,
                                          run_check=False))
        live = a.abs() > 1e-8
        errs[path] = (float((a - g).abs().max() / a.abs().max()),
                      int(((torch.sign(a) != torch.sign(g)) & live).sum()),
                      int(live.sum()))
    return errs


def _split_gate(counts: dict) -> dict:
    """Launch counts of a path whose Mamba2 layers split by heads: each
    gated norm forward is ``gated_rmsnorm_sumsq`` and ``_scale``, each
    backward ``gated_rmsnorm_dot`` and ``_scale_bwd``."""
    out = dict(counts)
    for whole, parts in (("gated_rmsnorm_fwd", ("gated_rmsnorm_sumsq",
                                                "gated_rmsnorm_scale")),
                         ("gated_rmsnorm_bwd", ("gated_rmsnorm_dot",
                                                "gated_rmsnorm_scale_bwd"))):
        n = out.pop(whole, 0)
        if n:
            out.update({k: n for k in parts})
    return out


def phase_mamba_tp() -> dict:
    """Two ranks that share cuda:0 compute the Mamba2 layers by heads
    (``_mamba_tp_rank``).  (a) Serving: on each rank the SSD kernel once
    per Mamba2 layer per prefill at the rank's heads (the arch's SSD_TP
    case, which phase 8 held to its plain version), the split gated norm
    (sumsq and scale) once per Mamba2 layer per call, zamba2's flash and
    dense decode kernels once per call at its shared attention's 16
    heads, each other norm its count and nothing else; each rank holds
    its heads of the SSM state; f32 greedy tokens equal the one-rank
    ``build_prefill_step`` / ``build_serve_step`` run's, bf16 logits
    within ``TP_BF16_LOGIT_RTOL`` of the one-rank steps fed the same
    tokens.  (b) mamba2-780m trained through ``launch/train.py --mesh
    1x2`` in f32: losses within ``TRAIN_LOSS_ATOL`` and grad norms within
    ``TRAIN_GRAD_RTOL`` of the run without a mesh, and at its final
    state every leaf's gradient on the mesh within ``TRAIN_GRAD_RTOL`` of
    its largest value of one rank's (``_tp_grad_errors``); each rank's
    norm launches exact (the gated norm split), taking the compute
    tensors gathers only ``in_proj``, ``conv_w`` and ``conv_b``.  Prints
    each
    rank's times and peaks beside the card's name and power limit;
    returns the launch counts summed over the ranks and runs."""
    from repro_torch.kernels.ssd_scan.cases import (SSD_CASES, SSD_TP,
                                                    ssd_case_on)
    from repro_torch.models import model as model_lib
    from repro_torch.models.ssm import mamba2_dims
    from repro_torch.train.step import (build_decode_step,
                                        build_prefill_step,
                                        build_serve_step)
    card = card_line()
    shutil.rmtree(MAMBA_TP_CKPT, ignore_errors=True)
    ck = ["--ckpt-dir", str(MAMBA_TP_CKPT)]
    rows, steps = MAMBA_TP_ROWS, MAMBA_TP_STEPS
    t0 = time.perf_counter()
    ranks = _spawn_tp(_mamba_tp_rank, MAMBA_TP_RUNS, rows, steps,
                      MAMBA_TP_TRAIN_ARGV + TP_MESH + ck)
    t_ranks = time.perf_counter() - t0
    cases = {c[0]: c[1] for c in SSD_CASES}
    summed, lines = {}, []
    for arch, layers in MAMBA_TP_RUNS:
        cfg = _mamba_tp_cfg(arch, layers, "float32")
        apps = layers // cfg.attn_every if cfg.family == "hybrid" else 0
        per_call = _split_gate({
            "rmsnorm_fwd": 1, "add_rmsnorm_fwd": 2 * apps + layers,
            "qk_norm_rope_fwd": apps, "gated_rmsnorm_fwd": layers})
        want_pre = {k: v for k, v in dict(
            per_call, ssd_scan_fwd=layers,
            flash_attention_fwd=apps).items() if v}
        want_dec = {k: v * steps for k, v in dict(
            per_call, decode_attention_fwd=apps).items() if v}
        B, S, H, P, G, N, chunk = cases[SSD_TP[arch]]
        xb, _, Bm, _, _ = ssd_case_on(DEVICE, torch.bfloat16, B, S, H, P, G,
                                      N)
        key = kb.ssd_key(xb, Bm, chunk, None)
        dm = mamba2_dims(cfg)
        for i, r in enumerate(ranks):
            for dtype in ("float32", "bfloat16"):
                x = r["serve"][arch, dtype]
                for got, want in ((x["prefill_counts"], want_pre),
                                  (x["decode_counts"], want_dec)):
                    full = {n: want.get(n, 0) for n in got}
                    if got != full:
                        raise AssertionError(
                            f"phase 33 {arch} rank {i} {dtype}: launches "
                            f"{got}; want {full}")
                    for n, v in got.items():
                        summed[n] = summed.get(n, 0) + v
                if x["ssd_keys"] != {key}:
                    raise AssertionError(f"phase 33 {arch}: SSD launches at "
                                         f"{x['ssd_keys']}; want {key}")
                want_ssm = (layers, rows, dm["H"] // 2, dm["P"], dm["N"])
                if x["ssm_local"] != want_ssm:
                    raise AssertionError(f"phase 33 {arch}: rank {i}'s SSM "
                                         f"state {x['ssm_local']}")
                for a, b in zip(x["tokens"],
                                ranks[0]["serve"][arch, dtype]["tokens"]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"phase 33 {arch} {dtype}: the "
                                             f"ranks' tokens differ")
        prompt = _mamba_tp_prompt(arch)
        max_len = prompt + steps
        # f32: the one-rank steps' own greedy tokens
        params = model_lib.init(cfg, torch.Generator(device=DEVICE)
                                .manual_seed(0), DEVICE)
        logits, cache = build_prefill_step(cfg, max_len)(
            params, {"tokens": _tp_prompts(cfg, rows, prompt)})
        tok = torch.argmax(logits, -1).to(torch.int32)
        serve = build_serve_step(cfg)
        got = ranks[0]["serve"][arch, "float32"]["tokens"]
        same = [torch.equal(tok.cpu(), got[0])]
        for i in range(steps):
            tok, cache = serve(params, tok, cache)
            same.append(torch.equal(tok.cpu(), got[i + 1]))
        del params, cache, logits
        if not all(same):
            raise AssertionError(f"phase 33 {arch} f32: greedy tokens equal "
                                 f"the one-rank run's at steps {same}")
        # bf16: the one-rank steps fed the mesh's tokens
        bcfg = _mamba_tp_cfg(arch, layers, "bfloat16")
        params = model_lib.init(bcfg, torch.Generator(device=DEVICE)
                                .manual_seed(0), DEVICE)
        mine = ranks[0]["serve"][arch, "bfloat16"]
        logits, cache = build_prefill_step(bcfg, max_len)(
            params, {"tokens": _tp_prompts(bcfg, rows, prompt)})
        dec = build_decode_step(bcfg)
        rel = []
        for i in range(steps + 1):
            ref = logits.float().cpu()
            rel.append(float((mine["logits"][i] - ref).abs().max()
                             / ref.abs().max()))
            if i < steps:
                logits, cache = dec(params, cache,
                                    mine["tokens"][i].to(DEVICE))
        del params, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
        if not max(rel) <= TP_BF16_LOGIT_RTOL:
            raise AssertionError(f"phase 33 {arch} bf16: logits differ by "
                                 f"{rel} of the largest")
        times = []
        for i, r in enumerate(ranks):
            for dtype in ("float32", "bfloat16"):
                sc = r["serve"][arch, dtype]["secs"]
                short = {"float32": "f32", "bfloat16": "bf16"}[dtype]
                times.append(
                    f"rank {i} {short}: prefill {1e3 * sc[0]:.1f} ms, "
                    f"decode step (median) "
                    f"{1e3 * sorted(sc[1:])[len(sc[1:]) // 2]:.1f} ms, peak "
                    f"{r['serve'][arch, dtype]['peak'] / 2**30:.2f} GiB")
        lines.append(
            f"{arch} ({layers} layers, full width; {dm['H'] // 2} of "
            f"{dm['H']} SSM heads a rank"
            + (f", {cfg.num_heads // 2} of {cfg.num_heads} attention heads"
               if apps else "")
            + f"): prefill of {rows} x {prompt} tokens and {steps} decode "
            f"steps; per rank and dtype ssd {layers} at {SSD_TP[arch]}, "
            f"split gated norm {layers} sumsq + {layers} scale per call"
            + (f", flash {apps} and dense decode {apps} per call"
               if apps else "")
            + f", SSM state {ranks[0]['serve'][arch, 'float32']['ssm_local']}"
            f" a rank; f32 tokens equal at {len(same)} positions; bf16 "
            f"logits {max(rel):.4f} of the largest (<= "
            f"{TP_BF16_LOGIT_RTOL}); " + "; ".join(times))
    # (b): the train CLI on the mesh against the run without a mesh
    ref, ref_counts = train_counted(MAMBA_TP_TRAIN_ARGV + ck)
    tcfg, tsteps = ref["cfg"], len(ref["losses"])
    check_train_run("phase 33 (b) without a mesh", ref, ref_counts, tcfg,
                    tsteps)
    want = _split_gate(train_norm_launches(tcfg, tsteps))
    tlines = []
    for i, r in enumerate(ranks):
        t = r["train"]
        full = {n: want.get(n, 0) for n in t["counts"]}
        if t["counts"] != full:
            raise AssertionError(f"phase 33 (b) rank {i}: launches "
                                 f"{t['counts']}; want {full}")
        for n, v in t["counts"].items():
            summed[n] = summed.get(n, 0) + v
        if t["gathers"] != {"all-gather": 3}:
            raise AssertionError(f"phase 33 (b) rank {i}: taking the compute "
                                 f"tensors issued {t['gathers']} (want the "
                                 f"3 packed leaves)")
        if t["losses"] != ranks[0]["train"]["losses"]:
            raise AssertionError("phase 33 (b): the ranks' losses differ")
        tlines.append(f"rank {i}: step {1e3 * t['step_s'][-1]:.0f} ms, peak "
                      f"{max(t['peak_bytes']) / 2**30:.2f} GiB")
    got = ranks[0]["train"]
    # every leaf's gradient at the run's final state against one rank's
    worst = max(got["grads"].items(), key=lambda kv: kv[1][0])
    flips = sum(f for _, f, _ in got["grads"].values())
    live = sum(n for _, _, n in got["grads"].values())
    if worst[1][0] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"phase 33 (b): gradients on the mesh vs one "
                             f"rank: {got['grads']}")
    loss_d = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
    gn_d = max(abs(a - b) / b for a, b in zip(got["grad_norms"],
                                              ref["grad_norms"]))
    if not (loss_d <= TRAIN_LOSS_ATOL and gn_d <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"phase 33 (b): losses {got['losses']} on the "
                             f"mesh, {ref['losses']} without")
    local, reduced = got["tp_leaves"]
    del ref
    shutil.rmtree(MAMBA_TP_CKPT, ignore_errors=True)
    print(f"phase 33 (a) tensor-parallel Mamba2 serving on a (1, 2) mesh of "
          f"two gloo ranks on one card: " + " | ".join(lines)
          + f"; ranks {t_ranks:.1f}s [{card}]")
    print(f"phase 33 (b) --mesh 1x2 f32, mamba2-780m full width, "
          f"{tcfg.num_layers} layers, {tsteps} steps of 4 x 256 vs the run "
          f"without a mesh: loss |d| {loss_d:.3g} (<= {TRAIN_LOSS_ATOL}), "
          f"grad norm {gn_d:.3g} of it (<= {TRAIN_GRAD_RTOL}); every "
          f"leaf's gradient at the final state vs one rank's within "
          f"{worst[1][0]:.3g} of its largest (<= {TRAIN_GRAD_RTOL}; "
          f"{worst[0]}), {flips} of {live} elements above 1e-8 with "
          f"another sign; "
          f"{len(local)} leaves split over 'model' "
          f"({sorted(p.rsplit('/', 1)[-1] for p in local)}), "
          f"{sorted(p.rsplit('/', 1)[-1] for p in reduced)} gathered with "
          f"gradients summed; norm launches per rank {want}; "
          + "; ".join(tlines) + f" [{card}]")
    return summed


# --- phase 34: the tools -----------------------------------------------------

#: phase 34's quickstart runs (gitignored): the uninterrupted run, and the
#: run resumed from its step-10 checkpoint
TOOLS_DIR = ROOT / "build" / "tools"
QUICKSTART_STEPS, QUICKSTART_RESUME_AT = 20, 10
#: the kernels the shakeouts must launch: every kernel of the prefill and
#: decode calls of the smoke archs (the paged kernel serves no call of
#: theirs)
SHAKEOUT_KERNELS = ("flash_attention_fwd", "decode_attention_fwd",
                    "ssd_scan_fwd", "rmsnorm_fwd", "add_rmsnorm_fwd",
                    "qk_norm_rope_fwd", "gated_rmsnorm_fwd")


def phase_tools() -> dict:
    """The port's tools (``repro_torch.tools``), each through its entry
    point on the card: ``shakeout_models`` over every arch and
    ``shakeout_decode`` over its six (each ``OK``; together they launch
    every kernel of SHAKEOUT_KERNELS); ``quickstart`` for 20 steps with a
    checkpoint every 10 (the loss falls), then again resumed from that
    run's step-10 checkpoint (its last 10 losses and its final
    parameters and moments equal the uninterrupted run's bit for bit);
    ``serving_demo`` (12 of 12 requests complete); ``roofline`` and
    ``colocation`` over phase 32's records (every cell's fraction finite,
    both of the co-location scenario's binding-axis assertions hold).
    Returns the kernels' launches over the whole phase."""
    from repro_torch.checkpoint.checkpoint import restore, save
    from repro_torch.configs import ARCH_IDS
    from repro_torch.tools import (colocation, quickstart, roofline,
                                   serving_demo, shakeout_decode,
                                   shakeout_models)
    from repro_torch.utils.tree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    fns = launchers()
    for f in fns.values():
        f.launches = 0
    lines, t0 = [], time.perf_counter()
    for tool in (shakeout_models, shakeout_decode):
        failed = tool.main(["--device", DEVICE])
        if failed:
            raise AssertionError(f"phase 34 {tool.__name__}: {failed}")
    shake = {name: fns[name].launches for name in SHAKEOUT_KERNELS}
    if not all(shake.values()):
        raise AssertionError(f"phase 34 shakeouts: launches {shake}")
    lines.append(f"shakeouts of {len(ARCH_IDS)} + "
                 f"{len(shakeout_decode.ARCHS)} archs OK in "
                 f"{time.perf_counter() - t0:.1f}s, launches {shake}")

    t0 = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    whole, resumed = TOOLS_DIR / "quickstart", TOOLS_DIR / "resumed"
    args = ["--steps", str(QUICKSTART_STEPS), "--ckpt-every",
            str(QUICKSTART_RESUME_AT), "--device", DEVICE, "--ckpt-dir"]
    full = quickstart.main(args + [str(whole)])
    losses = full["losses"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"phase 34 quickstart: the loss did not fall: "
                             f"{losses}")
    state = {"params": full["params"], "m": full["opt"].m,
             "v": full["opt"].v, "count": full["opt"].count}
    tree, _ = restore(str(whole), state, step=QUICKSTART_RESUME_AT)
    save(str(resumed), QUICKSTART_RESUME_AT, tree)
    del tree
    again = quickstart.main(args + [str(resumed), "--resume"])
    bad = sum(int((a != b).sum()) for a, b in zip(
        tree_leaves(state), tree_leaves(
            {"params": again["params"], "m": again["opt"].m,
             "v": again["opt"].v, "count": again["opt"].count})))
    if (again["start"] != QUICKSTART_RESUME_AT or bad
            or again["losses"] != losses[QUICKSTART_RESUME_AT:]):
        raise AssertionError(f"phase 34 quickstart resumed at "
                             f"{again['start']}: {bad} elements differ; "
                             f"losses {again['losses']} vs "
                             f"{losses[QUICKSTART_RESUME_AT:]}")
    n_params = sum(t.numel() for t in tree_leaves(full["params"]))
    lines.append(f"quickstart {n_params / 1e6:.1f}M params, "
                 f"{QUICKSTART_STEPS} steps of 8 x 256: loss "
                 f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
                 f"{first:.4f}, last 5 {last:.4f}); resumed from step "
                 f"{QUICKSTART_RESUME_AT}: the last "
                 f"{QUICKSTART_STEPS - QUICKSTART_RESUME_AT} losses and the "
                 f"params and moments bit for bit the same; "
                 f"{time.perf_counter() - t0:.1f}s")
    del full, again, state
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    served = serving_demo.main(["--device", DEVICE])
    summary = served["summary"]
    if summary["completed"] != 12:
        raise AssertionError(f"phase 34 serving_demo: {summary}")
    lines.append(f"serving_demo {summary['completed']}/12 requests, "
                 f"{summary['steps']} steps, {served['joins']} join points, "
                 f"{summary['preemptions']} preemptions; "
                 f"{time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    rf = roofline.main(["--dryrun", str(DRYRUN_OUT)])
    cells = {k: v for k, v in rf.items() if k != "summary"}
    fracs = [v["roofline_fraction"] for v in cells.values()]
    if len(cells) != 2 * len(DRYRUN_CELLS) or not np.all(np.isfinite(fracs)):
        raise AssertionError(f"phase 34 roofline: {rf}")
    co = colocation.main(["--dryrun", str(DRYRUN_OUT)])
    lines.append(f"roofline over phase 32's {len(cells)} cells: fractions "
                 f"{min(fracs):.4g} to {max(fracs):.4g} (median "
                 f"{rf['summary']['median_fraction']:.4g}, dominant "
                 f"{rf['summary']['dominant_histogram']}); colocation STP "
                 f"ours {co['ours']['stp']:.3f}, oracle "
                 f"{co['oracle']['stp']:.3f}, pairwise "
                 f"{co['pairwise']['stp']:.3f}, multi-axis binding "
                 f"{co['multiaxis']['ours']['binding_axes']}, net-axis "
                 f"{co['netaxis']['ours']['binding_axes']}; "
                 f"{time.perf_counter() - t0:.1f}s")
    counts = {name: f.launches for name, f in fns.items()}
    print(f"phase 34 tools: " + "; ".join(lines)
          + f"; launches {({k: v for k, v in counts.items() if v})} "
          f"[{card_line()}]")
    return counts


# --- phase 35 ----------------------------------------------------------------

def phase_paged_prefill_vs_plain() -> dict:
    """The paged-prefill kernel against its plain version on every case
    of ``kernels/paged_prefill/cases.py`` (f32 2e-5, bf16 2e-2; a row
    that is not prefilling exactly zero; ``start`` a strided view, as the
    model passes it), NaN planted in every slot no row attends changing
    nothing at the chat cell's call, then timed at every launch of the
    cases' ``TIMED`` (``kernel_bench.time_paged_prefill_launches``)."""
    from repro_torch.kernels.paged_prefill import ops as pp_ops
    from repro_torch.kernels.paged_prefill.cases import (CARD_CASES,
                                                         live_mask,
                                                         prefill_case)
    from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref
    errs, worst = [], 0.0
    for seed, (name, shape, cap) in enumerate(CARD_CASES):
        arrs = prefill_case(*shape, seed=seed)
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp = (torch.from_numpy(a).to(DEVICE, dtype)
                         for a in (arrs[0], arrs[1][0], arrs[2][0]))
            table, st, ln = (torch.from_numpy(a).to(DEVICE)
                             for a in arrs[3:])
            C = q.shape[1]
            pos = st[:, None] + torch.arange(C, dtype=torch.int32,
                                             device=DEVICE)[None, :]
            out = pp_ops.paged_prefill(q, kp, vp, table, pos[:, 0], ln,
                                       attn_softcap=cap)
            ref = paged_prefill_ref(q, kp, vp, table, st, ln,
                                    scale=shape[4] ** -0.5, softcap=cap)
            torch.cuda.synchronize()
            live = ln >= 1
            if not torch.all(out[~live] == 0):
                raise AssertionError(f"{name}: a row that is not "
                                     f"prefilling is not zero")
            a, b = out[live].float(), ref[live].float()
            err = (a - b).abs().max().item()
            tol = TOL[dtype]
            if not torch.allclose(a, b, atol=tol, rtol=tol):
                raise AssertionError(f"{name} {dtype}: kernel vs plain "
                                     f"max abs err {err:.3g} > {tol}")
            worst = max(worst, err)
            errs.append(f"{name}/{str(dtype)[6:]}={err:.2g}")
            if name == "chat-call":
                mask = torch.from_numpy(live_mask(
                    arrs[3], arrs[5], kp.shape[1], kp.shape[0])).to(DEVICE)
                kp[~mask] = float("nan")
                vp[~mask] = float("nan")
                dirty = pp_ops.paged_prefill(q, kp, vp, table, st, ln)
                if not torch.equal(dirty, out):
                    raise AssertionError(f"{name} {dtype}: NaN in slots no "
                                         f"row attends changed the output")
    print(f"phase 35 paged prefill vs plain: {len(errs)} cases ok, max abs "
          f"err {worst:.3g}, NaN past the lengths inert [{' '.join(errs)}]")
    row = kb.time_paged_prefill_launches("phase 35")[0]
    return dict(max_abs_err=worst, **_json(row))


#: what each kernel replaces: its source in the port and the TPU kernel
KERNELS = {
    "paged_attention_fwd": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:81"),
    # the JAX package's chunk path is plain XLA (the page gather and the
    # masked softmax): no Pallas kernel
    "paged_prefill_fwd": (
        "src/repro_torch/kernels/paged_prefill/csrc/paged_prefill.cu",
        "src/repro/models/model.py:632"),
    "flash_attention_fwd": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:90"),
    "decode_attention_fwd": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:76"),
    "ssd_scan_fwd": (
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:69"),
    **{name: ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm/kernel.py:22")
       for name in NORM_JSON},
    # the backward of the RMSNorm kernel: the JAX package has no Pallas
    # backward and trains through the plain norm under jax.grad
    **{name: ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm/kernel.py:22")
       for name in ("rmsnorm_bwd", "add_rmsnorm_bwd", "gated_rmsnorm_bwd",
                    "qk_norm_rope_bwd")},
    # the gated norm split over ranks by columns (Mamba2 under tensor
    # parallelism), forward and backward
    **{name: ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm/kernel.py:22")
       for name in ("gated_rmsnorm_sumsq", "gated_rmsnorm_scale",
                    "gated_rmsnorm_dot", "gated_rmsnorm_scale_bwd")},
}


def main() -> None:
    t_start = time.perf_counter()
    t_last = [t_start]

    def done(n) -> None:
        now = time.perf_counter()
        print(f"phase {n} seconds: {now - t_last[0]:.1f}")
        t_last[0] = now

    card = phase_device_and_build()
    done(1)
    timing = {"paged_attention_fwd": phase_kernel_vs_plain()}
    done(2)
    paths = [phase_paged_path(3, "qwen3-0.6b", MAIN_ARGV, 28)]
    done(3)
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    f32 = get_config("qwen3-0.6b").replace(param_dtype="float32",
                                           compute_dtype="float32")
    # the same random f32 weights for phases 4 and 7, kept on the CPU (a
    # copy goes to the card for each parity phase only)
    p_cpu = model_lib.init(f32, torch.Generator().manual_seed(0), "cpu")
    phase_parity(f32, p_cpu)
    done(4)
    timing.update(phase_dense_kernels_vs_plain())
    done(5)
    paths.append(phase_dense_path(6, "qwen3-0.6b",
                                  MAIN_ARGV + ["--backend", "dense"], 28)[0])
    done(6)
    phase_dense_parity(f32, p_cpu)
    del p_cpu
    done(7)
    ssd_timing, ssd_keys = phase_ssd_kernel_vs_plain()
    # the JSON line carries the SSM path's (mamba2-780m) launch
    timing["ssd_scan_fwd"] = ssd_timing["mamba2-main"]
    done(8)
    for n, arch, *path in SSM_PATHS:
        paths.append(phase_ssm_path(n, arch, *path, ssd_keys[arch]))
        done(n)
    phase_ssm_parity()
    done(11)
    timing.update(phase_rmsnorm_kernel_vs_plain())
    timing.update(phase_split_norm_vs_plain())
    done(12)
    paths.append(phase_paged_path(13, MOE, MOE_ARGV, 48))
    done(13)
    paths.append(phase_dense_path(14, MOE, MOE_ARGV + ["--backend", "dense"],
                                  48)[0])
    done(14)
    phase_moe_parity()
    done(15)
    timing.update(phase_rmsnorm_bwd_vs_plain())
    done(16)
    paths.extend(phase_train_path())
    done(17)
    phase_train_parity()
    done(18)
    for n, arch, extra, layers in FAMILY_PATHS:
        paths.append(phase_family_path(n, arch, extra, layers))
        done(n)
        if arch == GEMMA2:
            paths.append(phase_gemma2_long())
            done(20)
    phase_family_parity()
    done(23)
    paths.extend(phase_family_train())
    done(24)
    phase_train_parity(25, FAMILY_TRAIN_PARITY, init_device=DEVICE)
    done(25)
    phase_scaleout_ranks()
    done(26)
    paths.append(phase_ep_train())
    done(27)
    paths.extend(phase_feature_probe())
    done(28)
    paths.append(phase_tp_train())
    done(29)
    paths.append(phase_tp_serve())
    done(30)
    phase_seq_split_kernel()
    paths.append(phase_seq_split_serve())
    done(31)
    phase_dryrun()
    done(32)
    paths.append(phase_mamba_tp())
    done(33)
    paths.append(phase_tools())
    done(34)
    timing["paged_prefill_fwd"] = phase_paged_prefill_vs_plain()
    done(35)
    # launches on the main paths: each path's own run, summed over the
    # paths (phases 3, 6, 9, 10, 13, 14, 19 to 22, the training paths,
    # 17, 24 and 27's mesh run, 28's real steps, 29's bf16 and 30's runs
    # on both ranks, 31's on all 16, 33's on both ranks, and 34's tools)
    launches = {name: sum(counts[name] for counts in paths)
                for name in KERNELS}
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **timing[name])
               for name, (src, rep) in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def kernel_times(src: str) -> None:
    """``--kernel-times [SRC]``: build the kernels and time the paged
    kernel at both paged paths' launches (phase 2's timing), the
    paged-prefill kernel at both chunk calls (phase 35's; none where SRC
    lacks it), both dense
    attention kernels at every served launch shape (phase 5's), the SSD
    kernel at both SSM paths' launches (phase 8's), the RMSNorm kernels
    and unfused sequences at the paths' shapes (phase 12's) and the
    backward kernels at the train step's launches (phase 16's), taking the
    ``repro_torch`` package from the ``src`` directory SRC of another
    checkout (default: this one), so that two versions are timed on one
    card in one call: ``kernel_bench.time_all`` of this tree over SRC's
    kernels; prints no JSON."""
    if src:
        sys.path.insert(0, str(Path(src).resolve()))
    card = phase_device_and_build()
    import repro_torch
    print(f"kernel times of {Path(repro_torch.__file__).parent}")
    rows = kb.time_all("kernel times")
    print(f"kernel times: {len(rows)} (kernel, launch) rows of "
          f"{len({r['kernel'] for r in rows})} kernels")
    print(card)


#: the SSM paths' served prefills, as phases 9 and 10 serve them: (arch,
#: the backend's cache length); the prompt is the SSD main case's S
PREFILL_PROFILED = [("mamba2-780m", 417), ("zamba2-2.7b", 161)]


def prefill_profiles(src: str) -> None:
    """``--prefill-profiles [SRC]``: build the kernels and profile one
    served prefill of each SSM path (full width and depth, bf16, random
    weights from a seed; phases 9 and 10's prefill profiles), taking the
    ``repro_torch`` package from the ``src`` directory SRC of another
    checkout (default: this one); prints no JSON."""
    if src:
        sys.path.insert(0, str(Path(src).resolve()))
    card = phase_device_and_build()
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.cases import SSD_CASES, SSD_MAIN
    from repro_torch.serve.backends import TorchBackend
    print(f"prefill profiles of {Path(repro_torch.__file__).parent}")
    cases = {name: shape for name, shape, _ in SSD_CASES}
    for arch, max_len in PREFILL_PROFILED:
        be = TorchBackend(get_config(arch), max_len=max_len, device=DEVICE)
        prefill_profile(be, f"{arch} prefill profile",
                        cases[SSD_MAIN[arch]][1])
        del be
        gc.collect()
        torch.cuda.empty_cache()
    print(card)


def seq_split_phases() -> None:
    """``--seq-split``: build the kernels and run phases 31 and 32 alone
    (the sequence-split KV cache: the kernel's lse, 16 ranks on one card;
    the dry-run); prints no JSON."""
    phase_device_and_build()
    t0 = time.perf_counter()
    phase_seq_split_kernel()
    phase_seq_split_serve()
    print(f"phase 31 seconds: {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    phase_dryrun()
    print(f"phase 32 seconds: {time.perf_counter() - t0:.1f}")
    print(card_line())


def mamba_tp_phases() -> None:
    """``--mamba-tp``: build the kernels and run the split gated norm's
    checks and timing (phase 12's part), the SSD kernel's cases (phase 8,
    the TP cases among them) and phase 33 alone; prints no JSON."""
    phase_device_and_build()
    t0 = time.perf_counter()
    phase_split_norm_vs_plain()
    phase_ssd_kernel_vs_plain()
    print(f"phases 12 (split norm) and 8 seconds: "
          f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    phase_mamba_tp()
    print(f"phase 33 seconds: {time.perf_counter() - t0:.1f}")
    print(card_line())


def train_profile(src: str) -> None:
    """``--train-profile [SRC]``: build the kernels and run phase 17's
    qwen3-0.6b training main path and its step profile alone, with the
    ``repro_torch`` package of the ``src`` directory SRC of another
    checkout (default: this one), so that two versions' train steps are
    profiled on one card in one call; prints no JSON."""
    if src:
        sys.path.insert(0, str(Path(src).resolve()))
    card = phase_device_and_build()
    import repro_torch
    from repro_torch.configs import get_config
    print(f"train profile of {Path(repro_torch.__file__).parent}")
    ckpt = ROOT / "build" / "train_profile_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    out, counts = train_counted(TRAIN_ARGV + ["--ckpt-dir", str(ckpt)])
    check_train_run("train profile", out, counts, get_config("qwen3-0.6b"),
                    TRAIN_STEPS)
    steady = sorted(out["step_s"][2:])[len(out["step_s"][2:]) // 2]
    print(f"train profile qwen3-0.6b: {TRAIN_STEPS} steps of 8 x 1024 "
          f"tokens, losses {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, median step (from step 2) "
          f"{steady:.3f} s, {out['tokens_per_step'] / steady:.0f} tokens/s")
    train_step_profile(out, "train profile qwen3-0.6b step", steady)
    shutil.rmtree(ckpt, ignore_errors=True)
    print(card)


def norm_times(src: str) -> None:
    """``--norm-times [SRC]``: phase 12's timing alone (the forward RMSNorm
    kernels and the unfused sequences at the paths' launches, the split
    gated norm's entries), with the ``repro_torch`` package of the ``src``
    directory SRC of another checkout (default: this one) as
    ``--kernel-times`` takes it; builds only the RMSNorm library; prints
    no JSON."""
    if src:
        sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    print(f"norm times of {Path(repro_torch.__file__).parent}")
    C = kb.norm_cases()
    kb.time_norm_kernels("norm times", C)
    kb.time_split_norm("norm times", C)
    print(card_line())


def norm_fwd_phases() -> None:
    """``--norm-fwd``: build the kernels and run phase 12 alone (every
    forward RMSNorm kernel on every case, bit for bit against the unfused
    card sequences, and timed at the paths' launches, the train launches
    among them; the split gated norm's entries); prints no JSON."""
    phase_device_and_build()
    t0 = time.perf_counter()
    phase_rmsnorm_kernel_vs_plain()
    phase_split_norm_vs_plain()
    print(f"phase 12 seconds: {time.perf_counter() - t0:.1f}")
    print(card_line())


def norm_bwd_phases() -> None:
    """``--norm-bwd``: build the kernels and run phase 16 and the split
    gated norm's part of phase 12 alone (every backward kernel); prints
    no JSON."""
    phase_device_and_build()
    t0 = time.perf_counter()
    phase_rmsnorm_bwd_vs_plain()
    phase_split_norm_vs_plain()
    print(f"phases 16 and 12 (split norm) seconds: "
          f"{time.perf_counter() - t0:.1f}")
    print(card_line())


def tp_phases() -> None:
    """``--tp``: build the kernels and run phases 29 and 30 alone (two
    ranks on one card, training and serving); prints no JSON."""
    phase_device_and_build()
    for n, phase in ((29, phase_tp_train), (30, phase_tp_serve)):
        t0 = time.perf_counter()
        phase()
        print(f"phase {n} seconds: {time.perf_counter() - t0:.1f}")
    print(card_line())


def paged_prefill_phase() -> None:
    """``--paged-prefill``: build the kernels and run phase 35 alone (the
    paged-prefill kernel on every case, and timed); prints no JSON."""
    phase_device_and_build()
    t0 = time.perf_counter()
    phase_paged_prefill_vs_plain()
    print(f"phase 35 seconds: {time.perf_counter() - t0:.1f}")
    print(card_line())


def tools_phases() -> None:
    """``--tools``: build the kernels and run phase 32 (the dry-run's
    records, which phase 34 reads) and phase 34 alone; prints no JSON."""
    phase_device_and_build()
    for n, phase in ((32, phase_dryrun), (34, phase_tools)):
        t0 = time.perf_counter()
        phase()
        print(f"phase {n} seconds: {time.perf_counter() - t0:.1f}")
    print(card_line())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tools"]:
        tools_phases()
    elif sys.argv[1:2] == ["--paged-prefill"]:
        paged_prefill_phase()
    elif sys.argv[1:2] == ["--tp"]:
        tp_phases()
    elif sys.argv[1:2] == ["--mamba-tp"]:
        mamba_tp_phases()
    elif sys.argv[1:2] == ["--norm-bwd"]:
        norm_bwd_phases()
    elif sys.argv[1:2] == ["--norm-fwd"]:
        norm_fwd_phases()
    elif sys.argv[1:2] == ["--norm-times"]:
        norm_times(sys.argv[2] if len(sys.argv) > 2 else "")
    elif sys.argv[1:2] == ["--train-profile"]:
        train_profile(sys.argv[2] if len(sys.argv) > 2 else "")
    elif sys.argv[1:2] == ["--seq-split"]:
        seq_split_phases()
    elif sys.argv[1:2] == ["--kernel-times"]:
        kernel_times(sys.argv[2] if len(sys.argv) > 2 else "")
    elif sys.argv[1:2] == ["--prefill-profiles"]:
        prefill_profiles(sys.argv[2] if len(sys.argv) > 2 else "")
    else:
        main()
