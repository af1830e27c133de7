"""Kernel tests that need a CUDA device (marker ``gpu``); they skip on a
machine without one.  This file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA paged-decode, flash-attention, dense decode-attention and
RMSNorm kernels are held against their plain PyTorch versions at the
repo's tolerances (f32 2e-5, bf16 2e-2; RMSNorm by x's dtype), and the
three fused RMSNorm kernels (residual add, qk-norm with RoPE, Mamba2's
gate) also bit for bit against the unfused card sequences they replace
(the RMSNorm kernel beside torch's eager ops); the CUDA
SSD-scan kernel at the JAX package's SSD tolerances (f32 1e-4, bf16
5e-2; every bf16 case takes the tensor-core route).  The paged kernel
is also held on rows cut by their attended range with a table wider
than the rows (a full table, windows, len 0 and 1), and every launcher
must refuse an input that requires grad.  The attention case lists here
are shared with the CPU tests, which hold the same plain versions
against the JAX package."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as t_da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as t_ops
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_ref as t_paged_ref
from repro_torch.kernels.rmsnorm import kernel as t_rms_kernel
from repro_torch.kernels.rmsnorm import ops as t_rms_ops
from repro_torch.kernels.rmsnorm.cases import (
    BWD_ENTRIES, QK_ROPE_CASES, QK_ROPE_THETA, RMSNORM_CASES, RMSNORM_DTYPES,
    SPLIT_CASES, SPLIT_ENTRIES, add_rmsnorm_unfused, bwd_case, bwd_max_err,
    gated_rmsnorm_unfused, pair_case_on, qk_norm_rope_unfused,
    qk_rope_case_on, rmsnorm_case_on, split_case_on, split_check)
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_ref,
                                             gated_rmsnorm_ref,
                                             qk_norm_rope_ref, rmsnorm_ref)
from repro_torch.kernels.ssd_scan import ops as t_ssd_ops
from repro_torch.kernels.ssd_scan.cases import (SSD_CASES, SSD_TOL,
                                                ssd_case_on)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def paged_case(B, P, page, Hq, Hkv, D, lens, seed=0, maxp=None):
    """Random pool + a page table whose live entries are distinct pages
    (shuffled, so physical order != logical order) and whose parked
    slots point at scratch page 0 (the generator of the JAX kernel
    tests), as numpy arrays.  The table is ``maxp`` pages wide, by
    default just wide enough for the longest row."""
    r = np.random.default_rng(seed)
    q = r.normal(0, 1, (B, 1, Hq, D)).astype(np.float32)
    kp = r.normal(0, 1, (P, page, Hkv, D)).astype(np.float32)
    vp = r.normal(0, 1, (P, page, Hkv, D)).astype(np.float32)
    maxp = -(-max(lens) // page) if maxp is None else maxp
    perm = list(r.permutation(np.arange(1, P)))
    table = np.zeros((B, maxp), np.int32)
    for b, ln in enumerate(lens):
        for i in range(-(-ln // page)):
            table[b, i] = perm.pop()
    return q, kp, vp, table, np.asarray(lens, np.int32)


PAGED_CASES = [
    ((2, 16, 8, 4, 2, 16, [5, 23]), 0, 0.0),     # partial pages, GQA
    ((1, 8, 16, 2, 1, 32, [48]), 0, 0.0),        # MQA, exact page multiple
    ((3, 32, 4, 8, 8, 64, [1, 9, 17]), 0, 0.0),  # MHA, tiny pages
    ((2, 16, 8, 6, 3, 48, [12, 31]), 0, 0.0),    # odd heads, D=48
    ((2, 16, 8, 4, 2, 32, [21, 37]), 16, 0.0),   # window
    ((2, 16, 8, 4, 2, 32, [21, 37]), 8, 50.0),   # window + softcap
    ((8, 177, 16, 32, 4, 128,                    # qwen3-moe's heads, G=8
      [161, 160, 151, 140, 129, 97, 64, 17]), 0, 0.0),
]

#: the paged kernel's split of each row's attended range over a cluster
#: (kernel.py::split_ranges), with the table wider than the rows as the
#: served pool is: (B, P, page, Hq, Hkv, D, lens, maxp, window, softcap)
PAGED_SPLIT_CASES = [
    (1, 20, 16, 16, 8, 128, [304], 19, 0, 0.0),           # full table
    (2, 40, 16, 16, 8, 128, [304, 17], 19, 0, 0.0),       # full + short
    (2, 30, 16, 32, 4, 128, [161, 100], 176, 64, 0.0),    # window, G=8
    (2, 30, 16, 32, 4, 128, [161, 40], 176, 64, 30.0),    # + softcap
    (8, 20, 16, 16, 8, 128, [1] * 8, 176, 0, 0.0),        # len 1, main
    (4, 20, 16, 16, 8, 128, [1, 0, 2, 161], 176, 8, 0.0),  # 1, 0, window
    (2, 10, 16, 4, 2, 64, [7, 9], 1, 0, 0.0),             # one split
    (1, 280, 4, 4, 2, 32, [1100], 300, 0, 0.0),     # 275 pages: 19 past
    (1, 280, 4, 4, 2, 32, [1100], 300, 200, 0.0),   # the 256 ids cached
]
PAGED_SPLIT_IDS = ["full-table", "full-and-short", "window64-g8",
                   "window64-g8-softcap30", "len1-main", "lens-0-1-2-win8",
                   "one-split", "table-past-256", "table-past-256-win200"]


#: (B, S, Hq, Hkv, D, causal, window, softcap): GQA with G in {1, 2, 4, 8},
#: S not a multiple of the kernels' tiles (64 x 64 rows x keys in bf16,
#: 64 x 32 in f32), window, softcap, non-causal, the D > 128 tiling, S
#: over five K/V tiles (the bf16 ring of two stages wraps), a window that
#: starts the kv loop past key 0, and a D that is a multiple of 8 but not
#: of 16
FLASH_CASES = [
    (2, 80, 4, 4, 16, True, 0, 0.0),      # G=1, ragged S
    (2, 96, 4, 2, 32, True, 0, 0.0),      # G=2, S = 1.5 q tiles
    (1, 128, 8, 2, 64, True, 0, 0.0),     # G=4
    (2, 64, 4, 2, 16, True, 16, 0.0),     # window
    (2, 72, 4, 2, 16, True, 32, 50.0),    # window + softcap, ragged
    (1, 70, 4, 1, 32, False, 24, 30.0),   # non-causal + window + softcap
    (1, 40, 2, 1, 256, False, 0, 0.0),    # non-causal, D=256 (32 x 32)
    (1, 128, 32, 32, 80, True, 0, 0.0),   # zamba2's shared attention
    (2, 128, 32, 4, 128, True, 0, 0.0),   # qwen3-moe's heads, G=8
    (1, 320, 4, 2, 64, True, 0, 0.0),     # 5 K/V tiles, causal
    (1, 320, 4, 2, 32, False, 0, 0.0),    # 5 K/V tiles, non-causal
    (1, 320, 2, 1, 32, True, 100, 20.0),  # window: loop starts mid-row
    (2, 100, 4, 2, 40, True, 0, 0.0),     # D=40, zero-filled to 48
]

#: (B, S, Hq, Hkv, D, lens, window, softcap): lens include 1 and S, S not
#: a multiple of the kernel's split (min(8, ceil(S / 32)) blocks of
#: ceil(S / splits) slots), G in {1, 2, 4, 8}, 8 splits of several passes
#: each, a row whose tokens leave most splits empty, a window that skips
#: whole splits
DECODE_CASES = [
    (2, 64, 4, 4, 16, [1, 64], 0, 0.0),             # G=1, len 1 and S
    (2, 96, 8, 4, 32, [96, 40], 0, 0.0),            # G=2, ragged chunk
    (1, 50, 4, 1, 16, [7], 0, 0.0),                 # G=4, S < a chunk
    (3, 130, 8, 2, 64, [130, 1, 77], 16, 0.0),      # window
    (2, 70, 4, 2, 32, [70, 33], 0, 30.0),           # softcap
    (2, 100, 4, 2, 32, [100, 65], 24, 50.0),        # window + softcap
    (1, 96, 6, 3, 48, [11], 0, 0.0),                # D=48, odd heads
    (2, 161, 32, 32, 80, [145, 161], 0, 0.0),       # zamba2's shared attn
    (8, 161, 32, 4, 128, [161, 160, 151, 140, 129, 97, 64, 1], 0,
     0.0),                                          # qwen3-moe's, G=8
    (2, 1100, 4, 2, 32, [1100, 731], 0, 0.0),       # 8 splits of 138
    (3, 200, 4, 2, 32, [3, 200, 150], 0, 0.0),      # len 3: 6 of 7 empty
    (2, 600, 4, 2, 32, [600, 407], 64, 0.0),        # window skips splits
    (2, 161, 8, 1, 64, [145, 161], 0, 0.0),         # G=8 at D=64
]

def flash_case(B, S, Hq, Hkv, D, seed=0):
    """q [B, S, Hq, D], k/v [B, S, Hkv, D] (model layout), numpy f32."""
    r = np.random.default_rng(seed)
    return (r.normal(0, 1, (B, S, Hq, D)).astype(np.float32),
            r.normal(0, 1, (B, S, Hkv, D)).astype(np.float32),
            r.normal(0, 1, (B, S, Hkv, D)).astype(np.float32))


def decode_case(B, S, Hq, Hkv, D, lens, seed=0):
    """q [B, 1, Hq, D], caches [B, S, Hkv, D] and lens [B] int32, numpy."""
    r = np.random.default_rng(seed)
    return (r.normal(0, 1, (B, 1, Hq, D)).astype(np.float32),
            r.normal(0, 1, (B, S, Hkv, D)).astype(np.float32),
            r.normal(0, 1, (B, S, Hkv, D)).astype(np.float32),
            np.asarray(lens, np.int32))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("case,window,cap", PAGED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_vs_plain_on_card(case, window, cap, dtype):
    _cuda_or_skip()
    B, P, page, Hq, Hkv, D, lens = case
    arrs = paged_case(B, P, page, Hq, Hkv, D, lens)
    q, kp, vp = (torch.from_numpy(a).to("cuda", dtype) for a in arrs[:3])
    table, ln = (torch.from_numpy(a).cuda() for a in arrs[3:])
    out = t_ops.paged_attention(q, kp, vp, table, ln, window=window,
                                attn_softcap=cap)
    ref = t_paged_ref(q.transpose(1, 2).cpu(), kp.cpu(), vp.cpu(),
                      table.cpu(), ln.cpu(), scale=D ** -0.5,
                      window=window, softcap=cap).transpose(1, 2)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
def test_paged_kernel_zero_length_row_is_zero():
    """A ``lens == 0`` row comes out as zeros (the plain version averages
    such a row uniformly instead; callers never read it)."""
    _cuda_or_skip()
    arrs = paged_case(2, 8, 4, 4, 2, 16, [0, 7])
    q, kp, vp, table, ln = (torch.from_numpy(a).cuda() for a in arrs)
    out = t_ops.paged_attention(q, kp, vp, table, ln)
    assert torch.count_nonzero(out[0]).item() == 0
    ref = t_paged_ref(q.transpose(1, 2), kp, vp, table, ln,
                      scale=16 ** -0.5).transpose(1, 2)
    torch.testing.assert_close(out[1], ref[1], atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES, ids=PAGED_SPLIT_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_split_vs_plain_on_card(case, dtype):
    """Rows cut by their attended range, not by the table's width: a full
    table, windows that leave the early pages out, len 1 at the main
    shape (one block of eight holds the token), and len 0 (zeros)."""
    _cuda_or_skip()
    B, P, page, Hq, Hkv, D, lens, maxp, window, cap = case
    arrs = paged_case(B, P, page, Hq, Hkv, D, lens, maxp=maxp)
    q, kp, vp = (torch.from_numpy(a).to("cuda", dtype) for a in arrs[:3])
    table, ln = (torch.from_numpy(a).cuda() for a in arrs[3:])
    assert table.shape[1] == maxp
    out = t_ops.paged_attention(q, kp, vp, table, ln, window=window,
                                attn_softcap=cap)
    ref = t_paged_ref(q.transpose(1, 2).cpu(), kp.cpu(), vp.cpu(),
                      table.cpu(), ln.cpu(), scale=D ** -0.5,
                      window=window, softcap=cap).transpose(1, 2)
    torch.cuda.synchronize()
    live = ln.cpu() >= 1
    assert torch.count_nonzero(out.cpu()[~live]).item() == 0
    torch.testing.assert_close(out.cpu()[live].float(), ref[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_kernels_refuse_grad_on_card():
    """On the card too, every launcher refuses an input that requires
    grad while grad is enabled, and launches nothing; under
    ``torch.no_grad()`` the same call launches its kernel.  The attention
    and SSD ops call their launchers directly, so they refuse too; the
    RMSNorm ops wrap theirs in autograd Functions
    (test_norm_ops_carry_a_gradient_on_card), so their bare launchers are
    called here."""
    _cuda_or_skip()

    def grad(t):
        return t.detach().clone().requires_grad_(True)

    pq, pk, pv, table, ln = (torch.from_numpy(a).cuda() for a in
                             paged_case(2, 8, 4, 4, 2, 16, [3, 7]))
    dq, dk, dv, dl = (torch.from_numpy(a).cuda() for a in
                      decode_case(2, 16, 4, 2, 16, [3, 7]))
    fq, fk, fv = (torch.from_numpy(a).cuda() for a in
                  flash_case(1, 64, 2, 1, 16))
    xb, a, Bm, Cm, _ = ssd_case_on("cuda", torch.float32, 1, 8, 2, 4, 1, 4)
    x, w = rmsnorm_case_on("cuda", torch.float32, torch.float32, (4, 64),
                           "dense")
    q, k, wq, wk, pos = qk_rope_case_on("cuda", torch.float32, torch.float32,
                                        (2, 3, 4, 2, 16), "rows", True)
    calls = [
        (t_ops.paged_attention_fwd,
         lambda: t_ops.paged_attention(grad(pq), pk, pv, table, ln)),
        (t_da_ops.decode_attention_fwd,
         lambda: t_da_ops.decode_attention(grad(dq), dk, dv, dl - 1)),
        (t_fa_ops.flash_attention_fwd,
         lambda: t_fa_ops.flash_attention(grad(fq), fk, fv)),
        (t_ssd_ops.ssd_scan_fwd,
         lambda: t_ssd_ops.ssd_scan(grad(xb), a, Bm, Cm, chunk=4)),
        (t_rms_kernel.rmsnorm_fwd,
         lambda: t_rms_kernel.rmsnorm_fwd(x, grad(w), eps=1e-6)),
        (t_rms_kernel.add_rmsnorm_fwd,
         lambda: t_rms_kernel.add_rmsnorm_fwd(x, grad(x), w, eps=1e-6)),
        (t_rms_kernel.gated_rmsnorm_fwd,
         lambda: t_rms_kernel.gated_rmsnorm_fwd(grad(x), x, w, eps=1e-6)),
        (t_rms_kernel.qk_norm_rope_fwd,
         lambda: t_rms_kernel.qk_norm_rope_fwd(
             q, k, grad(wq), wk, pos, t_rms_ops.inv_freq(
                 q.device, q.shape[-1], QK_ROPE_THETA), eps=1e-6)),
        (t_rms_kernel.rmsnorm_bwd,
         lambda: t_rms_kernel.rmsnorm_bwd(grad(x), x, w, eps=1e-6)),
    ]
    for fn, call in calls:
        before = fn.launches
        with pytest.raises(RuntimeError,
                           match=f"{fn.__name__} has no backward"):
            call()
        assert fn.launches == before
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        assert fn.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_vs_plain_on_card(case, dtype):
    _cuda_or_skip()
    B, S, Hq, Hkv, D, causal, window, cap = case
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in flash_case(B, S, Hq, Hkv, D))
    out = t_fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                   attn_softcap=cap)
    ref = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                        scale=D ** -0.5, causal=causal, window=window,
                        softcap=cap).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_vs_plain_on_card(case, dtype):
    _cuda_or_skip()
    B, S, Hq, Hkv, D, lens, window, cap = case
    arrs = decode_case(B, S, Hq, Hkv, D, lens)
    q, kc, vc = (torch.from_numpy(a).to("cuda", dtype) for a in arrs[:3])
    ln = torch.from_numpy(arrs[3]).cuda()
    out = t_da_ops.decode_attention(q, kc, vc, ln - 1, window=window,
                                    attn_softcap=cap)
    ref = decode_attention_ref(q.transpose(1, 2), kc, vc, ln,
                               scale=D ** -0.5, window=window,
                               softcap=cap).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


#: the remaining families' served launches, with their attention scale:
#: (name, (B, S, Hq, Hkv, D), causal, window, softcap, scale) of the
#: flash kernel -- gemma2-27b's local and global layers (scale 144^-0.5,
#: softcap 50; the window binds at S 4160), whisper-large-v3's decoder
#: (D 64, G 1), pixtral-12b's prompt with its 4 patches (S 132)
SERVED_FLASH_CASES = [
    ("gemma2-local", (8, 128, 32, 16, 128), True, 4096, 50.0, 144 ** -0.5),
    ("gemma2-global", (8, 128, 32, 16, 128), True, 0, 50.0, 144 ** -0.5),
    ("gemma2-local-4160", (1, 4160, 32, 16, 128), True, 4096, 50.0,
     144 ** -0.5),
    ("whisper-decoder", (8, 128, 20, 20, 64), True, 0, 0.0, 64 ** -0.5),
    ("pixtral-s132", (8, 132, 32, 8, 128), True, 0, 0.0, 128 ** -0.5),
]
#: (name, (B, S, Hq, Hkv, D), positions, window, softcap, scale) of the
#: dense-decode kernel; a position past S - 1 is a write clamped onto the
#: last slot (pixtral's patches), with a window measured from it
SERVED_DECODE_CASES = [
    ("gemma2-local", (8, 161, 32, 16, 128), 144, 4096, 50.0, 144 ** -0.5),
    ("gemma2-local-4177", (2, 4177, 32, 16, 128), 4170, 4096, 50.0,
     144 ** -0.5),
    ("whisper-decoder", (8, 161, 20, 20, 64), 144, 0, 0.0, 64 ** -0.5),
    ("pixtral-clamped", (8, 161, 32, 8, 128), 163, 0, 0.0, 128 ** -0.5),
    ("clamped-window", (2, 96, 8, 2, 64), 99, 40, 30.0, 64 ** -0.5),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SERVED_FLASH_CASES,
                         ids=[c[0] for c in SERVED_FLASH_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_served_shapes(case, dtype):
    _cuda_or_skip()
    _, (B, S, Hq, Hkv, D), causal, window, cap, scale = case
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in flash_case(B, S, Hq, Hkv, D))
    out = t_fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                   attn_softcap=cap, scale=scale)
    ref = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                        scale=scale, causal=causal, window=window,
                        softcap=cap).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", SERVED_DECODE_CASES,
                         ids=[c[0] for c in SERVED_DECODE_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_the_served_shapes(case, dtype):
    """Every row at the shared position, as the dense cache is; past the
    last slot the kernel gets lens = S and the window's end apart."""
    _cuda_or_skip()
    _, (B, S, Hq, Hkv, D), pos, window, cap, scale = case
    arrs = decode_case(B, S, Hq, Hkv, D, [pos + 1] * B)
    q, kc, vc = (torch.from_numpy(a).to("cuda", dtype) for a in arrs[:3])
    ends = torch.from_numpy(arrs[3])
    before = t_da_ops.decode_attention_fwd.launches
    out = t_da_ops.decode_attention(
        q, kc, vc, torch.tensor(pos, dtype=torch.int32, device="cuda"),
        window=window, attn_softcap=cap, scale=scale)
    ref = decode_attention_ref(q.transpose(1, 2).cpu(), kc.cpu(), vc.cpu(),
                               torch.clamp(ends, max=S), scale=scale,
                               window=window, softcap=cap,
                               ends=ends).transpose(1, 2)
    torch.cuda.synchronize()
    assert t_da_ops.decode_attention_fwd.launches == before + 1
    torch.testing.assert_close(out.cpu().float(), ref.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


#: one rank's range of a cache split over the sequence: (name, (B, S,
#: Hq, Hkv, D), the range's first slot, the rows' positions, window,
#: softcap) -- rows before, inside and past the range, a window that
#: ends before it, one that starts inside it
RANGE_DECODE_CASES = [
    ("rows-around-the-range", (4, 64, 8, 2, 32), 64, [10, 70, 127, 300],
     0, 0.0),
    ("window-leaves-it-empty", (3, 96, 8, 4, 64), 96, [250, 150, 100], 40,
     30.0),
    ("qwen3-rank", (8, 128, 16, 8, 128), 256, [5, 255, 256, 300, 383, 384,
                                                 1000, 320], 0, 0.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RANGE_DECODE_CASES,
                         ids=[c[0] for c in RANGE_DECODE_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_lse_on_a_range_vs_plain_on_card(case, dtype):
    """``decode_attention(..., slot_offset=, return_lse=True)`` on a CUDA
    tensor launches the kernel (its count rises by one) and returns o and
    lse as the plain version computes them; a row that attends nothing
    gives o = 0 and lse = -inf, no NaN."""
    _cuda_or_skip()
    _, (B, S, Hq, Hkv, D), off, pos, window, cap = case
    arrs = decode_case(B, S, Hq, Hkv, D, [1] * B)
    q, kc, vc = (torch.from_numpy(a).to("cuda", dtype) for a in arrs[:3])
    posd = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = t_da_ops.decode_attention_fwd.launches
    out, lse = t_da_ops.decode_attention(q, kc, vc, posd, window=window,
                                         attn_softcap=cap, slot_offset=off,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert t_da_ops.decode_attention_fwd.launches == before + 1
    ends = torch.tensor(pos, dtype=torch.int32) + 1 - off
    ro, rl = decode_attention_ref(
        q.transpose(1, 2).cpu(), kc.cpu(), vc.cpu(), torch.clamp(ends, 0, S),
        scale=D ** -0.5, window=window, softcap=cap, ends=ends,
        return_lse=True)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    empty = rl == -torch.inf
    assert empty.any() and torch.equal(lse.cpu() == -torch.inf, empty)
    assert torch.all(out.transpose(1, 2).cpu()[empty] == 0)
    torch.testing.assert_close(out.cpu().float(),
                               ro.transpose(1, 2).float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse.cpu()[~empty], rl[~empty], atol=1e-4,
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["pixtral-12b", "gemma2-27b",
                                  "whisper-large-v3"])
def test_dense_decode_past_the_cache_on_card_matches_the_cpu(arch):
    """Smoke size in f32 (TF32 off): a prefill of 10 positions (pixtral's
    6 tokens and 4 patches) and decode steps into a cache of 12 slots to
    position 13, the last two past its end (clamped onto slot 11, as JAX
    clamps them), on the card (kernels) and on the CPU (plain): greedy
    tokens equal, logits within 2e-4."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    from repro_torch.utils.tree import tree_map
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32",
                                               compute_dtype="float32")
    params = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(3)
    S = 6 if cfg.family == "vlm" else 10
    batch = {"tokens": torch.from_numpy(
        r.integers(3, cfg.vocab_size, (2, S)).astype(np.int64))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            r.normal(0, 0.02, (2, 4, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            r.normal(0, 0.02, (2, 8, cfg.d_model)).astype(np.float32))
    outs = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        logits, cache = tm.prefill(p, cfg, {k: v.to(dev) for k, v in
                                            batch.items()}, 12)
        seq = [logits.cpu()]
        for _ in range(4):
            logits, cache = tm.decode_step(p, cfg, cache, logits.argmax(-1))
            seq.append(logits.cpu())
        outs[dev] = seq
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(g.argmax(-1), c.argmax(-1))
        torch.testing.assert_close(g, c, atol=2e-4, rtol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_CASES, ids=[c[0] for c in SSD_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_vs_plain_on_card(case, dtype):
    """B and C as views into one projection, as the model passes them."""
    _cuda_or_skip()
    _, (B, S, H, P, G, N, chunk), init = case
    xb, a, Bm, Cm, s0 = ssd_case_on("cuda", dtype, B, S, H, P, G, N, init)
    y, st = t_ssd_ops.ssd_scan(xb, a, Bm, Cm, chunk=chunk, initial_state=s0)
    yr, sr = ssd_scan_ref(xb, a, Bm, Cm, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, sr, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", RMSNORM_CASES,
                         ids=[c[0] for c in RMSNORM_CASES])
@pytest.mark.parametrize("dtypes", RMSNORM_DTYPES,
                         ids=lambda d: f"{str(d[0])[6:]}-{str(d[1])[6:]}")
def test_rmsnorm_kernel_vs_plain_on_card(case, dtypes):
    """Every case layout is read in place (one launch, no copy), and the
    output has x's shape and dtype."""
    _cuda_or_skip()
    _, shape, layout = case
    x, w = rmsnorm_case_on("cuda", *dtypes, shape, layout)
    before = t_rms_kernel.rmsnorm_fwd.launches
    out = t_rms_ops.rmsnorm(x, w, 1e-6)
    ref = rmsnorm_ref(x, w, 1e-6)
    torch.cuda.synchronize()
    assert t_rms_kernel.rmsnorm_fwd.launches == before + 1
    assert out.shape == x.shape and out.dtype == x.dtype
    assert t_rms_ops.row_view(x).data_ptr() == x.data_ptr()
    tol = TOL[dtypes[0]]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


_DTYPE_IDS = lambda d: f"{str(d[0])[6:]}-{str(d[1])[6:]}"  # noqa: E731


def _bit_equal(name, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    differ = int((got != want).sum())
    assert differ == 0, f"{name}: {differ} elements differ from the unfused " \
                        f"card sequence"


@pytest.mark.gpu
@pytest.mark.parametrize("case", RMSNORM_CASES,
                         ids=[c[0] for c in RMSNORM_CASES])
@pytest.mark.parametrize("dtypes", RMSNORM_DTYPES, ids=_DTYPE_IDS)
def test_add_rmsnorm_kernel_on_card(case, dtypes):
    """Within tolerance of the plain version, and bit-equal to torch's
    add + the RMSNorm kernel (the norm and the residual), in one launch;
    x and delta read in place in every layout."""
    _cuda_or_skip()
    _, shape, layout = case
    x, d, w = pair_case_on("cuda", *dtypes, shape, layout)
    before = t_rms_kernel.add_rmsnorm_fwd.launches
    out, r = t_rms_ops.add_rmsnorm(x, d, w, 1e-6)
    torch.cuda.synchronize()
    assert t_rms_kernel.add_rmsnorm_fwd.launches == before + 1
    ref, ref_r = add_rmsnorm_ref(x, d, w, 1e-6)
    tol = TOL[dtypes[0]]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(r.float(), ref_r.float(), atol=tol, rtol=tol)
    u_out, u_r = add_rmsnorm_unfused(x, d, w, 1e-6)
    _bit_equal("out", out, u_out)
    _bit_equal("r", r, u_r)


@pytest.mark.gpu
@pytest.mark.parametrize("case", RMSNORM_CASES,
                         ids=[c[0] for c in RMSNORM_CASES])
@pytest.mark.parametrize("dtypes", RMSNORM_DTYPES, ids=_DTYPE_IDS)
def test_gated_rmsnorm_kernel_on_card(case, dtypes):
    """Within tolerance of the plain version, and bit-equal to F.silu +
    torch's mul + the RMSNorm kernel, in one launch."""
    _cuda_or_skip()
    _, shape, layout = case
    y, z, w = pair_case_on("cuda", *dtypes, shape, layout)
    before = t_rms_kernel.gated_rmsnorm_fwd.launches
    out = t_rms_ops.gated_rmsnorm(y, z, w, 1e-6)
    torch.cuda.synchronize()
    assert t_rms_kernel.gated_rmsnorm_fwd.launches == before + 1
    ref = gated_rmsnorm_ref(y, z, w, 1e-6)
    tol = TOL[dtypes[0]]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    _bit_equal("out", out, gated_rmsnorm_unfused(y, z, w, 1e-6))


@pytest.mark.gpu
@pytest.mark.parametrize("case", QK_ROPE_CASES,
                         ids=[c[0] for c in QK_ROPE_CASES])
@pytest.mark.parametrize("dtypes", RMSNORM_DTYPES, ids=_DTYPE_IDS)
def test_qk_norm_rope_kernel_on_card(case, dtypes):
    """Within tolerance of the plain version, and bit-equal to two
    RMSNorm kernels + apply_rope's eager ops, in one launch (none for no
    rows)."""
    _cuda_or_skip()
    _, dims, positions, norm, layout = case
    q, k, wq, wk, pos = qk_rope_case_on("cuda", *dtypes, dims, positions,
                                        norm, layout)
    before = t_rms_kernel.qk_norm_rope_fwd.launches
    tq, tk = t_rms_ops.qk_norm_rope(q, k, wq, wk, pos, QK_ROPE_THETA, 1e-6)
    torch.cuda.synchronize()
    rows = q.shape[0] * q.shape[1]
    assert t_rms_kernel.qk_norm_rope_fwd.launches == before + (rows > 0)
    rq, rk = qk_norm_rope_ref(q, k, wq, wk, pos, QK_ROPE_THETA, 1e-6)
    tol = TOL[dtypes[0]]
    for got, ref in ((tq, rq), (tk, rk)):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)
    uq, uk = qk_norm_rope_unfused(q, k, wq, wk, pos, QK_ROPE_THETA, 1e-6)
    _bit_equal("q", tq, uq)
    _bit_equal("k", tk, uk)


@pytest.mark.gpu
def test_fused_row_kernels_take_no_rows():
    """rows == 0: empty outputs of the right shape, and no launch."""
    _cuda_or_skip()
    x = torch.zeros(0, 64, device="cuda")
    w = torch.ones(64, device="cuda")
    fns = (t_rms_kernel.add_rmsnorm_fwd, t_rms_kernel.gated_rmsnorm_fwd)
    before = [f.launches for f in fns]
    out, r = t_rms_ops.add_rmsnorm(x, x, w, 1e-6)
    assert out.shape == r.shape == (0, 64)
    assert t_rms_ops.gated_rmsnorm(x, x, w, 1e-6).shape == (0, 64)
    assert [f.launches for f in fns] == before



# --- the split gated norm (Mamba2 under tensor parallelism) -----------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("dtypes", RMSNORM_DTYPES, ids=_DTYPE_IDS)
def test_split_gated_norm_kernels_vs_plain_and_the_whole_row_on_card(
        case, dtypes):
    """Each rank's ``gated_rmsnorm_sumsq`` / ``_scale`` / ``_dot`` /
    ``_scale_bwd`` against its plain version (given the kernels' sums
    over the ranks, in rank order), and the ranks' outputs side by side
    against the whole-row ``gated_rmsnorm_fwd`` / ``_bwd``
    (``cases.py::split_check``'s bounds: f32 1e-6 of max(1, max|ref|),
    bf16 one ulp for the output and four for dy and dz, dw one ulp plus
    its sum's f32 floor); one launch per entry and rank."""
    _cuda_or_skip()
    fns = [getattr(t_rms_kernel, e) for e in SPLIT_ENTRIES]
    before = [f.launches for f in fns]
    errs = split_check("cuda", *dtypes, case)
    torch.cuda.synchronize()
    bad = {k: v for k, v in errs.items() if not v[1]}
    assert not bad, bad
    assert [f.launches - b for f, b in zip(fns, before)] == [case[2]] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_gated_norm_op_carries_its_gradient_on_card(dtype):
    """``ops.gated_rmsnorm_split`` on CUDA inputs that require grad, one
    rank's whole row (``reduce`` the identity): its Function launches
    the two forward entries once and, in the backward, the two backward
    ones once; output and gradients equal autograd of the plain whole
    row within TOL."""
    _cuda_or_skip()
    (y, z, dout, w), _ = split_case_on("cuda", dtype, dtype, (6, 3, 256), 1)
    fns = [getattr(t_rms_kernel, e) for e in SPLIT_ENTRIES]
    before = [f.launches for f in fns]
    leaves = [t.clone().requires_grad_(True) for t in (y, z, w)]
    out = t_rms_ops.gated_rmsnorm_split(*leaves, 256, lambda t: t, 1e-6)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]
    ref_leaves = [t.clone().requires_grad_(True) for t in (y, z, w)]
    ref = gated_rmsnorm_ref(*ref_leaves, 1e-6)
    ref.backward(dout)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    for a, b in zip(leaves, ref_leaves):
        scale = max(1.0, float(b.grad.float().abs().max()))
        torch.testing.assert_close(a.grad.float(), b.grad.float(),
                                   atol=tol * scale, rtol=tol)


@pytest.mark.gpu
def test_split_gated_norm_entries_refuse_a_short_width_and_take_no_rows():
    """``d_total`` below the local width raises; rows == 0 launch
    nothing."""
    _cuda_or_skip()
    x = torch.zeros(0, 64, device="cuda")
    w = torch.ones(64, device="cuda")
    fns = [getattr(t_rms_kernel, e) for e in SPLIT_ENTRIES]
    before = [f.launches for f in fns]
    ss = t_rms_kernel.gated_rmsnorm_sumsq(x, x)
    assert ss.shape == (0,) and ss.dtype == torch.float32
    assert t_rms_kernel.gated_rmsnorm_scale(x, x, w, ss, d_total=128,
                                            eps=1e-6).shape == (0, 64)
    assert [f.launches for f in fns] == before
    y = torch.ones(2, 64, device="cuda")
    with pytest.raises(ValueError, match="d_total"):
        t_rms_kernel.gated_rmsnorm_scale(
            y, y, w, torch.ones(2, device="cuda"), d_total=32, eps=1e-6)


# --- the backward kernels (the training slice) ------------------------------

#: (backward, case): the row kernels on every RMSNORM_CASES entry, the
#: qk-norm-RoPE backward on every QK_ROPE_CASES entry
BWD_CASES = [(e, c) for e in BWD_ENTRIES
             for c in (QK_ROPE_CASES if e == "qk_norm_rope_bwd"
                       else RMSNORM_CASES)]


@pytest.mark.gpu
@pytest.mark.parametrize("entry,case", BWD_CASES,
                         ids=[f"{e}-{c[0]}" for e, c in BWD_CASES])
@pytest.mark.parametrize("dtypes", RMSNORM_DTYPES, ids=_DTYPE_IDS)
def test_norm_bwd_kernel_vs_plain_on_card(entry, case, dtypes):
    """Each backward kernel against its plain formula and against
    torch.autograd of the plain forward (TOL by x's dtype, a weight
    gradient by the looser of x's and w's, relative to its largest value:
    a bf16 x rounds the terms its sum adds), in one counted
    call (none for no rows); a second call on the same inputs gives the
    same bits (dw's partial rows are summed in a fixed order, no
    atomics)."""
    _cuda_or_skip()
    kernel, plain, auto = bwd_case(entry, "cuda", *dtypes, case)
    fn = getattr(t_rms_kernel, entry)
    before = fn.launches
    got = kernel()
    torch.cuda.synchronize()
    rows = got[0].numel() > 0
    assert fn.launches == before + rows
    for want in (plain(), auto()):
        err, ok = bwd_max_err(got, want, TOL[dtypes[0]],
                              max(TOL[dtypes[0]], TOL[dtypes[1]]))
        assert ok, err
    again = kernel()
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_ops_carry_a_gradient_on_card(dtype):
    """The four RMSNorm ops on CUDA inputs that require grad: each
    returns a ``grad_fn``, launches its forward kernel once and, in the
    backward, its backward kernel once; the gradients equal autograd of
    the plain versions within TOL."""
    _cuda_or_skip()
    from repro_torch.kernels.rmsnorm import ref as R
    x, d, w = pair_case_on("cuda", dtype, dtype, (6, 3, 256), "dense")
    q, k, wq, wk, pos = qk_rope_case_on("cuda", dtype, dtype,
                                        (2, 5, 4, 2, 64), "rows", True)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]
    runs = [
        ("rmsnorm", lambda a, b: (t_rms_ops.rmsnorm(a, b, 1e-6),),
         lambda a, b: (R.rmsnorm_ref(a, b, 1e-6),), (x, w)),
        ("add_rmsnorm", lambda a, b, c: t_rms_ops.add_rmsnorm(a, b, c, 1e-6),
         lambda a, b, c: R.add_rmsnorm_ref(a, b, c, 1e-6), (x, d, w)),
        ("gated_rmsnorm",
         lambda a, b, c: (t_rms_ops.gated_rmsnorm(a, b, c, 1e-6),),
         lambda a, b, c: (R.gated_rmsnorm_ref(a, b, c, 1e-6),), (x, d, w)),
        ("qk_norm_rope",
         lambda a, b, c, e: t_rms_ops.qk_norm_rope(a, b, c, e, pos,
                                                   QK_ROPE_THETA, 1e-6),
         lambda a, b, c, e: R.qk_norm_rope_ref(a, b, c, e, pos,
                                               QK_ROPE_THETA, 1e-6),
         (q, k, wq, wk)),
    ]
    for op, fn, ref, inputs in runs:
        fwd = getattr(t_rms_kernel, f"{op}_fwd")
        bwd = getattr(t_rms_kernel, f"{op}_bwd")
        f0, b0 = fwd.launches, bwd.launches
        ins = leaves(*inputs)
        outs = fn(*ins)
        assert all(o.grad_fn is not None for o in outs)
        cots = [torch.randn_like(o) for o in outs]
        torch.autograd.backward(outs, cots)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (f0 + 1, b0 + 1), op
        ref_ins = leaves(*inputs)
        torch.autograd.backward(ref(*ref_ins), cots)
        err, ok = bwd_max_err([t.grad for t in ins],
                              [t.grad for t in ref_ins], TOL[dtype])
        assert ok, (op, err)


def _train_launches(arch, device):
    """One ``build_train_step`` step of the arch's smoke config in f32 on
    ``device``: (metrics, new params, {launcher name: launches in the
    step})."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_fwd
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
    from repro_torch.models import model as tm
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32",
                                               compute_dtype="float32")
    tc = TrainConfig()
    from repro_torch.utils.tree import tree_map
    params = tree_map(lambda p: p.to(device),
                      tm.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    opt = optim.init_opt_state(params, tc)
    r = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(r.integers(
                 3, cfg.vocab_size, (2, 32)).astype(np.int32)).to(device),
             "labels": torch.from_numpy(r.integers(
                 3, cfg.vocab_size, (2, 32)).astype(np.int32)).to(device)}
    fns = [paged_attention_fwd, flash_attention_fwd, decode_attention_fwd,
           ssd_scan_fwd] + [getattr(t_rms_kernel, f"{e[:-4]}_{d}")
                            for e in BWD_ENTRIES for d in ("fwd", "bwd")]
    before = {f.__name__: f.launches for f in fns}
    params2, _, metrics = build_train_step(cfg, tc)(params, opt, batch)
    if device != "cpu":
        torch.cuda.synchronize()
    return metrics, params2, {f.__name__: f.launches - before[f.__name__]
                              for f in fns}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m", "zamba2-2.7b",
                                  "qwen3-moe-30b-a3b", "gemma2-27b"])
def test_train_step_on_card_runs_the_norm_kernels_and_no_other(arch):
    """A train step on the card raises nothing, runs every norm's
    forward and backward kernel and no attention or SSD kernel (the train
    mode takes their plain versions), and its loss, grad norm and new
    params match the CPU's (f32, TF32 off) within 1e-4 relative."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    m_gpu, p_gpu, counts = _train_launches(arch, "cuda")
    for k in ("paged_attention_fwd", "flash_attention_fwd",
              "decode_attention_fwd", "ssd_scan_fwd"):
        assert counts[k] == 0, (k, counts)
    assert counts["rmsnorm_fwd"] > 0 and counts["rmsnorm_bwd"] > 0
    assert counts["add_rmsnorm_bwd"] > 0
    m_cpu, p_cpu, _ = _train_launches(arch, "cpu")
    for key in ("total_loss", "grad_norm"):
        a, b = float(m_gpu[key]), float(m_cpu[key])
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (key, a, b)
    from repro_torch.utils.tree import tree_leaves
    for g, c in zip(tree_leaves(p_gpu), tree_leaves(p_cpu)):
        assert torch.allclose(g.cpu(), c, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m", "zamba2-2.7b",
                                  "qwen3-moe-30b-a3b", "pixtral-12b",
                                  "gemma2-27b", "whisper-large-v3"])
def test_train_grads_on_card_match_the_cpu(arch):
    """``value_and_grad`` of the loss at smoke size in f32 (TF32 off):
    the card's loss within 1e-5 and every gradient leaf within 1e-4 of
    its largest value of the CPU's (the same arithmetic summed in other
    orders, the norms' kernels against their plain versions)."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    from repro_torch.train.step import build_loss_fn, value_and_grad
    from repro_torch.utils.tree import flatten_with_paths, tree_map
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32",
                                               compute_dtype="float32")
    params = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(2)
    toks = r.integers(3, cfg.vocab_size, (2, 32)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :24 if cfg.family == "vlm"
                                             else 32]),
             "labels": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            r.normal(0, 0.02, (2, 8, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            r.normal(0, 0.02, (2, 16, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        (loss, _), grads = value_and_grad(build_loss_fn(cfg), p, b)
        out[dev] = (float(loss), flatten_with_paths(
            tree_map(lambda t: t.cpu(), grads)))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * max(
        1.0, abs(out["cpu"][0]))
    for (path, g), (_, c) in zip(out["cuda"][1], out["cpu"][1]):
        scale = max(float(c.abs().max()), 1e-30)
        assert float((g - c).abs().max()) <= 1e-4 * scale, path


# --- scale-out on the card: one NCCL rank -----------------------------------

@pytest.fixture
def nccl_mesh():
    """A (1, 1) (data, model) mesh of one NCCL rank on card 0, torn down
    after the test."""
    _cuda_or_skip()
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield make_debug_mesh((1, 1), device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("tp", [False, True], ids=["ep", "ep-tp-dispatch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_ep_on_one_nccl_rank_equals_moe_ffn(nccl_mesh, dtype, tp):
    """At D = M = 1 the capacity per source shard is the global one and
    every collective runs over one rank: ``moe_ffn_ep`` at
    qwen3-moe-30b-a3b's widths (d 2048, 128 experts, f 768, k 8; 1,024
    tokens, factor 1.25, so some drop) gives ``moe_ffn``'s output, aux
    and gradients, at the repo's tolerances (TF32 off)."""
    from repro_torch.models import moe_ep
    from repro_torch.models.moe import moe_ffn
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    N, d, E, f, k = 1024, 2048, 128, 768, 8
    shapes = [(N, d), (d, E), (E, d, f), (E, d, f), (E, f, d)]
    base = [(torch.randn(s, generator=g, device="cuda")
             * (1.0 if i == 0 else 0.02)).to(dtype)
            for i, s in enumerate(shapes)]
    base[1] = base[1].float()               # the router is fp32
    cot = torch.randn(N, d, generator=g, device="cuda").to(dtype)
    outs = []
    for ep in (False, True):
        ins = [t.clone().requires_grad_(True) for t in base]
        kw = dict(k=k, capacity_factor=1.25, with_aux=True)
        calls = moe_ep.moe_ffn_ep.calls
        if ep:
            with moe_ep.ep_mesh_context(nccl_mesh, tp_dispatch=tp):
                o = moe_ep.moe_ffn_ep(*ins, **kw)
            assert moe_ep.moe_ffn_ep.calls == calls + 1
        else:
            o = moe_ffn(*ins, **kw)
        torch.autograd.backward([o.y, o.aux_loss],
                                [cot, torch.ones((), device="cuda")])
        outs.append((o, [t.grad for t in ins]))
    (ref, ref_g), (got, got_g) = outs
    tol = TOL[dtype]
    assert float(ref.fraction_dropped) > 0
    assert float(got.fraction_dropped) == float(ref.fraction_dropped)
    torch.testing.assert_close(got.y, ref.y, atol=tol, rtol=tol)
    torch.testing.assert_close(got.aux_loss, ref.aux_loss, atol=1e-6,
                               rtol=1e-6)
    for a, b in zip(got_g, ref_g):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol * scale


@pytest.mark.gpu
def test_sharded_step_on_one_nccl_rank_equals_the_one_rank_step(nccl_mesh):
    """The sharded step on a (1, 1) NCCL mesh (DTensor state, the
    gradient all-reduce and the ZeRO-1 slices over one rank) gives the
    plain step's loss and parameters: the MoE smoke in f32 under expert
    parallelism, two steps."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.sharding import train_shardings
    from repro_torch.models import model as tm
    from repro_torch.train import optim
    from repro_torch.train.sharded import (build_sharded_train_step,
                                           gather_state, shard_state)
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    batches = [{n: torch.from_numpy(v).cuda() for n, v in make_batch(
        cfg, ShapeConfig("t", "train", 32, 4), DataConfig(), i).items()}
        for i in range(2)]
    p = tm.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    o = optim.init_opt_state(p, tc)
    sh = train_shardings(cfg, nccl_mesh, p, o, batches[0], tc)
    dp, do = shard_state(p, o, sh)
    step = build_sharded_train_step(cfg, tc, sh, ep=True)
    plain = build_train_step(cfg, tc)
    for b in batches:
        p, o, m = plain(p, o, b)
        dp, do, dm = step(dp, do, b)
        assert abs(float(dm["total_loss"]) - float(m["total_loss"])) <= 1e-5
    for a, b in zip(tree_leaves(gather_state(dp)), tree_leaves(p)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_train_cli_sets_up_and_tears_down_its_nccl_rank(tmp_path):
    """``--mesh 1x1 --ep-moe`` with no process group: the driver sets up
    one NCCL rank (never gloo), trains on the card, gives the losses of
    the run without a mesh and tears the group down."""
    _cuda_or_skip()
    import torch.distributed as dist
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cuda",
            "--steps", "3", "--batch", "4", "--seq", "32", "--ckpt-every",
            "100", "--ckpt-dir", str(tmp_path)]
    seen = {}
    real = train._train

    def spy(args_, dev, mesh):
        seen["backend"] = dist.get_backend()
        seen["device"] = mesh.device_type
        return real(args_, dev, mesh)
    train._train = spy
    try:
        meshed = train.main(args + ["--mesh", "1x1", "--ep-moe"])
    finally:
        train._train = real
    assert seen == {"backend": "nccl", "device": "cuda"}
    assert not dist.is_initialized()
    plain = train.main(args)
    np.testing.assert_allclose(meshed["losses"], plain["losses"],
                               atol=1e-5, rtol=0)
