"""Kernel tests that need a CUDA device (marker ``gpu``); they skip on a
machine without one.  This file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA paged-decode kernel is held against its plain PyTorch version
at the repo's tolerances (f32 2e-5, bf16 2e-2)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops as t_ops
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_ref as t_paged_ref


def paged_case(B, P, page, Hq, Hkv, D, lens, seed=0):
    """Random pool + a page table whose live entries are distinct pages
    (shuffled, so physical order != logical order) and whose parked
    slots point at scratch page 0 (the generator of the JAX kernel
    tests), as numpy arrays."""
    r = np.random.default_rng(seed)
    q = r.normal(0, 1, (B, 1, Hq, D)).astype(np.float32)
    kp = r.normal(0, 1, (P, page, Hkv, D)).astype(np.float32)
    vp = r.normal(0, 1, (P, page, Hkv, D)).astype(np.float32)
    maxp = -(-max(lens) // page)
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
]


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
