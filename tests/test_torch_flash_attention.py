"""The port's flash-attention plain version against the JAX package's,
including the JAX Pallas flash kernel in interpret mode (f32, CPU, atol
1e-5: both sides compute in f32, in a different order).  The CUDA kernel
is held against the plain version by tests/test_torch_gpu.py (run on a
card) and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models import attention as ja
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                        smem_bytes, tiles)
from repro_torch.kernels.flash_attention.ref import attention_ref as t_ref
from repro_torch.models import attention as ta
from test_torch_gpu import FLASH_CASES, flash_case

torch.set_num_threads(1)
ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_ref_vs_jax_ref_and_pallas(case):
    B, S, Hq, Hkv, D, causal, window, cap = case
    q, k, v = flash_case(B, S, Hq, Hkv, D, seed=1)
    kw = dict(causal=causal, window=window, softcap=cap)
    t = t_ref(*(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
              scale=D ** -0.5, **kw)
    _close(t, j_ref(*(jnp.moveaxis(jnp.asarray(a), 2, 1)
                      for a in (q, k, v)), scale=D ** -0.5, **kw))
    # the Pallas kernel itself, in interpret mode (the default off-TPU)
    j_ker = j_pallas(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                     window=window, attn_softcap=cap, blk_q=32, blk_k=32)
    _close(t.transpose(1, 2), j_ker)


def test_flash_ref_masks_keys_past_seq_len():
    """``seq_len`` masks the padded tail's keys, as in the JAX oracle."""
    q, k, v = flash_case(1, 40, 2, 1, 16, seed=2)
    args_t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    args_j = [jnp.moveaxis(jnp.asarray(a), 2, 1) for a in (q, k, v)]
    for causal in (True, False):
        _close(t_ref(*args_t, scale=0.25, causal=causal, seq_len=29),
               j_ref(*args_j, scale=0.25, causal=causal, seq_len=29))


def test_flash_ops_cpu_is_plain_version():
    """On a CPU tensor the wrapper runs the plain version and never
    touches the kernel (whose launch count stays put)."""
    q, k, v = (torch.from_numpy(a) for a in flash_case(2, 40, 4, 2, 16))
    before = flash_attention_fwd.launches
    out = t_ops.flash_attention(q, k, v, window=8, attn_softcap=20.0)
    ref = t_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                scale=16 ** -0.5, window=8, softcap=20.0).transpose(1, 2)
    assert torch.equal(out, ref)
    assert flash_attention_fwd.launches == before


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_flash_branch_on_cpu_vs_jax(use_pallas):
    """The model's ``attention`` under the flash condition (Q == K > 1,
    causal, no kv_len) takes the plain path on the CPU whatever
    ``use_pallas`` says, and matches the JAX package's (which takes its
    Pallas kernel with ``use_pallas``)."""
    q, k, v = flash_case(2, 48, 4, 2, 16, seed=3)
    kw = dict(window=12, attn_softcap=25.0, scale=0.2, use_pallas=use_pallas)
    before = flash_attention_fwd.launches
    t = ta.attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    j = ja.attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    _close(t, j, atol=2e-5)
    assert flash_attention_fwd.launches == before


def _launcher_args(B=2, S=8, Hq=4, Hkv=2, D=16):
    return dict(q=torch.zeros(B, Hq, S, D), k=torch.zeros(B, Hkv, S, D),
                v=torch.zeros(B, Hkv, S, D))


@pytest.mark.parametrize("bad,exc,match", [
    (dict(q=torch.zeros(2, 4, 8)), ValueError, "q must be"),
    (dict(v=torch.zeros(2, 2, 8, 8)), ValueError, "q must be"),
    (dict(k=torch.zeros(2, 2, 9, 16), v=torch.zeros(2, 2, 9, 16)),
     ValueError, "do not match"),
    (dict(q=torch.zeros(2, 3, 8, 16)), ValueError, "multiple of"),
    (dict(q=torch.zeros(2, 4, 8, 12), k=torch.zeros(2, 2, 8, 12),
          v=torch.zeros(2, 2, 8, 12)), ValueError, "head dim 12"),
    (dict(q=torch.zeros(2, 4, 8, 264), k=torch.zeros(2, 2, 8, 264),
          v=torch.zeros(2, 2, 8, 264)), ValueError, "head dim 264"),
    (dict(q=torch.zeros(2, 4, 8, 16, dtype=torch.float16)), TypeError,
     "float32/bfloat16"),
    (dict(), ValueError, "CUDA"),
], ids=["q-rank", "kv-shape", "kv-length", "gqa", "d-not-8", "d-too-big",
        "dtype", "cpu-tensor"])
def test_flash_kernel_launcher_rejects_what_it_does_not_take(bad, exc,
                                                             match):
    """The launcher refuses shapes, types and devices the kernel does not
    take before it builds anything (so this runs without a card)."""
    args = _launcher_args()
    args.update(bad)
    with pytest.raises(exc, match=match):
        flash_attention_fwd(**args, scale=1.0)


def test_flash_kernel_shared_memory():
    """bf16 (the wgmma route): 64 x 64 tiles, 1 KB to align the 128-byte
    swizzle atoms, then Q and two ring stages of K and V, each ceil(D/64)
    panels of 64 rows x 128 bytes: 81 KB at D = 128 (two blocks per SM),
    161 KB at D = 256.  f32 (CUDA cores): Q and K tiles transposed with a
    padding column, the V tile and the probability tile, 64 x 32 tiles at
    D <= 128 (75 KB at D = 128, three blocks per SM), 32 x 32 above.
    Always under the 227 KB limit."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tiles(128, bf16) == tiles(256, bf16) == (64, 64)
    assert smem_bytes(128, bf16) == 1024 + 5 * 2 * 64 * 128 == 82_944
    assert smem_bytes(80, bf16) == smem_bytes(128, bf16)
    assert smem_bytes(40, bf16) == 1024 + 5 * 64 * 128
    assert 2 * smem_bytes(128, bf16) < 228 * 1024
    assert smem_bytes(256, bf16) == 1024 + 5 * 4 * 64 * 128 < 232_448
    assert tiles(128) == (64, 32) and tiles(256) == (32, 32)
    assert smem_bytes(128) == 4 * (128 * 65 + 128 * 33 + 32 * 128 + 64 * 33)
    assert 3 * smem_bytes(128, f32) < 228 * 1024
    assert smem_bytes(256) < 232_448
