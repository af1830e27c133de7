"""The port's dense decode-attention plain version against the JAX
package's, including the JAX Pallas decode kernel in interpret mode (f32,
CPU, atol 1e-5: both sides compute in f32, in a different order).  The
CUDA kernel is held against the plain version by tests/test_torch_gpu.py
(run on a card) and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as j_pallas
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as j_ref
from repro.models import attention as ja
from repro_torch.kernels.decode_attention import ops as t_ops
from repro_torch.kernels.decode_attention.kernel import (
    MAX_SPLITS, decode_attention_fwd, head_tile, smem_bytes, split_plan)
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref as t_ref
from repro_torch.models import attention as ta
from test_torch_gpu import DECODE_CASES, decode_case

torch.set_num_threads(1)
ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_ref_vs_jax_ref_and_pallas(case):
    B, S, Hq, Hkv, D, lens, window, cap = case
    q, kc, vc, ln = decode_case(B, S, Hq, Hkv, D, lens, seed=1)
    kw = dict(window=window, softcap=cap)
    t = t_ref(torch.from_numpy(q).transpose(1, 2), torch.from_numpy(kc),
              torch.from_numpy(vc), torch.from_numpy(ln), scale=D ** -0.5,
              **kw)
    _close(t, j_ref(jnp.moveaxis(jnp.asarray(q), 2, 1), jnp.asarray(kc),
                    jnp.asarray(vc), jnp.asarray(ln), scale=D ** -0.5, **kw))
    # the Pallas kernel itself, in interpret mode (the default off-TPU),
    # with a per-row cache_len (= lens - 1)
    j_ker = j_pallas(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                     jnp.asarray(ln - 1), window=window, attn_softcap=cap,
                     blk_k=32)
    _close(t.transpose(1, 2), j_ker)


@pytest.mark.parametrize("cache_len", [0, 37, 63])
def test_decode_ops_scalar_cache_len_vs_pallas(cache_len):
    """A scalar ``cache_len`` (the index of the current token) broadcasts
    to ``lens = cache_len + 1`` for every row, as in the JAX wrapper; on
    a CPU tensor the wrapper runs the plain version and never touches the
    kernel."""
    q, kc, vc, _ = decode_case(2, 64, 4, 2, 16, [1, 1], seed=2)
    before = decode_attention_fwd.launches
    t = t_ops.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                               cache_len)
    assert decode_attention_fwd.launches == before
    j = j_pallas(*(jnp.asarray(a) for a in (q, kc, vc)), cache_len,
                 blk_k=32)
    _close(t, j)
    lens = torch.full((2,), cache_len + 1, dtype=torch.int32)
    ref = t_ref(torch.from_numpy(q).transpose(1, 2), torch.from_numpy(kc),
                torch.from_numpy(vc), lens, scale=16 ** -0.5)
    assert torch.equal(t, ref.transpose(1, 2))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_decode_attention_on_cpu_vs_jax(use_pallas):
    """The model's ``decode_attention`` runs the plain ``attention`` on
    the CPU whatever ``use_pallas`` says, and matches the JAX package's
    (its XLA path, or its Pallas kernel with ``use_pallas``)."""
    q, kc, vc, _ = decode_case(2, 40, 4, 2, 16, [1, 1], seed=3)
    kw = dict(window=9, attn_softcap=20.0, scale=0.3, use_pallas=use_pallas)
    t = ta.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                            torch.tensor(21, dtype=torch.int32), **kw)
    j = ja.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc)),
                            jnp.asarray(21, jnp.int32), **kw)
    _close(t, j, atol=2e-5)


def _launcher_args(B=2, S=8, Hq=4, Hkv=2, D=16):
    return dict(q=torch.zeros(B, Hq, 1, D),
                k_cache=torch.zeros(B, S, Hkv, D),
                v_cache=torch.zeros(B, S, Hkv, D),
                lens=torch.ones(B, dtype=torch.int32))


@pytest.mark.parametrize("bad,exc,match", [
    (dict(q=torch.zeros(2, 4, 2, 16)), ValueError, "q must be"),
    (dict(v_cache=torch.zeros(2, 8, 2, 8)), ValueError, "caches must"),
    (dict(k_cache=torch.zeros(3, 8, 2, 16), v_cache=torch.zeros(3, 8, 2, 16)),
     ValueError, "caches must"),
    (dict(q=torch.zeros(2, 3, 1, 16)), ValueError, "multiple of"),
    (dict(q=torch.zeros(2, 4, 1, 12), k_cache=torch.zeros(2, 8, 2, 12),
          v_cache=torch.zeros(2, 8, 2, 12)), ValueError, "head dim 12"),
    (dict(lens=torch.ones(3, dtype=torch.int32)), ValueError, "lens must"),
    (dict(q=torch.zeros(2, 4, 1, 16, dtype=torch.float16)), TypeError,
     "float32/bfloat16"),
    (dict(lens=torch.ones(2, dtype=torch.int64)), TypeError, "int32"),
    (dict(), ValueError, "CUDA"),
], ids=["q-rank", "cache-shape", "cache-batch", "gqa", "d-not-8",
        "lens-shape", "dtype", "lens-dtype", "cpu-tensor"])
def test_decode_kernel_launcher_rejects_what_it_does_not_take(bad, exc,
                                                              match):
    """The launcher refuses shapes, types and devices the kernel does not
    take before it builds anything (so this runs without a card)."""
    args = _launcher_args()
    args.update(bad)
    with pytest.raises(exc, match=match):
        decode_attention_fwd(**args, scale=1.0)


def test_decode_kernel_shared_memory():
    """Per block, in fp32: the 4 warps' partial (acc, max, sum) for a head
    tile of 1, 2, 4 or 8 heads, then the block's partial, which the
    cluster reads.  K and V are never staged in shared memory, so the main
    path's G=2, D=128 takes 5.2 KB and the largest (G >= 5, D=256) 40.3
    KB, under the 48 KB default in every case."""
    assert [head_tile(g) for g in (1, 2, 3, 4, 5, 8, 16)] == \
        [1, 2, 4, 4, 8, 8, 8]
    assert smem_bytes(2, 128) == 4 * (4 * 2 * 128 + 2 * 4 * 2 + 2 * 128
                                      + 2 * 2) == 5200
    assert smem_bytes(16, 256) == smem_bytes(8, 256) == 41_280
    assert max(smem_bytes(g, d) for g in range(1, 17)
               for d in range(8, 257, 8)) < 48 * 1024


@pytest.mark.parametrize("S,splits,tokens", [
    (1, 1, 1), (32, 1, 32), (33, 2, 17), (64, 2, 32), (161, 6, 27),
    (256, 8, 32), (1100, 8, 138), (4096, 8, 512)])
def test_decode_split_plan_depends_only_on_S(S, splits, tokens):
    """``min(8, ceil(S / 32))`` blocks per (kv head, row), one cluster of
    as many blocks, each over ceil(S / splits) slots: the same for any B,
    Hkv or G, since the launcher never reads ``lens`` back."""
    plans = {split_plan(S, B, Hkv)[:3] for B in (1, 3, 8) for Hkv in (1, 4)}
    assert plans == {(splits, splits, tokens)}
    assert 1 <= splits <= MAX_SPLITS
    assert splits * tokens >= S > (splits - 1) * tokens


def test_decode_split_plan_fills_the_card_at_the_served_shapes():
    """At least one block per SM (132 on an H100) at the dense paths'
    decode: qwen3 (B 8, Hkv 8) 384, qwen3-moe (Hkv 4, G 8) 192, zamba2's
    shared attention (Hkv 32) 1,536, all with a 161-slot cache."""
    blocks = {name: split_plan(161, 8, hkv).blocks for name, hkv in
              (("qwen3", 8), ("qwen3-moe", 4), ("zamba2", 32))}
    assert blocks == {"qwen3": 384, "qwen3-moe": 192, "zamba2": 1536}
    assert min(blocks.values()) >= 132
