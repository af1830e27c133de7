"""The paged-prefill kernel's CPU side: its plain version against the JAX
package's chunk path (the page gather of ``models/model.py::
_paged_attn_block`` with ``chunk_attend``, then its ``attention``; f32,
1e-5) on every CPU case of ``kernels/paged_prefill/cases.py`` (ragged
starts, partial final chunks, rows that are not prefilling, G 1, 2, 4,
7 and 8, a row whose length ends on a page edge and one a token past
it, softcap); the model's CPU route, bit for bit the gather-and-attend it
replaced; the launcher's checks and plan; and the host arithmetic of the
slots a launch reads (``read_slots``), which the paged backend counts on
the card.  The CUDA kernel is held against the plain version by
tests/test_torch_gpu.py (on a card) and by ``chip_smoke.py`` phase 35."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import gather_pages as j_gather
from repro.models import attention as ja
from repro_torch.kernels.paged_attention.ref import gather_pages
from repro_torch.kernels.paged_prefill import ops as t_ops
from repro_torch.kernels.paged_prefill.cases import (CARD_CASES, CASES,
                                                     TIMED, kv_lens,
                                                     live_mask, prefill_case)
from repro_torch.kernels.paged_prefill.kernel import (MAX_SMEM,
                                                      paged_prefill_fwd,
                                                      read_slots,
                                                      smem_bytes, tiles)
from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref
from repro_torch.models import attention as ta
from repro_torch.obs.spans import COUNTERS

torch.set_num_threads(1)
ATOL = 1e-5


def _torch(arrs):
    q, kp, vp, table, st, ln = arrs
    return (torch.from_numpy(q), torch.from_numpy(kp[0]),
            torch.from_numpy(vp[0]), torch.from_numpy(table),
            torch.from_numpy(st), torch.from_numpy(ln))


def _jax_chunk_path(q, kp, vp, table, st, ln, C, cap):
    """The JAX package's chunk attention as ``_paged_attn_block`` runs it:
    the gather of every row's whole table, then ``attention`` at the
    chunk's positions with ``kv_len``."""
    kd = j_gather(jnp.asarray(kp[0]), jnp.asarray(table))
    vd = j_gather(jnp.asarray(vp[0]), jnp.asarray(table))
    positions = jnp.asarray(st)[:, None] + jnp.arange(C, dtype=jnp.int32)
    return ja.attention(
        jnp.asarray(q), kd, vd, causal=True, q_positions=positions,
        k_positions=jnp.arange(kd.shape[1]), kv_len=jnp.asarray(ln),
        attn_softcap=cap, scale=q.shape[-1] ** -0.5, use_pallas=False,
        f32_logits=True)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_paged_prefill_ref_vs_jax_chunk_path(case):
    _, shape, cap = case
    arrs = prefill_case(*shape, seed=1)
    q, kp, vp, table, st, ln = _torch(arrs)
    t = paged_prefill_ref(q, kp, vp, table, st, ln, scale=shape[4] ** -0.5,
                          softcap=cap)
    j = _jax_chunk_path(*arrs, C=shape[5], cap=cap)
    # every row, those that are not prefilling too (both average them)
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f32_logits", [True, False])
@pytest.mark.parametrize("case", CASES[:3] + CASES[5:6],
                         ids=[c[0] for c in CASES[:3] + CASES[5:6]])
def test_cpu_route_is_the_gather_and_attend_bit_for_bit(case, dtype,
                                                        f32_logits):
    """On a CPU tensor ``paged_prefill_attention`` is the chunk path it
    replaced (the gather, then ``attention`` at ``start + i``), bit for
    bit, counts the gathered slots and launches nothing; ``start`` may be
    a strided view, as the model passes ``positions[:, 0]``."""
    _, shape, cap = case
    q, kp, vp, table, st, ln = _torch(prefill_case(*shape, seed=2))
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    C = q.shape[1]
    positions = st[:, None] + torch.arange(C, dtype=torch.int32)[None, :]
    kd, vd = gather_pages(kp, table), gather_pages(vp, table)
    want = ta.attention(q, kd, vd, causal=True, q_positions=positions,
                        k_positions=torch.arange(kd.shape[1]), kv_len=ln,
                        attn_softcap=cap, scale=0.3, f32_logits=f32_logits)
    launches = paged_prefill_fwd.launches
    before = COUNTERS.counters.get("attn.kv_gathered", 0)
    got = ta.paged_prefill_attention(q, kp, vp, table, positions[:, 0], ln,
                                     attn_softcap=cap, scale=0.3,
                                     f32_logits=f32_logits)
    assert torch.equal(got, want)
    assert COUNTERS.counters["attn.kv_gathered"] - before == \
        table.shape[0] * table.shape[1] * kp.shape[1]
    assert paged_prefill_fwd.launches == launches


def test_ops_cpu_is_the_plain_version():
    """On a CPU tensor the op runs the plain version and never touches
    the kernel (whose launch count stays put)."""
    _, shape, cap = CASES[5]
    q, kp, vp, table, st, ln = _torch(prefill_case(*shape, seed=3))
    launches = paged_prefill_fwd.launches
    out = t_ops.paged_prefill(q, kp, vp, table, st, ln, attn_softcap=cap)
    ref = paged_prefill_ref(q, kp, vp, table, st, ln,
                            scale=shape[4] ** -0.5, softcap=cap)
    assert torch.equal(out, ref)
    assert paged_prefill_fwd.launches == launches


def _args(**over):
    q, kp, vp, table, st, ln = _torch(prefill_case(
        2, 4, 4, 2, 16, 8, [0, 3], [8, 5], None))
    args = dict(q=q, k_pool=kp, v_pool=vp, table=table, start=st,
                kv_lens=ln)
    args.update(over)
    return args


def test_launcher_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill_fwd(**_args(), scale=1.0)


@pytest.mark.parametrize("bad,exc,match", [
    (dict(q=torch.zeros(2, 8, 16)), ValueError, r"\[B, C, Hq, D\]"),
    (dict(k_pool=torch.zeros(9, 4, 2, 8)), ValueError, "pools must both"),
    (dict(q=torch.zeros(2, 8, 3, 16)), ValueError, "multiple of Hkv"),
    (dict(table=torch.zeros(3, 2, dtype=torch.int32)), ValueError,
     "table must be"),
    (dict(start=torch.zeros(3, dtype=torch.int32)), ValueError,
     "start must be"),
    (dict(kv_lens=torch.zeros(2, dtype=torch.int64)), TypeError, "int32"),
    (dict(q=torch.zeros(2, 8, 4, 16, dtype=torch.float16)), TypeError,
     "float32/bfloat16"),
])
def test_launcher_rejects_what_it_does_not_take(bad, exc, match):
    with pytest.raises(exc, match=match):
        paged_prefill_fwd(**_args(**bad), scale=1.0)


def test_launcher_refuses_a_head_dim_it_cannot_tile():
    q, kp, vp = (torch.zeros(s) for s in
                 ((1, 4, 2, 12), (3, 4, 1, 12), (3, 4, 1, 12)))
    with pytest.raises(ValueError, match="head dim 12"):
        paged_prefill_fwd(q, kp, vp, torch.zeros(1, 2, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32), scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 48, 112, 128, 256])
def test_every_head_dim_fits_a_block(D, dtype):
    """A block's shared memory fits the card at every head dim the
    launcher takes; bf16 tiles are wgmma's 64 x 64."""
    assert smem_bytes(D, dtype) <= MAX_SMEM
    assert tiles(D, torch.bfloat16) == (64, 64)


@pytest.mark.parametrize("starts,chunk_lens,page,want", [
    ([0, 16, 31, 0], [16, 16, 2, 0], 16, 16 + 32 + 48),
    ([0], [1], 16, 16),
    ([32, 0, 0], [16, 0, 0], 16, 48),            # a page edge: 48 slots
    ([32, 0], [17, 0], 16, 64),                  # a token past it: 64
    ([640, 0, 700], [32, 0, 5], 16, 672 + 720),
    ([5, 9], [3, 0], 4, 8),                      # a row without a chunk
    ([], [], 16, 0),
])
def test_read_slots_counts_each_prefilling_rows_live_pages(starts,
                                                           chunk_lens,
                                                           page, want):
    assert read_slots(np.asarray(starts, np.int32),
                      np.asarray(chunk_lens, np.int32), page) == want


def test_read_slots_is_the_live_pages_of_the_cases():
    """``read_slots`` equals the slots of the pages each case's table
    holds for its prefilling rows (``live_mask`` rounded up to pages)."""
    for _, shape, _ in CARD_CASES:
        B, page, *_, starts, chunk_lens, maxp = shape
        ln = kv_lens(starts, chunk_lens)
        want = sum(-(-int(n) // page) * page
                   for n, c in zip(ln, chunk_lens) if c > 0)
        assert read_slots(starts, chunk_lens, page) == want


def test_live_mask_marks_each_attended_slot_once():
    q, kp, vp, table, st, ln = prefill_case(3, 4, 4, 2, 8, 8, [0, 0, 5],
                                            [7, 0, 6], None)
    live = live_mask(table, ln, 4, kp.shape[1])
    assert live.sum() == 7 + 11
    assert not live[0].any()                     # the scratch page


def test_timed_launches_are_the_chat_and_qwen3_chunk_calls():
    assert [p for p, _, _ in TIMED] == ["qwen3-moe chat call",
                                        "qwen3 chunk 128"]
    for _, (B, page, Hq, Hkv, D, C, starts, chunk_lens, maxp), L in TIMED:
        assert len(starts) == len(chunk_lens) == B
        assert max(np.asarray(starts) + np.asarray(chunk_lens)) \
            <= maxp * page
