"""The dense decode's plain version split into M slot ranges and merged
by the log-sum-exp, as the sharded serving steps attend a cache split
over the sequence: ``kernels/decode_attention/ops.py::decode_attention``
on each range (``slot_offset``, ``return_lse``), the partials merged by
``models/tp.py::merge_lse``, equals the whole call within 1e-6 (f32; only
the order of the sums differs), for M in {2, 3, 4, 16}: windows that
leave ranges empty (gemma2's local layers), a softcap, positions past the
cache (the write clamped onto the last slot; one row's window ends
before the cache's last slot, so it attends nothing at all), and rows
whose range holds no valid slot.  A range that attends nothing gives
o = 0 and lse = -inf, never a NaN; a whole row that attends nothing,
the same.  The plain version's lse equals ``torch.logsumexp`` of the
attended logits, and its rows equal the JAX oracle's wherever a row
attends a slot."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import \
    decode_attention_ref as j_ref
from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models.tp import merge_lse

torch.set_num_threads(1)
TOL = 1e-6

#: (B, S, Hq, Hkv, D, positions, window, softcap); S a multiple of every
#: M it is split by
CASES = [
    ("plain", (3, 48, 4, 2, 16, [47, 20, 0], 0, 0.0)),
    ("window-empties-ranges", (2, 48, 4, 2, 16, [47, 30], 8, 0.0)),
    ("softcap", (2, 48, 8, 2, 32, [40, 5], 0, 30.0)),
    ("window-softcap", (2, 48, 4, 1, 16, [44, 17], 12, 50.0)),
    ("past-the-cache", (2, 48, 4, 2, 16, [52, 60], 10, 0.0)),
    ("g1", (2, 48, 4, 4, 16, [3, 47], 0, 0.0)),
]
SPLITS = [2, 3, 4, 16]


def _inputs(B, S, Hq, Hkv, D, seed):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.normal(0, 1, shape).astype(np.float32))
                 for shape in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def merge(parts):
    """``models/tp.py::merge_lse`` (the merge of ``merge_partials``,
    without ranks) over a list of (o [B, 1, Hq, D], lse [B, Hq])."""
    o = torch.stack([p[0][:, 0] for p in parts])
    return merge_lse(o, torch.stack([p[1] for p in parts]))[:, None]


@pytest.mark.parametrize("M", SPLITS)
@pytest.mark.parametrize("name,case", CASES, ids=[c[0] for c in CASES])
def test_ranges_merged_equal_the_whole_call(name, case, M):
    B, S, Hq, Hkv, D, pos, window, cap = case
    q, k, v = _inputs(B, S, Hq, Hkv, D, seed=M)
    pos = torch.tensor(pos, dtype=torch.int32)
    kw = dict(window=window, attn_softcap=cap)
    whole, whole_lse = decode_attention(q, k, v, pos, return_lse=True, **kw)
    Sl = S // M
    parts = [decode_attention(q, k[:, r * Sl:(r + 1) * Sl],
                              v[:, r * Sl:(r + 1) * Sl], pos,
                              slot_offset=r * Sl, return_lse=True, **kw)
             for r in range(M)]
    for o, lse in parts:
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
        empty = lse == -torch.inf                           # [B, Hq]
        assert torch.all(o.transpose(1, 2)[empty] == 0)
    # some ranges attend nothing wherever a window or a short row binds
    if window or int(pos.min()) < S - Sl:
        assert any(bool((p[1] == -torch.inf).any()) for p in parts)
    got = merge(parts)
    assert float((got - whole.float()).abs().max()) <= TOL, (name, M)
    lse_sum = torch.logsumexp(torch.stack([p[1] for p in parts]), 0)
    torch.testing.assert_close(lse_sum, whole_lse, atol=TOL, rtol=0)


def test_lse_is_the_log_sum_exp_of_the_attended_logits():
    B, S, Hq, Hkv, D = 2, 40, 4, 2, 16
    q, k, v = _inputs(B, S, Hq, Hkv, D, seed=7)
    lens = torch.tensor([40, 13], dtype=torch.int32)
    ends = torch.tensor([40, 13], dtype=torch.int32)
    window, cap, scale = 9, 20.0, D ** -0.5
    o, lse = decode_attention_ref(q.transpose(1, 2), k, v, lens,
                                  scale=scale, window=window, softcap=cap,
                                  ends=ends, return_lse=True)
    G = Hq // Hkv
    for b in range(B):
        lo, hi = max(0, int(ends[b]) - window), int(lens[b])
        for h in range(Hq):
            s = (k[b, lo:hi, h // G] @ q[b, 0, h]) * scale
            s = cap * torch.tanh(s / cap)
            assert abs(float(lse[b, h] - torch.logsumexp(s, 0))) <= 1e-5
            want = torch.softmax(s, 0) @ v[b, lo:hi, h // G]
            assert float((o[b, h, 0] - want).abs().max()) <= 1e-5


def test_a_row_that_attends_nothing_is_zero_with_lse_minus_inf():
    """``len == 0`` rows, and a range past a row's end: o = 0 and lse =
    -inf, where the JAX oracle averages the masked values; every other
    row equals the JAX oracle's."""
    B, S, Hq, Hkv, D = 3, 32, 4, 2, 16
    q, k, v = _inputs(B, S, Hq, Hkv, D, seed=3)
    lens = torch.tensor([0, 9, 32], dtype=torch.int32)
    o, lse = decode_attention_ref(q.transpose(1, 2), k, v, lens,
                                  scale=D ** -0.5, return_lse=True)
    assert torch.all(o[0] == 0) and torch.all(lse[0] == -torch.inf)
    assert torch.isfinite(lse[1:]).all()
    want = np.asarray(j_ref(jnp.asarray(q.transpose(1, 2).numpy()),
                            jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                            jnp.asarray(lens.numpy()), scale=D ** -0.5))
    np.testing.assert_allclose(o[1:].numpy(), want[1:], atol=1e-5,
                               rtol=1e-5)
    # the wrapper's range past the row's end: every row empty
    ro, rl = decode_attention(q, k[:, :8], v[:, :8], torch.tensor(
        [3, 5, 7], dtype=torch.int32), slot_offset=24, return_lse=True)
    assert torch.all(ro == 0) and torch.all(rl == -torch.inf)


def test_the_wrapper_shifts_lens_and_ends_by_the_offset_on_the_device():
    """A position given as an int works as a 0-dim int32 tensor does,
    and a CPU call never launches the kernel."""
    q, k, v = _inputs(2, 16, 4, 2, 16, seed=5)
    before = decode_attention_fwd.launches
    pos = torch.tensor(11, dtype=torch.int32)
    a = decode_attention(q, k, v, pos, window=6, slot_offset=8,
                         return_lse=True)
    b = decode_attention(q, k, v, 11, window=6, slot_offset=8,
                         return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # slots 8 + [0, 16): the query at 11, window 6 -> local slots [0, 4)
    want = decode_attention_ref(q.transpose(1, 2), k[:, :4], v[:, :4],
                                torch.tensor([4, 4], dtype=torch.int32),
                                scale=16 ** -0.5, return_lse=True)
    assert torch.allclose(a[0].transpose(1, 2), want[0], atol=1e-6)
    assert torch.allclose(a[1], want[1], atol=1e-6)
    assert decode_attention_fwd.launches == before
