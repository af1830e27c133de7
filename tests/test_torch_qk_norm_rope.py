"""The port's fused qk-norm-RoPE against the JAX composition it replaces
(``repro.models.layers.rms_norm`` of q and k, when the config has a
qk-norm, then ``apply_rope``), on the CPU, with numpy inputs from a seed:
every case of ``kernels/rmsnorm/cases.py::QK_ROPE_CASES`` (positions
[B, S], [S] and [1]; D 128, 80, 64, 20 and 6; with and without the
qk-norm).  f32 at 1e-6, bf16 within one bf16 ulp.  The card-side checks
(the kernel against this plain version, and bit-equal to the unfused
card sequence) are in test_torch_gpu.py; the fused row norms are in
test_torch_fused_norm.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.kernels.rmsnorm.cases import (QK_ROPE_CASES, QK_ROPE_THETA,
                                               qk_rope_case)
from repro_torch.kernels.rmsnorm.ref import qk_norm_rope_ref
from repro_torch.models import layers as tl

torch.set_num_threads(1)
EPS = 1e-6


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _f32_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                               rtol=1e-6)


def _within_one_ulp(t, j):
    assert t.dtype == torch.bfloat16
    j = np.asarray(j, np.float32)
    diff = np.abs(t.float().numpy() - j)
    assert np.all(diff <= _bf16_ulp(j)), diff.max()


def _jax_qk_rope(q, k, wq, wk, pos, dtype=jnp.float32, wdtype=jnp.float32):
    """``rms_norm`` then ``apply_rope``, op by op, of q's and k's heads
    side by side (both act on each head alone, so this is the same as
    two calls, at half the per-shape compiles)."""
    Hq = q.shape[2]
    x = jnp.asarray(np.concatenate([q, k], axis=2), dtype)
    if wq is not None:
        B, S, H, D = x.shape
        w = np.concatenate([np.broadcast_to(wq, (Hq, D)),
                            np.broadcast_to(wk, (H - Hq, D))])
        x = jl.rms_norm(x, jnp.asarray(w, wdtype), EPS)
    x = jl.apply_rope(x, jnp.asarray(pos), QK_ROPE_THETA)
    return x[:, :, :Hq], x[:, :, Hq:]


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


#: the cases at served positions; the "fused-qkv" ones differ from a dense
#: case only in their layout on the card (the CPU inputs are dense)
_SERVED = [c for c in QK_ROPE_CASES if c[2] != "far" and c[4] == "dense"]


@pytest.mark.parametrize("case", _SERVED, ids=[c[0] for c in _SERVED])
def test_qk_norm_rope_plain_matches_jax_f32(case):
    _, dims, positions, norm, _ = case
    q, k, wq, wk, pos = qk_rope_case(dims, positions, norm, seed=11)
    tq, tk = qk_norm_rope_ref(_t(q), _t(k), _t(wq), _t(wk),
                              torch.from_numpy(pos), QK_ROPE_THETA, EPS)
    jq, jk = _jax_qk_rope(q, k, wq, wk, pos)
    assert tq.shape == q.shape and tk.shape == k.shape
    _f32_close(tq, jq)
    _f32_close(tk, jk)


def test_qk_norm_rope_plain_at_far_positions_follows_the_frequencies():
    """Past position 100,000 (the card's slow cos/sin argument reduction)
    the comparison also carries the frequencies' own difference: the
    port's ``rope_freqs`` and the JAX package's differ in at most one of
    the 64 (by at most one f32 ulp), and an angle is the position times
    it.  So the outputs are held to 1e-6 plus position x that difference
    x |x|; at the served positions (a few hundred) that term is below
    1e-8, and the test above holds them at 1e-6."""
    _, dims, positions, norm, _ = {c[0]: c for c in QK_ROPE_CASES}[
        "far-positions"]
    q, k, wq, wk, pos = qk_rope_case(dims, positions, norm, seed=11)
    tf = tl.rope_freqs(dims[-1], QK_ROPE_THETA).numpy()
    jf = np.asarray(jl.rope_freqs(dims[-1], QK_ROPE_THETA))
    gap = np.abs(tf - jf)
    assert (gap > 0).sum() <= 1
    assert np.all(gap <= np.spacing(np.abs(jf)))
    tq, tk = qk_norm_rope_ref(_t(q), _t(k), _t(wq), _t(wk),
                              torch.from_numpy(pos), QK_ROPE_THETA, EPS)
    jq, jk = _jax_qk_rope(q, k, wq, wk, pos)
    for t, j in ((tq, jq), (tk, jk)):
        j = np.asarray(j)
        atol = 1e-6 + float(pos.max()) * gap.max() * np.abs(j).max()
        np.testing.assert_allclose(t.numpy(), j, atol=atol, rtol=1e-6)


@pytest.mark.parametrize("w_bf16", [True, False])
@pytest.mark.parametrize("name", ["qwen3-paged-decode", "qwen3-dense-decode",
                                  "zamba2-d80-prefill"])
def test_qk_norm_rope_plain_matches_jax_bf16_within_one_ulp(name, w_bf16):
    _, dims, positions, norm, _ = {c[0]: c for c in QK_ROPE_CASES}[name]
    q, k, wq, wk, pos = qk_rope_case(dims, positions, norm, seed=12)
    wdt = (torch.bfloat16, jnp.bfloat16) if w_bf16 else (torch.float32,
                                                          jnp.float32)
    tq, tk = qk_norm_rope_ref(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(wq, wdt[0]), _t(wk, wdt[0]),
                              torch.from_numpy(pos), QK_ROPE_THETA, EPS)
    jq, jk = _jax_qk_rope(q, k, wq, wk, pos, jnp.bfloat16, wdt[1])
    _within_one_ulp(tq, jq)
    _within_one_ulp(tk, jk)
