"""The plain version of the qk-norm + RoPE backward kernel
(``qk_norm_rope_bwd_ref``: RoPE's transpose, the rotation by the
negative angle, then the per-head norm's backward, dwq and dwk summed
over every (token, head); the rotation alone without weights) against
``jax.vjp`` of ``rms_norm`` then ``apply_rope`` and against
``torch.autograd`` of the port's plain forward, on the CPU, on every
case of ``QK_ROPE_CASES`` with rows, in f32 and bf16 (bounds:
``norm_grad_checks.py``; the card-side kernel checks are in
test_torch_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from norm_grad_checks import DTYPES, EPS, autograd, both, close, dw_terms
from repro.models import layers as jl
from repro_torch.kernels.rmsnorm import ref as R
from repro_torch.kernels.rmsnorm.cases import (QK_ROPE_CASES, QK_ROPE_THETA,
                                               qk_rope_case)

torch.set_num_threads(1)
CASES = [c for c in QK_ROPE_CASES if c[1][0] > 0]
IDS = [c[0] for c in CASES]
#: against JAX under one ``jit`` per case, the positions an argument: XLA's
#: fused cos and sin at angles up to 160 rad differ from the CPU libm's
#: that torch calls by a few ulps of the angle, so f32 is held at
#: ``F32_JIT`` (measured up to 6.3e-6) and bf16 at ``BF16_JIT`` of
#: max|ref| (a flipped rounding of the rotated-back gradient moves dq by
#: an ulp of that gradient); op by op (as test_torch_qk_norm_rope.py holds
#: the forward, at seconds of compiles per case) on ``OP_BY_OP`` at the
#: module's 1e-6 and 2 ulps.  Past position 100,000 the two packages'
#: frequencies differ by an ulp (bounded in test_torch_qk_norm_rope.py),
#: so "far" is held against autograd only.
VS_JAX = [c for c in CASES if c[2] != "far"]
F32_JIT = 1e-5
BF16_JIT = 1e-2
OP_BY_OP = [("qwen3-dense-decode", "f32"), ("zamba2-d80-decode", "f32"),
            ("zamba2-d80-decode", "bf16")]


def _inputs(case, dtype, seed):
    _, dims, positions, norm, _ = case
    q, k, wq, wk, pos = qk_rope_case(dims, positions, norm, seed)
    r = np.random.default_rng(seed + 1)
    dq = r.normal(0, 1, q.shape).astype(np.float32)
    dk = r.normal(0, 1, k.shape).astype(np.float32)
    j, t = both(dtype, q, k, dq, dk, wq, wk)
    return j, t, pos


def _check(got, want, t, dtype, tpos, rel=0.0):
    """dq, dk within 2 ulps (the rotated-back gradient is rounded before
    the norm's backward) or, with ``rel``, ``rel * max(1, max|ref|)``;
    dwq, dwk as weight gradients (with ``rel``, at ten times the f32
    floor: each term carries the angle's error)."""
    tq, tk, tdq, tdk = t[:4]
    assert (got[2] is None) == (want[2] is None)
    for g, w in zip(got[:2], want[:2]):
        if rel:
            close(g, w, dtype, rel=rel, rel_floor=1.0)
        else:
            close(g, w, dtype, ulps=2)
    if got[2] is not None:
        dnq = R.rope_bwd_ref(tdq, tpos, QK_ROPE_THETA)
        dnk = R.rope_bwd_ref(tdk, tpos, QK_ROPE_THETA)
        scale = 10.0 if rel else 1.0
        close(got[2], want[2], dtype, terms=scale * dw_terms(dnq, tq))
        close(got[3], want[3], dtype, terms=scale * dw_terms(dnk, tk))


def _vs_jax(case, dtype, jit):
    (jq, jk, jdq, jdk, jwq, jwk), t, pos = _inputs(case, dtype, seed=17)

    def composition(p, q, k, *w):
        if w:
            q, k = jl.rms_norm(q, w[0], EPS), jl.rms_norm(k, w[1], EPS)
        return (jl.apply_rope(q, p, QK_ROPE_THETA),
                jl.apply_rope(k, p, QK_ROPE_THETA))

    def vjp(p, primals, cots):
        return jax.vjp(lambda *a: composition(p, *a), *primals)[1](cots)
    weights = () if jwq is None else (jwq, jwk)
    run = jax.jit(vjp) if jit else vjp
    want = list(run(jnp.asarray(pos), (jq, jk, *weights), (jdq, jdk)))
    want += [None] * (4 - len(want))
    tpos = torch.from_numpy(pos)
    tq, tk, tdq, tdk, twq, twk = t
    got = R.qk_norm_rope_bwd_ref(tdq, tdk, tq, tk, twq, twk, tpos,
                                 QK_ROPE_THETA, EPS)
    return got, want, t, tpos


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", VS_JAX, ids=[c[0] for c in VS_JAX])
def test_qk_norm_rope_bwd_plain_matches_jax(case, dtype):
    got, want, t, tpos = _vs_jax(case, dtype, jit=True)
    _check(got, want, t, dtype, tpos, rel={"f32": F32_JIT,
                                           "bf16": BF16_JIT}[dtype])


@pytest.mark.parametrize("name,dtype", OP_BY_OP,
                         ids=[f"{n}-{d}" for n, d in OP_BY_OP])
def test_qk_norm_rope_bwd_plain_matches_jax_op_by_op(name, dtype):
    case = {c[0]: c for c in CASES}[name]
    got, want, t, tpos = _vs_jax(case, dtype, jit=False)
    _check(got, want, t, dtype, tpos)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_qk_norm_rope_bwd_plain_matches_autograd(case, dtype):
    _, t, pos = _inputs(case, dtype, seed=18)
    tq, tk, tdq, tdk, twq, twk = t
    tpos = torch.from_numpy(pos)
    want = autograd(
        lambda q, k, wq, wk: R.qk_norm_rope_ref(q, k, wq, wk, tpos,
                                                QK_ROPE_THETA, EPS),
        (tq, tk, twq, twk), (tdq, tdk))
    got = R.qk_norm_rope_bwd_ref(tdq, tdk, tq, tk, twq, twk, tpos,
                                 QK_ROPE_THETA, EPS)
    _check(got, [None if g is None else g.float().numpy() for g in want],
           t, dtype, tpos)
