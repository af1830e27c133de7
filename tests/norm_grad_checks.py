"""Shared by the RMSNorm backward tests (test_torch_rmsnorm_grad.py,
test_torch_gated_norm_grad.py, test_torch_qk_norm_rope_grad.py): inputs
from a seed, ``jax.vjp`` under ``jit`` (one compile per case), torch
autograd, and the comparison with its stated bounds.

Bounds.  An input gradient (dx, dy, dz, dq, dk) in f32: ``|d| <= 1e-6 *
max(1, max|ref|)`` (the same fp32 arithmetic, row sums taken in another
order).  A weight gradient (dw, dwq, dwk) is a sum over every row, so in
f32 the bound is ``1e-6 * sum over rows of |dy * xhat|``, the scale of
that sum's rounding error (an f32 sum of n terms in another order moves
by up to about n * 6e-8 of it).  In bf16 each side rounds an fp32 result
that agrees to the f32 bound above, so ``ulps`` bf16 ulps at the
reference's value plus that f32 floor: ``ulps`` is 1 where the result is
one rounding of an fp32 value (rmsnorm's dx and dw, every dw) and one
more for each rounding to bf16 upstream of it whose 1-ulp flip the
result carries (qk-norm's gradient of the normed head, then the norm: 2;
the gate's dg, ds, then dy or dz: 4); the add's dx + dr, which may
cancel, one ulp of the sum plus one of the norm's rounded dx.  The gated
norm against JAX in bf16 is held at the card's bf16 tolerance, 2e-2 of
``max|ref|``: JAX rounds ``silu`` and its gradient at each of its bf16
ops, where the port holds fp32 between the forward's rounding points
(measured up to 1.25e-2, as far from the f32 gradient as JAX's own bf16
result is).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.kernels.rmsnorm.cases import RMSNORM_CASES, rmsnorm_case

EPS = 1e-6
DENSE = [c for c in RMSNORM_CASES if c[2] == "dense"]
DENSE_IDS = [c[0] for c in DENSE]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def close(t: torch.Tensor, j, dtype: str, ulps: int = 1, terms=None,
          rel: float = 0.0, rel_floor: float = 0.0, carried=None) -> None:
    """``t`` (the port) against ``j`` (the reference) under the module's
    bounds; ``terms``: sum over rows of |dy * xhat| for a weight
    gradient; ``rel``: a bound of ``rel * max(rel_floor, max|ref|)``
    instead; ``carried``: a bf16 value rounded upstream whose 1-ulp flip
    the result carries in full (a summand of a sum that may cancel)."""
    t = t.float().numpy()
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = float(np.abs(j).max())
    diff = np.abs(t - j)
    if rel:
        bound = rel * max(rel_floor, scale)
        assert diff.max() <= bound, (diff.max(), bound)
        return
    floor = 1e-6 * (max(1.0, scale) if terms is None else float(terms))
    if dtype == "f32":
        assert diff.max() <= floor, (diff.max(), floor)
    else:
        excess = diff - ulps * bf16_ulp(j)
        if carried is not None:
            excess = excess - bf16_ulp(carried.float().numpy())
        assert excess.max() <= floor, (excess.max(), floor)


def dw_terms(dy: torch.Tensor, x: torch.Tensor, eps: float = EPS) -> float:
    """sum over rows of |dy * xhat| (the scale of dw's f32 sum)."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return float((dy.float() * xf * rstd).abs().sum())


def draws(shape, n, seed):
    """n draws of ``rmsnorm_case`` of ``shape`` (dense), and its w."""
    xs = [rmsnorm_case(shape, seed=seed + 1000 * i)[0] for i in range(n)]
    return xs, rmsnorm_case(shape, seed=seed)[1]


def both(dtype, *arrays):
    """The arrays as JAX and as torch values in ``dtype`` (None stays)."""
    jdt, tdt = DTYPES[dtype]
    return ([None if a is None else jnp.asarray(a).astype(jdt)
             for a in arrays],
            [None if a is None else torch.from_numpy(a).to(tdt)
             for a in arrays])


def jax_vjp(fn, primals, cotangent, jit: bool = True):
    """``jax.vjp(fn, *primals)[1](cotangent)``, under one ``jit`` (one
    compile per case) or, with ``jit=False``, op by op (XLA's fused code
    computes RoPE's angles and cos/sin otherwise than its op-by-op code,
    which the port's forward matches to 1e-6)."""
    if not jit:
        return jax.vjp(fn, *primals)[1](cotangent)
    return jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(tuple(primals),
                                                       cotangent)


def autograd(fn, args, cots):
    """torch.autograd of ``fn(*args)`` with cotangents ``cots``: the
    gradients of the args (None for an arg that is None)."""
    leaves = [None if a is None else a.clone().requires_grad_(True)
              for a in args]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, cots)
    return [None if a is None else a.grad for a in leaves]
