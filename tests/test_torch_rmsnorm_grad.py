"""The plain version of the RMSNorm backward kernel (``rmsnorm_bwd_ref`` in
``kernels/rmsnorm/ref.py``: the formula the CUDA backward kernel
computes) against ``jax.vjp`` of the JAX
package's compositions and against ``torch.autograd`` of the port's plain
forwards, on the CPU, with numpy inputs and cotangents from a seed, on
every dense case of ``kernels/rmsnorm/cases.py`` in f32 and bf16 (the
bounds are ``norm_grad_checks.py``'s; the card-side kernel checks are in
test_torch_gpu.py):

``rmsnorm_bwd`` against ``repro.models.layers.rms_norm``; the add's
backward is in test_torch_add_norm_grad.py, which keeps each file's time
down.
"""
import pytest
import torch

from norm_grad_checks import (DENSE, DENSE_IDS, DTYPES, EPS, autograd, both,
                              close, draws, dw_terms, jax_vjp)
from repro.models import layers as jl
from repro_torch.kernels.rmsnorm import ref as R

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", DENSE, ids=DENSE_IDS)
def test_rmsnorm_bwd_plain_matches_jax(case, dtype):
    (x, dy), w = draws(case[1], 2, seed=11)
    (jx, jdy, jw), (tx, tdy, tw) = both(dtype, x, dy, w)
    jdx, jdw = jax_vjp(lambda a, b: jl.rms_norm(a, b, EPS), (jx, jw), jdy)
    tdx, tdw = R.rmsnorm_bwd_ref(tdy, tx, tw, EPS)
    assert tdx.dtype == tx.dtype and tdw.dtype == tw.dtype
    close(tdx, jdx, dtype)
    close(tdw, jdw, dtype, terms=dw_terms(tdy, tx))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", DENSE, ids=DENSE_IDS)
def test_rmsnorm_bwd_plain_matches_autograd(case, dtype):
    (x, dy), w = draws(case[1], 2, seed=12)
    _, (tx, tdy, tw) = both(dtype, x, dy, w)
    gx, gw = autograd(lambda a, b: R.rmsnorm_ref(a, b, EPS), (tx, tw),
                      (tdy,))
    tdx, tdw = R.rmsnorm_bwd_ref(tdy, tx, tw, EPS)
    close(tdx, gx.float().numpy(), dtype)
    close(tdw, gw.float().numpy(), dtype, terms=dw_terms(tdy, tx))
