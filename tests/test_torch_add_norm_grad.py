"""The plain version of the fused add + RMSNorm backward kernel
(``add_rmsnorm_bwd_ref``: the gradient of x and of delta is dr + the
norm's dx at r = x + delta, dx rounded to r's dtype first as torch's add
takes it) against ``jax.vjp`` of ``x + delta`` then
``repro.models.layers.rms_norm`` (both outputs with a cotangent) and
against ``torch.autograd`` of the port's plain forward, on the CPU, on
every dense case of ``kernels/rmsnorm/cases.py`` in f32 and bf16 (bounds:
``norm_grad_checks.py``; the card-side kernel checks are in
test_torch_gpu.py)."""
import pytest
import torch

from norm_grad_checks import (DENSE, DENSE_IDS, DTYPES, EPS, autograd, both,
                              close, draws, dw_terms, jax_vjp)
from repro.models import layers as jl
from repro_torch.kernels.rmsnorm import ref as R

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", DENSE, ids=DENSE_IDS)
def test_add_rmsnorm_bwd_plain_matches_jax(case, dtype):
    (x, d, dh, dr), w = draws(case[1], 4, seed=13)
    (jx, jd, jdh, jdr, jw), (tx, td, tdh, tdr, tw) = both(dtype, x, d, dh,
                                                          dr, w)

    def composition(a, b, ww):
        r = a + b
        return jl.rms_norm(r, ww, EPS), r
    gx, gd, gw = jax_vjp(composition, (jx, jd, jw), (jdh, jdr))
    tg, tdw = R.add_rmsnorm_bwd_ref(tdh, tdr, tx + td, tw, EPS)
    # under jit XLA fuses x + delta into the norm and the two cotangents'
    # add into its backward, rounding neither r nor the norm's gradient
    # to bf16 as eager torch (and the kernel, to match it) does: bf16 at
    # 1e-2 of max|ref| (the card's bf16 tolerance is 2e-2)
    rel = 1e-2 if dtype == "bf16" else 0.0
    close(tg, gx, dtype, rel=rel)
    close(tg, gd, dtype, rel=rel)
    close(tdw, gw, dtype, terms=dw_terms(tdh, tx + td), rel=rel)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", DENSE, ids=DENSE_IDS)
def test_add_rmsnorm_bwd_plain_matches_autograd(case, dtype):
    (x, d, dh, dr), w = draws(case[1], 4, seed=14)
    _, (tx, td, tdh, tdr, tw) = both(dtype, x, d, dh, dr, w)
    gx, gd, gw = autograd(lambda a, b, c: R.add_rmsnorm_ref(a, b, c, EPS),
                          (tx, td, tw), (tdh, tdr))
    tg, tdw = R.add_rmsnorm_bwd_ref(tdh, tdr, tx + td, tw, EPS)
    dx = R.rmsnorm_bwd_ref(tdh, tx + td, tw, EPS)[0]
    close(tg, gx.float().numpy(), dtype, carried=dx)
    close(tg, gd.float().numpy(), dtype, carried=dx)
    close(tdw, gw.float().numpy(), dtype, terms=dw_terms(tdh, tx + td))
    # with no gradient on r, the norm's alone
    tg0, _ = R.add_rmsnorm_bwd_ref(tdh, None, tx + td, tw, EPS)
    assert torch.equal(tg0, R.rmsnorm_bwd_ref(tdh, tx + td, tw, EPS)[0])
