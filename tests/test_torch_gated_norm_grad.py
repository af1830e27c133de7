"""The plain version of the gated RMSNorm backward kernel
(``gated_rmsnorm_bwd_ref``: Mamba2's ``rmsnorm(y * silu(z)) * w``, the
gradient reaching y through silu(z) and z through y * silu'(z)) against
``jax.vjp`` of ``rms_norm(y * jax.nn.silu(z))`` and against
``torch.autograd`` of the port's plain forward, on the CPU, on every
dense case of ``kernels/rmsnorm/cases.py`` in f32 and bf16 (bounds:
``norm_grad_checks.py``; the card-side kernel checks are in
test_torch_gpu.py)."""
import jax
import pytest
import torch

from norm_grad_checks import (DENSE, DENSE_IDS, DTYPES, EPS, autograd, both,
                              close, draws, dw_terms, jax_vjp)
from repro.models import layers as jl
from repro_torch.kernels.rmsnorm import ref as R

torch.set_num_threads(1)


def _gated_product(y, z):
    return y * torch.nn.functional.silu(z)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", DENSE, ids=DENSE_IDS)
def test_gated_rmsnorm_bwd_plain_matches_jax(case, dtype):
    (y, z, dout), w = draws(case[1], 3, seed=15)
    (jy, jz, jdo, jw), (ty, tz, tdo, tw) = both(dtype, y, z, dout, w)
    want = jax_vjp(lambda a, b, c: jl.rms_norm(a * jax.nn.silu(b), c, EPS),
                   (jy, jz, jw), jdo)
    got = R.gated_rmsnorm_bwd_ref(tdo, ty, tz, tw, EPS)
    terms = dw_terms(tdo, _gated_product(ty, tz))
    rel = 2e-2 if dtype == "bf16" else 0.0
    close(got[0], want[0], dtype, rel=rel)
    close(got[1], want[1], dtype, rel=rel)
    close(got[2], want[2], dtype, terms=terms, rel=rel)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", DENSE, ids=DENSE_IDS)
def test_gated_rmsnorm_bwd_plain_matches_autograd(case, dtype):
    (y, z, dout), w = draws(case[1], 3, seed=16)
    _, (ty, tz, tdo, tw) = both(dtype, y, z, dout, w)
    gy, gz, gw = autograd(lambda a, b, c: R.gated_rmsnorm_ref(a, b, c, EPS),
                          (ty, tz, tw), (tdo,))
    dy, dz, dw = R.gated_rmsnorm_bwd_ref(tdo, ty, tz, tw, EPS)
    close(dy, gy.float().numpy(), dtype, ulps=4)
    close(dz, gz.float().numpy(), dtype, ulps=4)
    close(dw, gw.float().numpy(), dtype,
          terms=dw_terms(tdo, _gated_product(ty, tz)))
