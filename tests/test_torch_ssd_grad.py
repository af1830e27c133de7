"""The gradient of the plain SSD scan, which the train mode takes on
every device, at a full-size chunk (128, mamba2-780m's).  Above the
diagonal the intra-chunk exponent is a sum of decays that overflows to
inf there; the JAX package's ``where(tri, exp(seg), 0)`` keeps the
values right but its gradient is 0 * inf = NaN, so JAX's mamba2 training
at full size has NaN gradients.  The port masks the exponent before exp:
the same outputs, and a finite gradient equal to the gradient of the
step-by-step recurrence (``ssd_decode_step`` S times), which has no
exponent to overflow.  Bounds: outputs 1e-5 of max(1, max|ref|) (the
same fp32 arithmetic), gradients against the recurrence 1e-4 of it (128
products of decays summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import ssm as j_ssm
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import ssm as t_ssm

torch.set_num_threads(1)


def _inputs(B=1, S=128, H=2, P=4, G=1, N=4, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (B, S, H, P)).astype(np.float32)
    dt = np.full((B, S, H), 0.8, np.float32)
    A = np.asarray([-2.7, -1.3][:H], np.float32)      # exp(1), as A_log 1
    Bm = r.normal(0, 1, (B, S, G, N)).astype(np.float32)
    Cm = r.normal(0, 1, (B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(t, j, tol):
    j = np.asarray(j, np.float32)
    assert np.abs(np.asarray(t, np.float32) - j).max() <= tol * max(
        1.0, float(np.abs(j).max()))


def test_plain_scan_grad_at_a_full_chunk_is_finite_where_jax_is_nan():
    """The gradients of x, dt (through both x * dt and the decays dt * A),
    B and C at one chunk of 128 steps with decays of 2.16 and 1.04 per
    step (A = -exp(1), dt 0.8: the smoke-free mamba2 init's A_log)."""
    x, dt, A, Bm, Cm = _inputs()
    chunk = 128
    cot = np.random.default_rng(1).normal(0, 1, x.shape).astype(np.float32)

    def j_loss(xx, dd, bb, cc):
        y, _ = j_ssm.ssd_chunked(xx * dd[..., None], dd * A, bb, cc,
                                 chunk=chunk)
        return jnp.sum(y * cot)
    jy, _ = j_ssm.ssd_chunked(x * dt[..., None], dt * A, Bm, Cm, chunk=chunk)
    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3))(x, dt, Bm, Cm)
    assert not np.isfinite(np.asarray(jg[1])).all()       # dt: NaN

    At = torch.from_numpy(A)

    def port(xx, dd, bb, cc):
        return ssd_scan_ref(xx * dd[..., None], dd * At, bb, cc,
                            chunk=chunk)[0]
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, dt, Bm, Cm)]
    y = port(*leaves)
    _close(y.detach().numpy(), jy, 1e-5)
    (y * torch.from_numpy(cot)).sum().backward()
    got = [t.grad for t in leaves]
    assert all(torch.isfinite(g).all() for g in got)

    # the step-by-step recurrence, differentiated by autograd
    ref = [torch.from_numpy(a).requires_grad_(True)
           for a in (x, dt, Bm, Cm)]
    state = torch.zeros((1, 2, 4, 4))
    ys = []
    for s in range(x.shape[1]):
        state, y_s = t_ssm.ssd_decode_step(state, ref[0][:, s], ref[1][:, s],
                                           At, ref[2][:, s], ref[3][:, s])
        ys.append(y_s)
    (torch.stack(ys, 1) * torch.from_numpy(cot)).sum().backward()
    for g, r in zip(got, ref):
        _close(g.numpy(), r.grad.numpy(), 1e-4)
