"""The port's core layers against the JAX package's, on the same numpy
inputs (f32, CPU, atol 1e-5: both sides compute in f32, so only the
order of a few sums and the transcendental implementations differ)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(1)
ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("shape", [(4, 16), (2, 3, 64)])
def test_rms_norm(shape):
    r = _rng(1)
    x = r.normal(0, 2, shape).astype(np.float32)
    w = r.normal(1, 0.1, shape[-1:]).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = _rng(2).normal(0, 40, (3, 17)).astype(np.float32)
    _close(tl.softcap(torch.from_numpy(x), cap),
           jl.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_activation(kind):
    x = _rng(3).normal(0, 3, (5, 33)).astype(np.float32)
    _close(tl.activation(torch.from_numpy(x), kind),
           jl.activation(jnp.asarray(x), kind))


def test_activation_rejects_unknown():
    with pytest.raises(ValueError):
        tl.activation(torch.zeros(2), "relu")


@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (128, 1_000_000.0)])
def test_rope_freqs(hd, theta):
    _close(tl.rope_freqs(hd, theta), jl.rope_freqs(hd, theta), atol=1e-7)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope(batched):
    r = _rng(4)
    B, S, H, D = 2, 7, 3, 16
    x = r.normal(0, 1, (B, S, H, D)).astype(np.float32)
    pos = (r.integers(0, 200, (B, S)) if batched
           else np.arange(5, 5 + S)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    r = _rng(5)
    d, f = 24, 40
    x = r.normal(0, 1, (2, 3, d)).astype(np.float32)
    wg, wu = (r.normal(0, d ** -0.5, (d, f)).astype(np.float32)
              for _ in range(2))
    wo = r.normal(0, f ** -0.5, (f, d)).astype(np.float32)
    t = tl.mlp(*(torch.from_numpy(a) for a in (x, wg, wu, wo)), act)
    j = jl.mlp(*(jnp.asarray(a) for a in (x, wg, wu, wo)), act)
    _close(t, j)
