"""The port's fused RMSNorm entry points against the JAX compositions they
replace, on the CPU, with numpy inputs from a seed (the card-side kernel
checks, and the kernels' bit-equality with the unfused card sequence, are
in test_torch_gpu.py):

* ``add_rmsnorm``: ``x + delta`` then ``repro.models.layers.rms_norm``;
* ``gated_rmsnorm``: ``y * jax.nn.silu(z)`` then ``rms_norm``;
* (``qk_norm_rope`` against ``rms_norm`` then ``apply_rope`` is in
  test_torch_qk_norm_rope.py, which keeps each file's time down).

f32 at 1e-6, bf16 within one bf16 ulp of the JAX result (the two
frameworks may round an fp32 result to bf16 from values one f32 rounding
apart).  On the CPU each op is its plain version, which is the eager
sequence the kernel replaces, op for op: bit-equal to the unfused port
functions, so the model computes exactly what it did before the fusion.
The launchers refuse what their kernels do not take before any library is
loaded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as jl
from repro_torch.kernels.rmsnorm import kernel as t_kernel
from repro_torch.kernels.rmsnorm import ops as t_ops
from repro_torch.kernels.rmsnorm.cases import (RMSNORM_CASES, qk_rope_case,
                                               rmsnorm_case)
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_ref, apply_rope,
                                             gated_rmsnorm_ref)
from repro_torch.models import layers as tl

torch.set_num_threads(1)
EPS = 1e-6
_NAMES = [c[0] for c in RMSNORM_CASES]


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _pair(shape, seed):
    """(a, b, w): two draws of ``rmsnorm_case`` (as ``pair_case_on``
    draws them), dense."""
    a, w = rmsnorm_case(shape, seed=seed)
    b, _ = rmsnorm_case(shape, seed=seed + 1000)
    return a, b, w


def _f32_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                               rtol=1e-6)


def _within_one_ulp(t, j):
    assert t.dtype == torch.bfloat16
    j = np.asarray(j, np.float32)
    diff = np.abs(t.float().numpy() - j)
    assert np.all(diff <= _bf16_ulp(j)), diff.max()


# --- add_rmsnorm -------------------------------------------------------------

@pytest.mark.parametrize("case", RMSNORM_CASES, ids=_NAMES)
def test_add_rmsnorm_plain_matches_jax_f32(case):
    _, shape, _ = case
    x, d, w = _pair(shape, seed=7)
    out, r = add_rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(d),
                             torch.from_numpy(w), EPS)
    jr = jnp.asarray(x) + jnp.asarray(d)
    _f32_close(r, jr)
    _f32_close(out, jl.rms_norm(jr, jnp.asarray(w), EPS))


@pytest.mark.parametrize("w_bf16", [True, False])
@pytest.mark.parametrize("shape", [(7, 48), (8, 1, 1024), (3, 2560)])
def test_add_rmsnorm_plain_matches_jax_bf16_within_one_ulp(shape, w_bf16):
    x, d, w = _pair(shape, seed=8)
    wdt = (torch.bfloat16, jnp.bfloat16) if w_bf16 else (torch.float32,
                                                          jnp.float32)
    out, r = add_rmsnorm_ref(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(d).bfloat16(),
                             torch.from_numpy(w).to(wdt[0]), EPS)
    jr = jnp.asarray(x, jnp.bfloat16) + jnp.asarray(d, jnp.bfloat16)
    assert np.array_equal(r.float().numpy(), np.asarray(jr, np.float32))
    _within_one_ulp(out, jl.rms_norm(jr, jnp.asarray(w, wdt[1]), EPS))


# --- gated_rmsnorm -----------------------------------------------------------

@pytest.mark.parametrize("case", RMSNORM_CASES, ids=_NAMES)
def test_gated_rmsnorm_plain_matches_jax_f32(case):
    _, shape, _ = case
    y, z, w = _pair(shape, seed=9)
    out = gated_rmsnorm_ref(torch.from_numpy(y), torch.from_numpy(z),
                            torch.from_numpy(w), EPS)
    j = jl.rms_norm(jnp.asarray(y) * jax.nn.silu(jnp.asarray(z)),
                    jnp.asarray(w), EPS)
    _f32_close(out, j)


@pytest.mark.parametrize("w_bf16", [True, False])
@pytest.mark.parametrize("shape", [(8, 1, 3072), (2, 5, 5120), (7, 48)])
def test_gated_rmsnorm_plain_matches_jax_bf16_within_one_ulp(shape, w_bf16):
    """torch's bf16 ``F.silu`` (z / (1 + exp(-z)) in fp32, one rounding;
    the kernel computes the same on the card) and ``jax.nn.silu`` round
    differently: up to 2 bf16 ulps apart on these inputs, which this test
    pins.  So both sides get torch's silu values, and the product and the
    norm are held within one ulp; the f32 test holds the whole
    composition, silu included, at 1e-6."""
    y, z, w = _pair(shape, seed=10)
    wdt = (torch.bfloat16, jnp.bfloat16) if w_bf16 else (torch.float32,
                                                          jnp.float32)
    ty, tz = torch.from_numpy(y).bfloat16(), torch.from_numpy(z).bfloat16()
    out = gated_rmsnorm_ref(ty, tz, torch.from_numpy(w).to(wdt[0]), EPS)
    silu = F.silu(tz).float().numpy()
    jsilu = np.asarray(jax.nn.silu(jnp.asarray(z, jnp.bfloat16)), np.float32)
    assert np.all(np.abs(silu - jsilu) <= 2 * _bf16_ulp(jsilu))
    jy = jnp.asarray(y, jnp.bfloat16)
    _within_one_ulp(out, jl.rms_norm(jy * jnp.asarray(silu, jnp.bfloat16),
                                     jnp.asarray(w, wdt[1]), EPS))


# --- the ops on the CPU: the unfused sequence, bit for bit -------------------

def test_cpu_ops_are_the_unfused_sequence_bit_for_bit(monkeypatch):
    """On a CPU tensor the layers' fused norms compute exactly what the
    model computed before the fusion, and never reach a launcher."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel launcher")
    for name in ("rmsnorm_fwd", "add_rmsnorm_fwd", "gated_rmsnorm_fwd",
                 "qk_norm_rope_fwd"):
        monkeypatch.setattr(t_ops, name, refuse)
    for dtype in (torch.float32, torch.bfloat16):
        x, d, w = (torch.from_numpy(a).to(dtype)
                   for a in _pair((3, 5, 64), seed=13))
        out, r = tl.add_rms_norm(x, d, w, EPS)
        assert torch.equal(r, x + d)
        assert torch.equal(out, tl.rms_norm(x + d, w, EPS))
        out0, r0 = tl.add_rms_norm(x, None, w, EPS)
        assert r0 is x and torch.equal(out0, tl.rms_norm(x, w, EPS))
        assert torch.equal(tl.gated_rms_norm(x, d, w, EPS),
                           tl.rms_norm(x * F.silu(d), w, EPS))
        q, k, wq, wk, pos = qk_rope_case((2, 3, 4, 2, 32), "rows", True, 14)
        q = torch.from_numpy(q).to(dtype)
        k = torch.from_numpy(k).to(dtype)
        wq, wk = torch.from_numpy(wq), torch.from_numpy(wk)
        pos = torch.from_numpy(pos)
        tq, tk = tl.qk_norm_rope(q, k, wq, wk, pos, 1e4, EPS)
        assert torch.equal(tq, apply_rope(tl.rms_norm(q, wq, EPS), pos, 1e4))
        assert torch.equal(tk, apply_rope(tl.rms_norm(k, wk, EPS), pos, 1e4))
        tq, tk = tl.qk_norm_rope(q, k, None, None, pos, 1e4, EPS)
        assert torch.equal(tq, apply_rope(q, pos, 1e4))
        assert torch.equal(tk, apply_rope(k, pos, 1e4))


def test_train_mode_stacks_run_on_the_cpu():
    """``mode="train"`` (no cache) still runs the restructured stack on the
    plain versions: its hidden state and pending block output sum to the
    prefill's (the same full self-attention), and the MoE aux loss is
    summed."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    p = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    x = tm._embed(p, cfg, torch.randint(3, cfg.vocab_size, (2, 5)))
    h, d, kv, aux = tm._dense_stack(p, cfg, x, "train")
    hp, dp, _, _ = tm._dense_stack(p, cfg, x, "prefill")
    assert kv is None and torch.equal(h + d, hp + dp)
    assert torch.isfinite(aux) and aux > 0


# --- the launchers refuse what their kernels do not take ---------------------

def _qk_args(B=2, S=3, Hq=4, Hkv=2, D=16):
    return (torch.zeros(B, S, Hq, D), torch.zeros(B, S, Hkv, D),
            torch.ones(D), torch.ones(D), torch.arange(S),
            torch.ones(D // 2))


@pytest.mark.parametrize("bad,err,match", [
    (dict(q=torch.zeros(2, 3, 4, 15), k=torch.zeros(2, 3, 2, 15)),
     ValueError, "D must be even"),
    (dict(k=torch.zeros(2, 4, 2, 16)), ValueError, r"k must be \[B=2, S=3"),
    (dict(q=torch.zeros(2, 3, 64)), ValueError, r"\[B, S, H, D\]"),
    (dict(wk=None), ValueError, "both be given or both be None"),
    (dict(wq=torch.ones(8)), ValueError, r"wq must be \[d=16\]"),
    (dict(positions=torch.arange(3.0)), TypeError, "int32 or int64"),
    (dict(positions=torch.arange(4)), ValueError, "do not broadcast"),
    (dict(inv_freq=torch.ones(16)), ValueError, "inv_freq must be"),
    (dict(q=torch.zeros(2, 3, 4, 16).half(),
          k=torch.zeros(2, 3, 2, 16).half()), TypeError,
     "float32 or bfloat16"),
    ({}, ValueError, "CUDA device"),
])
def test_qk_norm_rope_launcher_refuses(bad, err, match):
    names = ("q", "k", "wq", "wk", "positions", "inv_freq")
    args = dict(zip(names, _qk_args()))
    args.update(bad)
    before = t_kernel.qk_norm_rope_fwd.launches
    with pytest.raises(err, match=match):
        t_kernel.qk_norm_rope_fwd(*(args[n] for n in names), eps=EPS)
    assert t_kernel.qk_norm_rope_fwd.launches == before


@pytest.mark.parametrize("fn,second", [(t_kernel.add_rmsnorm_fwd, "delta"),
                                       (t_kernel.gated_rmsnorm_fwd, "z")])
def test_row_launchers_refuse(fn, second):
    before = fn.launches
    x, w = torch.zeros(4, 16), torch.ones(16)
    with pytest.raises(ValueError, match=f"{second} must match x"):
        fn(x, torch.zeros(4, 8), w, eps=EPS)
    with pytest.raises(ValueError, match=f"{second} must match x"):
        fn(x, torch.zeros(4, 16, dtype=torch.bfloat16), w, eps=EPS)
    with pytest.raises(ValueError, match=r"w must be \[d=16\]"):
        fn(x, x, torch.ones(8), eps=EPS)
    with pytest.raises(ValueError, match=r"\[rows, d\]"):
        fn(x[None], x[None], w, eps=EPS)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(x, x, w, eps=EPS)
    assert fn.launches == before
