"""The port's RMSNorm against the JAX package on the CPU, with numpy
inputs from a seed (the card-side kernel checks are in
test_torch_gpu.py):

* the plain version against ``repro.models.layers.rms_norm`` and
  against the Pallas kernel in interpret mode
  (``repro.kernels.rmsnorm.ops.rmsnorm``, with row counts that need its
  padding): f32 at 1e-6, bf16 within one bf16 ulp (the two frameworks
  may round the fp32 result to bf16 from values one f32 rounding apart);
* ``layers.rms_norm`` on a CPU tensor never reaches the kernel's
  launcher, and the launcher's checks refuse what the kernel does not
  take before any library is loaded;
* the wrapper's row view: no copy for the model's layouts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ops as j_rms_ops
from repro.models import layers as jl
from repro_torch.kernels.rmsnorm import kernel as t_kernel
from repro_torch.kernels.rmsnorm import ops as t_ops
from repro_torch.kernels.rmsnorm.cases import RMSNORM_CASES, rmsnorm_case
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import layers as tl

torch.set_num_threads(1)
_NAMES = [c[0] for c in RMSNORM_CASES]


def _view(x, shape, layout):
    """The case's x (numpy) as the view ``rmsnorm_case_on`` takes."""
    if layout == "last-token":
        return x[:, -1:]
    return x[..., :shape[-1]]


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("case", RMSNORM_CASES, ids=_NAMES)
def test_plain_matches_jax_f32(case):
    _, shape, layout = case
    x, w = rmsnorm_case(shape, layout)
    x = np.ascontiguousarray(_view(x, shape, layout))
    t = rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    j = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("w_bf16", [True, False])
@pytest.mark.parametrize("shape", [(7, 48), (8, 1, 16, 128), (3, 2560)])
def test_plain_matches_jax_bf16_within_one_ulp(shape, w_bf16):
    x, w = rmsnorm_case(shape, seed=3)
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = jnp.asarray(w, jnp.bfloat16 if w_bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16 if w_bf16 else torch.float32)
    t = rmsnorm_ref(tx, tw, 1e-6)
    assert t.dtype == torch.bfloat16
    j = np.asarray(jl.rms_norm(jx, jw, 1e-6), np.float32)
    diff = np.abs(t.float().numpy() - j)
    assert np.all(diff <= _bf16_ulp(j)), diff.max()


@pytest.mark.parametrize("rows,d", [(300, 128), (5, 2048), (257, 80)])
def test_plain_matches_the_pallas_kernel_with_padded_rows(rows, d):
    """The JAX wrapper pads ``rows`` to its 256-row block (or runs one
    block of ``rows``); the plain version needs no padding."""
    x, w = rmsnorm_case((rows, d), seed=4)
    t = rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    j = j_rms_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6,
                          interpret=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                               rtol=1e-6)


def test_layers_rms_norm_on_the_cpu_never_reaches_the_launcher(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA launcher was called for a CPU tensor")
    monkeypatch.setattr(t_ops, "rmsnorm_fwd", refuse)
    before = t_kernel.rmsnorm_fwd.launches
    x, w = rmsnorm_case((4, 3, 64), seed=5)
    out = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-6)
    assert t_kernel.rmsnorm_fwd.launches == before


def test_launcher_refuses_what_the_kernel_does_not_take():
    before = t_kernel.rmsnorm_fwd.launches
    x, w = torch.zeros(4, 16), torch.ones(16)
    with pytest.raises(ValueError, match="CUDA device"):
        t_kernel.rmsnorm_fwd(x, w, eps=1e-6)
    with pytest.raises(ValueError, match=r"\[rows, d\]"):
        t_kernel.rmsnorm_fwd(x[None], w, eps=1e-6)
    with pytest.raises(ValueError, match=r"w must be \[d=16\]"):
        t_kernel.rmsnorm_fwd(x, torch.ones(8), eps=1e-6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_kernel.rmsnorm_fwd(x.half(), w, eps=1e-6)
    assert t_kernel.rmsnorm_fwd.launches == before


@pytest.mark.parametrize("case", RMSNORM_CASES, ids=_NAMES)
def test_row_view_copies_nothing_for_the_model_layouts(case):
    """Every case layout (dense, a row stride, ``h[:, -1:]``) is read in
    place, with 16-byte loads exactly where d and the stride allow."""
    _, shape, layout = case
    x, w = rmsnorm_case(shape, layout)
    xt = torch.from_numpy(x).clone()        # torch's 64-byte alignment
    xv = xt[:, -1:] if layout == "last-token" else xt[..., :shape[-1]]
    x2 = t_ops.row_view(xv)
    assert x2.data_ptr() == xv.data_ptr() and x2.stride(1) == 1
    out = torch.empty(x2.shape)
    vec = t_kernel.vectorized(x2, torch.from_numpy(w), out)
    assert vec == (shape[-1] % 4 == 0 and layout != "row-stride+3")
    torch.testing.assert_close(x2.reshape(shape), xv)


def test_row_view_copies_a_strided_last_axis():
    x = torch.arange(48.0).reshape(4, 12)
    v = t_ops.row_view(x[:, ::2])
    assert v.is_contiguous() and v.data_ptr() != x.data_ptr()
    assert torch.equal(v, x[:, ::2])


#: the norm ops of the model, by name in ``kernels/rmsnorm/ops.py`` (on
#: the card each launches the kernel of the same name + ``_fwd``)
NORM_OPS = ("rmsnorm", "add_rmsnorm", "qk_norm_rope", "gated_rmsnorm")


def _norms_per_call(cfg) -> dict:
    """Calls of each norm op in one model call: the stack's first
    pre-norm has no pending block output (``rmsnorm``); every later
    pre-norm and the final norm add the previous block's output
    (``add_rmsnorm``); each attention layer's qk-norm (if any) and RoPE
    are one ``qk_norm_rope``, and each Mamba2 layer's gate and norm one
    ``gated_rmsnorm``.  zamba2's shared block counts once per
    application."""
    L = cfg.num_layers
    attn = {"ssm": 0, "hybrid": L // max(cfg.attn_every, 1)}.get(
        cfg.family, L)
    mamba = L if cfg.family in ("ssm", "hybrid") else 0
    return {"rmsnorm": 1, "add_rmsnorm": 2 * attn + mamba,
            "qk_norm_rope": attn, "gated_rmsnorm": mamba}


#: what chip_smoke.py's launch checks hold each path's calls to, per op
NORMS = {
    "qwen3-0.6b": {"rmsnorm": 1, "add_rmsnorm": 56, "qk_norm_rope": 28,
                   "gated_rmsnorm": 0},
    "mamba2-780m": {"rmsnorm": 1, "add_rmsnorm": 48, "qk_norm_rope": 0,
                    "gated_rmsnorm": 48},
    "zamba2-2.7b": {"rmsnorm": 1, "add_rmsnorm": 72, "qk_norm_rope": 9,
                    "gated_rmsnorm": 54},
    "qwen3-moe-30b-a3b": {"rmsnorm": 1, "add_rmsnorm": 96,
                          "qk_norm_rope": 48, "gated_rmsnorm": 0},
}


@pytest.mark.parametrize("arch", sorted(NORMS))
def test_every_norm_of_every_serving_path_goes_through_the_op(arch,
                                                              monkeypatch):
    """Counted per op on the smoke config for each call of each serving
    path the arch has (each op is its kernel's wrapper on the card), and
    the same counts at the published config are the numbers the card's
    launch checks use."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    assert _norms_per_call(get_config(arch)) == NORMS[arch]
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32",
                                               compute_dtype="float32")
    calls = {op: 0 for op in NORM_OPS}

    def counted(op):
        real = getattr(t_ops, op)

        def call(*a, **k):
            calls[op] += 1
            return real(*a, **k)
        return call

    for op in NORM_OPS:
        monkeypatch.setattr(t_ops, op, counted(op))
    p = tm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(3, cfg.vocab_size, (2, 6))
    counts = []

    def count(step, *args):
        before = dict(calls)
        out = step(p, cfg, *args)
        counts.append({op: calls[op] - before[op] for op in NORM_OPS})
        return out

    logits, cache = count(tm.prefill, {"tokens": toks}, 12)
    count(tm.decode_step, cache, logits.argmax(-1))
    if cfg.family in ("dense", "moe"):
        pc = tm.init_paged_cache(cfg, 2, 8, 4, device="cpu")
        pc["table"][:, :3] = torch.tensor([[1, 2, 3], [4, 5, 6]])
        logits, pc = count(tm.prefill_chunk, pc, toks, torch.zeros(2),
                           torch.full((2,), 6))
        count(tm.decode_step_paged, pc, logits.argmax(-1))
    assert counts == [_norms_per_call(cfg)] * len(counts)
    assert len(counts) == (4 if cfg.family in ("dense", "moe") else 2)
