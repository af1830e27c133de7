"""whisper's encoder-decoder in the port against the JAX package, on the
CPU at smoke size in f32 with bridged weights: the non-causal encoder
without RoPE (8 frames of stub embeddings), its final norm, each decoder
layer's cross K/V from the encoder's output, and the decoder's causal
self-attention with RoPE and the cache, its cross-attention and MLP.

* ``prefill`` + ``decode_step`` logits and every cache leaf (``k``,
  ``v``, ``cross_k``, ``cross_v``, ``len``) within 1e-4
  (``dense_serving_checks.py``);
* ``TorchBackend`` token streams equal ``JaxBackend``'s with joins (the
  joiners' cross K/V rows concatenated) and a preemption, and the CLI
  serves 8/8;
* ``forward_train`` + ``lm_loss``: the loss and every gradient leaf
  against ``jax.value_and_grad`` (``train_parity_checks.py``), with and
  without remat, and one AdamW step;
* the norm ops' calls per prefill, per decode step and per train step.

The paged path refuses the encdec family, as the JAX package's does."""
import jax
import numpy as np
import pytest
import torch

from dense_serving_checks import (assert_caches_close, assert_close,
                                  counting_norm_ops, prompt_batch,
                                  run_both, setup, staggered, streams)
from repro.models import model as jm
from repro.train.step import build_loss_fn as j_build_loss_fn
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as tm
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.train import optim
from repro_torch.train.step import (build_decode_step, build_loss_fn,
                                    build_prefill_step, build_train_step,
                                    value_and_grad)
from train_parity_checks import (LOSS_TOL, assert_trees_close, batch,
                                 configs, params, step_close, step_parity,
                                 to_jax, to_torch)

torch.set_num_threads(1)
ARCH = "whisper-large-v3"


@pytest.mark.parametrize("S,D", [(1, 2), (7, 16), (1500, 1280), (33, 5)])
def test_sinusoidal_positions_equal_jax(S, D):
    from repro.models.layers import sinusoidal_positions as j_sin
    t = sinusoidal_positions(S, D)
    assert t.dtype == torch.float32 and tuple(t.shape) == (S, 2 * (D // 2))
    np.testing.assert_array_equal(t.numpy(), j_sin(S, D))


def test_prefill_then_decode_match_jax():
    jcfg, tcfg, jp, tp = setup(ARCH)
    S, max_len = 9, 16
    jb, tb = prompt_batch(jcfg, 2, S)
    lj, jc = jax.jit(lambda p, b: jm.prefill(p, jcfg, b, max_len))(jp, jb)
    lt, tc = build_prefill_step(tcfg, max_len)(tp, tb)
    assert_close(lt.numpy(), lj, "prefill logits")
    assert_caches_close(tc, jc)
    L, hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    assert tc["k"].shape == (L, 2, max_len, hkv, hd)
    assert tc["cross_k"].shape == (L, 2, 8, hkv, hd)    # never padded
    dec_j = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    dec_t = build_decode_step(tcfg)
    token = lt.argmax(-1)
    for _ in range(4):
        lj, jc = dec_j(jp, jc, jax.numpy.asarray(token.numpy()))
        lt, tc = dec_t(tp, tc, token)
        assert_close(lt.numpy(), lj, "decode logits")
        assert_caches_close(tc, jc)
        token = lt.argmax(-1)


def test_token_streams_match_jax_with_joins_and_preemption():
    (js, jreqs), (ts, treqs), tbe, joins, _ = run_both(ARCH, staggered(),
                                                       32)
    assert ts["completed"] == js["completed"] == 8
    assert ts["preemptions"] == js["preemptions"] > 0
    assert sum(n_old > 0 for n_old, _ in joins) >= 2    # mid-stream joins
    assert streams(treqs) == streams(jreqs)
    assert tbe.empty and tbe._cache is None


def test_cli_serves_on_the_cpu():
    out = t_serve.main(["--arch", ARCH, "--smoke", "--backend", "dense",
                        "--device", "cpu", "--requests", "8"])
    assert out["summary"]["completed"] == 8
    for r in out["engine"].requests:
        assert len(r.tokens) == r.max_new_tokens


def test_paged_path_refuses_encdec():
    with pytest.raises(NotImplementedError, match="encdec"):
        tm.init_paged_cache(get_config(ARCH, smoke=True), 1, 4, 4,
                            abstract_only=True)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_every_grad_leaf_match_jax(remat):
    jcfg, tcfg = configs(ARCH, remat=remat)
    jp, tp = params(jcfg)
    b = batch(jcfg)
    assert b["enc_embeds"].shape == (2, 16, jcfg.d_model)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(j_build_loss_fn(jcfg),
                                                has_aux=True))(jp, to_jax(b))
    (tl, tmet), tg = value_and_grad(build_loss_fn(tcfg), tp, to_torch(b))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    for key in ("ce_loss", "tokens", "total_loss"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= LOSS_TOL, key
    assert_trees_close(tg, jg)


def test_train_step_matches_jax():
    j, t, (_, tc, _, _) = step_parity(ARCH)
    step_close(t, j, tc)


def norms_per_call(cfg, prefill: bool) -> dict:
    """Norm ops per model call.  The decoder: its first pre-norm
    (``rmsnorm``), every later pre-norm (self-attention, cross-attention
    and MLP) and the final norm (``add_rmsnorm``), each layer's RoPE
    (``qk_norm_rope``; the cross-attention has none).  A prefill also runs
    the encoder: its first pre-norm, its other pre-norms and its final
    norm."""
    L = cfg.num_layers
    out = {"rmsnorm": 1, "add_rmsnorm": 3 * L, "qk_norm_rope": L,
           "gated_rmsnorm": 0}
    if prefill:
        out["rmsnorm"] += 1
        out["add_rmsnorm"] += 2 * L
    return out


def norms_per_train_step(cfg) -> dict:
    """Norm ops in one train step under ``remat="full"``: the forward
    (the final norm is ``rmsnorm``, the train mode summing the hidden
    first), then the recompute of every layer of both stacks (all but
    the final norm and the encoder's)."""
    fwd = norms_per_call(cfg, True)
    fwd["rmsnorm"] += 1
    fwd["add_rmsnorm"] -= 1
    outside = {"rmsnorm": 1, "add_rmsnorm": 1}
    return {op: 2 * n - outside.get(op, 0) if n else 0
            for op, n in fwd.items()}


def test_norm_ops_per_call_and_per_train_step(monkeypatch):
    """Counted on the CPU for a prefill, two decode steps and a train
    step; at the published depth the counts are the launches
    chip_smoke.py holds the card to."""
    full = get_config(ARCH)
    assert norms_per_call(full, True) == {
        "rmsnorm": 2, "add_rmsnorm": 160, "qk_norm_rope": 32,
        "gated_rmsnorm": 0}
    assert norms_per_call(full, False) == {
        "rmsnorm": 1, "add_rmsnorm": 96, "qk_norm_rope": 32,
        "gated_rmsnorm": 0}
    assert norms_per_train_step(full) == {
        "rmsnorm": 5, "add_rmsnorm": 317, "qk_norm_rope": 64,
        "gated_rmsnorm": 0}
    _, cfg, _, p = setup(ARCH)
    calls = counting_norm_ops(monkeypatch)
    _, tb = prompt_batch(cfg, 2, 7)
    before = dict(calls)
    logits, cache = tm.prefill(p, cfg, tb, 12)
    assert {op: calls[op] - before[op] for op in calls} == \
        norms_per_call(cfg, True)
    for _ in range(2):
        before = dict(calls)
        logits, cache = tm.decode_step(p, cfg, cache, logits.argmax(-1))
        assert {op: calls[op] - before[op] for op in calls} == \
            norms_per_call(cfg, False)
    before = dict(calls)
    tc = TrainConfig()
    b = to_torch(batch(cfg, S=16))
    build_train_step(cfg, tc)(p, optim.init_opt_state(p, tc), b)
    assert {op: calls[op] - before[op] for op in calls} == \
        norms_per_train_step(cfg)
