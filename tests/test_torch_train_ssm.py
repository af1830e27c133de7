"""The port's training forward against the JAX package's for the ssm
(mamba2-780m) and hybrid (zamba2-2.7b) archs: the loss and every
gradient leaf against ``jax.value_and_grad`` of the JAX
``build_loss_fn`` (the cache-less train modes of ``_ssm_stack`` and
``_hybrid_stack``, the plain SSD scan); the train mode's route past the
SSD op (``differentiable``); ``seq_chunks`` equal to the unchunked
loss and to JAX's (remat is in test_torch_train_remat.py).
Bounds: ``train_parity_checks.py``."""
import jax
import pytest
import torch

from repro.train.step import build_loss_fn as j_build_loss_fn
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import model as tm
from repro_torch.train.step import build_loss_fn, value_and_grad
from repro_torch.utils.tree import tree_leaves
from train_parity_checks import (GRAD_TOL, LOSS_TOL, assert_trees_close,
                                 batch, configs, params, to_jax, to_torch)

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_loss_and_every_grad_leaf_match_jax(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    b = batch(jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(j_build_loss_fn(jcfg),
                                                has_aux=True))(jp, to_jax(b))
    (tl, tmet), tg = value_and_grad(build_loss_fn(tcfg), tp, to_torch(b))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    assert abs(float(tmet["ce_loss"]) - float(jmet["ce_loss"])) <= LOSS_TOL
    assert_trees_close(tg, jg)


def test_train_mode_takes_the_plain_scan_not_the_ssd_op(monkeypatch):
    """The model's mode decides the route: with the SSD op refusing to
    run, a train step still runs (the plain scan), a prefill does not."""
    _, tcfg = configs("mamba2-780m")
    _, tp = params(configs("mamba2-780m")[0])

    def refuse(*a, **k):
        raise AssertionError("the SSD op ran")
    monkeypatch.setattr(ssd_ops, "ssd_scan", refuse)
    b = to_torch(batch(tcfg))
    (loss, _), _ = value_and_grad(build_loss_fn(tcfg), tp, b)
    assert torch.isfinite(loss)
    with pytest.raises(AssertionError, match="the SSD op ran"):
        tm.prefill(tp, tcfg, {"tokens": b["tokens"]}, 40)


def test_seq_chunks_equal_the_unchunked_loss_and_jax():
    """``lm_loss(seq_chunks=4)``: the loss and grads equal the unchunked
    ones, and JAX's chunked ones."""
    jcfg, tcfg = configs("qwen3-0.6b")
    jp, tp = params(jcfg)
    b = batch(jcfg)
    (j4, _), jg4 = jax.jit(jax.value_and_grad(
        j_build_loss_fn(jcfg, seq_chunks=4), has_aux=True))(jp, to_jax(b))
    (t1, _), tg1 = value_and_grad(build_loss_fn(tcfg), tp, to_torch(b))
    (t4, _), tg4 = value_and_grad(build_loss_fn(tcfg, seq_chunks=4), tp,
                                  to_torch(b))
    assert abs(float(t4) - float(t1)) <= LOSS_TOL
    assert abs(float(t4) - float(j4)) <= LOSS_TOL
    assert_trees_close(tg4, jg4)
    for a, c in zip(tree_leaves(tg4), tree_leaves(tg1)):
        assert float((a - c).abs().max()) <= GRAD_TOL * max(
            1.0, float(c.abs().max()))
