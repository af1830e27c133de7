"""The port's training forward (``forward_train`` + ``lm_loss``) against
the JAX package's, on the CPU at smoke size in f32 with bridged params:
the loss and every gradient leaf against ``jax.value_and_grad`` of the
JAX ``build_loss_fn``, for the dense, moe (at a capacity with no drop)
vlm, local/global (gemma2) and encdec (whisper) archs (the ssm and
hybrid archs are in test_torch_train_ssm.py, the MoE gradient where
tokens drop and the train mode's writing no state in
test_torch_train_moe.py; gemma2 and whisper without remat in
test_torch_gemma2.py and test_torch_encdec.py).  Bounds:
``train_parity_checks.py``."""
import jax
import pytest
import torch

from repro.train.step import build_loss_fn as j_build_loss_fn
from repro_torch.train.step import build_loss_fn, value_and_grad
from train_parity_checks import (LOSS_TOL, assert_trees_close, batch,
                                 configs, params, to_jax, to_torch)

torch.set_num_threads(1)


def _loss_and_grads(arch, **over):
    jcfg, tcfg = configs(arch, **over)
    jp, tp = params(jcfg)
    b = batch(jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(j_build_loss_fn(jcfg),
                                                has_aux=True))(jp, to_jax(b))
    (tl, tmet), tg = value_and_grad(build_loss_fn(tcfg), tp, to_torch(b))
    return (jl, jmet, jg), (tl, tmet, tg)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "pixtral-12b", "gemma2-27b",
                                  "whisper-large-v3"])
def test_loss_and_every_grad_leaf_match_jax(arch):
    (jl, jmet, jg), (tl, tmet, tg) = _loss_and_grads(arch)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    for key in ("ce_loss", "tokens", "aux_loss", "total_loss"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= LOSS_TOL, key
    assert_trees_close(tg, jg)
