"""Rematerialisation changes what a train step keeps, not what it
computes: ``cfg.remat`` none, full (``torch.utils.checkpoint``) and dots
(selective checkpointing that keeps the matrix products) give the same
loss and gradients, on a dense, a moe and a hybrid arch at smoke size
in f32 (bounds: ``train_parity_checks.py``)."""
import pytest
import torch

from repro_torch.train.step import build_loss_fn, value_and_grad
from repro_torch.utils.tree import tree_leaves
from train_parity_checks import GRAD_TOL, batch, configs, params, to_torch

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "zamba2-2.7b"])
def test_remat_none_full_and_dots_give_the_same_grads(arch):
    """Rematerialisation changes what is kept, not what is computed:
    the three modes' gradients agree to f32 rounding (recomputed
    products may be summed in another order)."""
    _, tcfg = configs(arch)
    _, tp = params(configs(arch)[0])
    b = to_torch(batch(tcfg))
    grads = {}
    for remat in ("none", "full", "dots"):
        (loss, _), g = value_and_grad(build_loss_fn(
            tcfg.replace(remat=remat)), tp, b)
        grads[remat] = (float(loss), list(tree_leaves(g)))
    for remat in ("full", "dots"):
        assert grads[remat][0] == pytest.approx(grads["none"][0], abs=1e-6)
        for a, n in zip(grads[remat][1], grads["none"][1]):
            scale = max(1.0, float(n.abs().max()))
            assert float((a - n).abs().max()) <= GRAD_TOL * scale
