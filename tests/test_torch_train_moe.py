"""The MoE gradient where tokens drop, against the JAX package's.  The
forward already agrees past capacity (test_torch_moe.py: in an
overflowing expert the kept token in slot C-1 gets a zero output, the
JAX result, which the port reproduces by leaving that slot empty).  The
gradient agrees too: JAX's scatter writes every dropped token's zero
onto slot C-1 after the kept token, and its backward gives the
overwritten update no gradient, which is what the port's empty slot
gives.  So the only MoE difference left is the one the forward test
pins; these tests hold the gradient to the bounds of
``train_parity_checks.py``.  Also here, to balance the files' time: the
train mode writes no state."""
import jax
import numpy as np
import torch

from repro.models import moe as j_moe
from repro.train.step import build_loss_fn as j_build_loss_fn
from repro_torch.models import model as tm
from repro_torch.models import moe as t_moe
from repro_torch.train.step import build_loss_fn, value_and_grad
from train_parity_checks import (LOSS_TOL, assert_trees_close, batch,
                                 configs, params, to_jax, to_torch)

torch.set_num_threads(1)


def test_moe_ffn_grads_past_capacity_match_jax():
    """k = 1, every token routed to expert 3, C = 8 slots for 24 tokens
    (test_torch_moe.py's forced overflow): the input gradient equals
    JAX's for every token; token C-1 (kept, then overwritten) and the
    dropped tokens get none through the experts in either."""
    r = np.random.default_rng(3)
    N, d, f, E = 24, 16, 32, 4
    x = np.abs(r.normal(0, 1, (N, d))).astype(np.float32)
    w_router = np.zeros((d, E), np.float32)
    w_router[:, 3] = 1.0                          # every logit favours 3
    ws = [r.normal(0, 0.2, s).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    cot = r.normal(0, 1, (N, d)).astype(np.float32)
    cf = 8 * E / N

    def j_fn(xx):
        return j_moe.moe_ffn(xx, w_router, *ws, k=1, capacity_factor=cf).y
    jy, vjp = jax.vjp(j_fn, x)
    jdx = np.asarray(vjp(cot)[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = t_moe.moe_ffn(xt, torch.from_numpy(w_router),
                       *map(torch.from_numpy, ws), k=1,
                       capacity_factor=cf).y
    ty.backward(torch.from_numpy(cot))
    tdx = xt.grad.numpy()
    assert t_moe.capacity(N, 1, cf, E) == 8
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5)
    np.testing.assert_allclose(tdx, jdx, atol=1e-5)
    assert np.abs(tdx[:7]).max() > 1e-3
    assert not tdx[7:].any() and not jdx[7:].any()


def test_moe_model_grads_with_dropped_tokens_match_jax():
    """qwen3-moe smoke at capacity factor 1.0, 4 rows x 32 tokens: some
    tokens drop, and the loss and every gradient leaf still match."""
    jcfg, tcfg = configs("qwen3-moe-30b-a3b", capacity_factor=1.0)
    jp, tp = params(jcfg)
    b = batch(jcfg, B=4, S=32)
    x = tp["embed"][torch.from_numpy(b["tokens"]).long()].reshape(
        -1, tcfg.d_model)
    dropped = t_moe.moe_ffn(
        x, tp["blocks"]["moe"]["w_router"][0],
        tp["blocks"]["moe"]["w_gate"][0], tp["blocks"]["moe"]["w_up"][0],
        tp["blocks"]["moe"]["w_down"][0], k=tcfg.experts_per_token,
        capacity_factor=1.0, with_aux=True).fraction_dropped
    assert float(dropped) > 0
    (jl, _), jg = jax.jit(jax.value_and_grad(j_build_loss_fn(jcfg),
                                             has_aux=True))(jp, to_jax(b))
    (tl, _), tg = value_and_grad(build_loss_fn(tcfg), tp, to_torch(b))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    assert_trees_close(tg, jg)


def test_forward_train_writes_no_state_and_keeps_params():
    """Train mode reads and writes no cache: the params are unchanged by
    a forward and a backward, and the stacks return no cache."""
    _, tcfg = configs("zamba2-2.7b")
    _, tp = params(configs("zamba2-2.7b")[0])
    before = {k: v.clone() for k, v in tp["blocks"]["mamba"].items()}
    b = to_torch(batch(tcfg))
    (loss, _), _ = value_and_grad(build_loss_fn(tcfg), tp, b)
    assert torch.isfinite(loss)
    for k, v in tp["blocks"]["mamba"].items():
        assert torch.equal(v, before[k]), k
    x = tm._embed(tp, tcfg, b["tokens"])
    for stack in (tm._hybrid_stack, tm._ssm_stack):
        if stack is tm._ssm_stack:
            _, scfg = configs("mamba2-780m")
            _, sp = params(configs("mamba2-780m")[0])
            out = stack(sp, scfg, tm._embed(sp, scfg, b["tokens"]), "train")
        else:
            out = stack(tp, tcfg, x, "train")
        assert out[2] is None
