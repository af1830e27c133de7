"""The port's optimizer and train steps against the JAX package's, on
the CPU in f32 (and bf16 params) with bridged params and batches:
``adamw_update`` over three steps, ``cosine_schedule``,
``clip_by_global_norm``, ``quantize_int8`` and ``compress_grads_ef``
(``torch.round`` and ``jnp.round`` both round half to even), one
``build_train_step`` step (the microbatched and compressed steps are in
test_torch_train_accum.py), and the tree paths the checkpoints are keyed
by.  Bounds: ``train_parity_checks.py`` (f32
values within 1e-5 of max(1, max|ref|); parameters after a step by
``assert_step_close``).  The optimizer alone, on the same gradients, is
held tighter: 1e-6 (f32) and one bf16 ulp (bf16 params)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.train import compression as j_comp
from repro.train import optim as j_optim
from repro.utils.tree import flatten_with_paths as j_flatten
from repro.utils.tree import tree_size as j_tree_size
from repro_torch.configs import TrainConfig
from repro_torch.models.params import from_jax
from repro_torch.train import compression as t_comp
from repro_torch.train import optim as t_optim
from repro_torch.utils.tree import flatten_with_paths, tree_size
from train_parity_checks import (TC, configs, params, step_close,
                                 step_parity)

torch.set_num_threads(1)


def _tree(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return {"a": r.normal(0, 1, (5, 7)).astype(dtype),
            "b": {"c": r.normal(0, 2, (3,)).astype(dtype),
                  "d": r.normal(0, 0.5, (2, 4, 3)).astype(dtype)}}


def _bridge(tree):
    return from_jax(jax.tree.map(np.asarray, tree))


def _close(t, j, tol=1e-5, abs_=0.0):
    for (p, a), (_, b) in zip(flatten_with_paths(t), j_flatten(j)):
        b = np.asarray(b, np.float32)
        a = torch.as_tensor(a).float().numpy()
        assert np.abs(a - b).max() <= abs_ + tol * max(1.0, np.abs(b).max()), p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_jax(dtype):
    """Params in ``dtype``, grads in it too, f32 moments: three steps;
    bf16 params round each step's result once (the same rounding on both
    sides, so at most one bf16 ulp apart)."""
    tc_j, tc_t = JTrainConfig(**TC), TrainConfig(**TC)
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(0))
    tp = _bridge(jax.tree.map(np.asarray, jp))
    jo, to = j_optim.init_opt_state(jp, tc_j), t_optim.init_opt_state(tp,
                                                                      tc_t)
    for step in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(10 + step))
        jp, jo, jm = j_optim.adamw_update(jp, g, jo, tc_j)
        tp, to, tm = t_optim.adamw_update(tp, _bridge(g), to, tc_t)
        tol = 1e-6 if dtype == "float32" else 2 ** -7
        _close(tp, jp, tol=tol)
        _close(to.m, jo.m)
        _close(to.v, jo.v)
        assert int(to.count) == int(jo.count) == step + 1
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    assert all(t.dtype == torch.float32 for t in
               [to.m["a"], to.v["b"]["c"]])
    assert tp["a"].dtype == (torch.float32 if dtype == "float32"
                             else torch.bfloat16)


def test_cosine_schedule_and_clip_match_jax():
    tc_j, tc_t = JTrainConfig(**TC), TrainConfig(**TC)
    for s in range(0, 14):
        assert float(t_optim.cosine_schedule(tc_t, torch.tensor(s))) == \
            pytest.approx(float(j_optim.cosine_schedule(tc_j, jnp.asarray(
                s))), rel=1e-6, abs=1e-12)
    tree = _tree(3)
    for max_norm in (0.5, 100.0):
        jc, jn = j_optim.clip_by_global_norm(tree, max_norm)
        tcl, tn = t_optim.clip_by_global_norm(_bridge(tree), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        _close(tcl, jc, tol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_error_feedback_matches_jax(dtype):
    """Quantization (half to even on both sides, values exactly on .5
    included) and three steps of error feedback."""
    x = np.asarray([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.25], np.float32)
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    tq, ts = t_comp.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    jdt = jnp.dtype(dtype)
    je = j_comp.init_error_buffer(_tree(0))
    te = t_comp.init_error_buffer(_bridge(_tree(0)))
    for step in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(20 + step))
        jg, je = j_comp.compress_grads_ef(g, je)
        tg, te = t_comp.compress_grads_ef(_bridge(jax.tree.map(np.asarray,
                                                               g)), te)
        tol = 1e-6 if dtype == "float32" else 2 ** -7
        _close(tg, jg, tol=tol)
        _close(te, je, tol=tol)


def test_train_step_matches_jax():
    j, t, (_, tc, _, _) = step_parity("qwen3-moe-30b-a3b")
    step_close(t, j, tc)


def test_tree_paths_and_sizes_match_jax():
    """Checkpoints are keyed by these strings: dict keys sorted and
    joined by "/", a NamedTuple's fields by name in field order."""
    jcfg, _ = configs("zamba2-2.7b")
    jp, tp = params(jcfg)
    tc = TrainConfig()
    jtree = {"params": jp, "opt": j_optim.init_opt_state(
        jp, JTrainConfig())}
    ttree = {"params": tp, "opt": t_optim.init_opt_state(tp, tc)}
    assert [p for p, _ in flatten_with_paths(ttree)] == \
        [p for p, _ in j_flatten(jtree)]
    assert tree_size(ttree) == j_tree_size(jtree)
    assert "opt/count" in dict(flatten_with_paths(ttree))
