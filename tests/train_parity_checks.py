"""Shared by the training parity tests (test_torch_train*.py): the JAX
and port configs of an arch's smoke size in f32, params drawn by JAX and
bridged bit for bit, a batch of the synthetic stream, and the
comparison of a loss and a gradient tree.

Bounds (f32, the same arithmetic in another order and another BLAS):
the loss within ``LOSS_TOL`` absolute (measured up to 9.5e-7 on losses
near 5.5), every gradient leaf within ``GRAD_TOL * max(1, max|g|)``
(measured up to 9.2e-7 of that scale, on zamba2).

Parameters after an AdamW step (``assert_step_close``): the first step
moves each element by lr * g / (|g| + eps) (+ weight decay), so where
|g| is above 1e-3 of its leaf's largest, both sides move it by the same
amount to f32 rounding (1e-6 of max(1, max|p|)); where it is smaller,
the gradients' f32 noise is no longer small beside g and the two may
move it differently, by at most the step's size, 2 * lr."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import make_batch as j_make_batch
from repro.models import model as jm
from repro.train import optim as j_optim
from repro.train.step import build_train_step as j_build_train_step
from repro.utils.tree import flatten_with_paths as j_flatten
from repro_torch.configs import TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.params import from_jax
from repro_torch.train import optim as t_optim
from repro_torch.train.step import build_train_step
from repro_torch.utils.tree import flatten_with_paths as t_flatten

#: the optimizer settings of the step tests (warmup of 2, so step 1's
#: learning rate is half the peak)
TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
F32 = dict(param_dtype="float32", compute_dtype="float32")


def configs(arch, **over):
    """(JAX cfg, port cfg) of the arch's smoke size in f32; the MoE arch
    at a capacity where no token drops (every expert can take every
    token), unless ``over`` says otherwise."""
    j = j_get_config(arch, smoke=True).replace(**F32)
    if j.family == "moe" and "capacity_factor" not in over:
        over["capacity_factor"] = j.num_experts / j.experts_per_token
    return (j.replace(**over),
            t_get_config(arch, smoke=True).replace(**F32, **over))


def params(jcfg, seed=0):
    """(JAX params, the port's bridged copy)."""
    jp = jm.init(jcfg, jax.random.key(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def batch(cfg, B=2, S=32, step=3):
    """A numpy batch of the synthetic stream (``data/pipeline.py``)."""
    return j_make_batch(cfg, JShape("t", "train", S, B), JData(), step)


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def assert_trees_close(t_tree, j_tree, tol=GRAD_TOL):
    """Same paths (the JAX package's strings), every leaf within ``tol *
    max(1, max|ref|)``."""
    tl, jl = t_flatten(t_tree), j_flatten(j_tree)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        j = np.asarray(j, np.float32)
        t = t.detach().float().numpy()
        assert t.shape == j.shape, path
        scale = max(1.0, float(np.abs(j).max()))
        assert np.abs(t - j).max() <= tol * scale, (path,
                                                     np.abs(t - j).max())


def assert_step_close(t_params, j_params, j_m, lr: float, b1: float):
    """Parameters after one AdamW step from the same start, under the
    module's bounds; ``j_m`` is the JAX side's first moment after the
    step, (1 - b1) times its clipped gradient."""
    tl, jl, ml = (t_flatten(t_params), j_flatten(j_params),
                  j_flatten(j_m))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j), (_, m) in zip(tl, jl, ml):
        j = np.asarray(j, np.float32)
        t = t.detach().float().numpy()
        g = np.abs(np.asarray(m, np.float32)) / (1 - b1)
        big = g >= 1e-3 * g.max()
        diff = np.abs(t - j)
        assert diff[big].max(initial=0) <= 1e-6 * max(
            1.0, float(np.abs(j).max())), path
        assert diff.max() <= 2 * lr + 1e-6, path


def step_parity(arch, tc_over=None, B=2):
    """One ``build_train_step`` step of the arch's smoke config from the
    same params and batch in both packages: ((JAX params, opt state,
    metrics), (the port's), (port cfg, TrainConfig, params, batch))."""
    jcfg, tcfg = configs(arch)
    tc_j, tc_t = JTrainConfig(**TC, **(tc_over or {})), \
        TrainConfig(**TC, **(tc_over or {}))
    jp, tp = params(jcfg)
    b = batch(jcfg, B=B)
    jo, to = j_optim.init_opt_state(jp, tc_j), t_optim.init_opt_state(tp,
                                                                      tc_t)
    jp2, jo2, jm = jax.jit(j_build_train_step(jcfg, tc_j))(jp, jo,
                                                           to_jax(b))
    tp2, to2, tm = build_train_step(tcfg, tc_t)(tp, to, to_torch(b))
    return (jp2, jo2, jm), (tp2, to2, tm), (tcfg, tc_t, tp, b)


def step_close(t, j, tc):
    """One step's metrics, moments and new params (``step_parity``'s
    port and JAX triples) under the module's bounds."""
    (tp2, to2, tm), (jp2, jo2, jm) = t, j
    for key in ("ce_loss", "tokens", "aux_loss", "total_loss", "grad_norm",
                "lr"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                               abs=1e-6), key
    assert_trees_close(to2.m, jo2.m)
    assert_trees_close(to2.v, jo2.v)
    assert_step_close(tp2, jp2, jo2.m, float(jm["lr"]), tc.beta1)
