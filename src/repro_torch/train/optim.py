"""AdamW + LR schedules, mirroring the JAX package's ``train/optim.py``.

State layout mirrors params exactly (trees of m and v) so that a
parameter's optimizer moments are found at its path.  ``adamw_update``
keeps the JAX function's order of operations (clip, count + 1, the
learning rate at the new count, bias corrections, the step), all in fp32,
and returns new tensors, as the JAX function returns new arrays: nothing
is updated in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import torch_dtype
from repro_torch.obs.spans import spanned
from repro_torch.utils.tree import (tree_leaves, tree_map,
                                    tree_unflatten)


class OptState(NamedTuple):
    m: Any              # first moment, tree like params
    v: Any              # second moment, tree like params
    count: torch.Tensor  # step counter, int32 scalar


def _count_device(params):
    return next(iter(tree_leaves(params))).device


def init_opt_state(params, tc: TrainConfig) -> OptState:
    """Zero moments in ``tc.adam_dtype`` on each parameter's device, and
    a zero int32 count on the first parameter's."""
    dt = torch_dtype(tc.adam_dtype)

    def zeros(p):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=dt,
                                              device=x.device), p)
    return OptState(m=zeros(params), v=zeros(params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=_count_device(params)))


def abstract_opt_state(params, tc: TrainConfig) -> OptState:
    """``init_opt_state``'s tree as ``device="meta"`` tensors."""
    dt = torch_dtype(tc.adam_dtype)

    def mk(p):
        return tree_map(lambda x: torch.empty(x.shape, dtype=dt,
                                              device="meta"), p)
    return OptState(m=mk(params), v=mk(params),
                    count=torch.empty((), dtype=torch.int32, device="meta"))


def cosine_schedule(tc: TrainConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10% of peak."""
    stepf = torch.as_tensor(step).float()
    warm = torch.clamp(stepf / max(tc.warmup_steps, 1), max=1.0)
    frac = torch.clamp((stepf - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``grads`` scaled to a global norm of at most ``max_norm``; ``norm``
    is that norm when ``grads`` holds only a slice of the gradients (the
    sharded step), else it is computed from them."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
@spanned("train.optimizer")
def adamw_update(params, grads, state: OptState, tc: TrainConfig,
                 norm=None) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new_params, new_state, metrics).
    ``norm``: the gradients' global norm when the trees hold only this
    rank's slices of them (``clip_by_global_norm``)."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, norm)
    count = state.count + 1
    lr = cosine_schedule(tc, count)
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    bc1 = 1.0 - b1 ** count.float()
    bc2 = 1.0 - b2 ** count.float()
    sdt = torch_dtype(tc.adam_dtype)

    def upd(p, g, m, v):
        # the same arithmetic in the same order, each fp32 temporary freed
        # as soon as it is used: a 1.2-billion-entry leaf (gemma2's tied
        # embedding) holds five fp32 copies at a time, not eight
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf * gf * (1 - b2)
        del gf
        step = (mf / bc1) / (torch.sqrt(vf / bc2) + eps) \
            + tc.weight_decay * p.float()
        newp = (p.float() - lr * step).to(p.dtype)
        del step
        return newp, mf.to(sdt), vf.to(sdt)

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v), strict=True)]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(new_m, new_v, count), metrics
