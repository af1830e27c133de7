"""Step builders: train_step / prefill_step / decode_step.

Function factories that close over the static configs, as in the JAX
package's ``train/step.py``; PyTorch runs them eagerly (no ``jit``).
Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves (``value_and_grad``), in the leaves' dtypes, as ``jax.grad`` gives
them.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as model_lib
from repro_torch.obs.spans import span
from repro_torch.train import compression as comp
from repro_torch.train import optim
from repro_torch.train.loss import lm_loss
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def build_loss_fn(cfg: ModelConfig, seq_chunks: int = 1) -> Callable:
    def loss_fn(params, batch):
        hidden, aux = model_lib.forward_train(params, cfg, batch)
        loss, metrics = lm_loss(params, cfg, hidden, batch["labels"],
                                batch.get("loss_mask"),
                                seq_chunks=seq_chunks)
        total = loss + cfg.router_aux_weight * aux
        metrics = dict(metrics, aux_loss=aux, total_loss=total)
        return total, metrics
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``:
    -> ((total, metrics), grads), grads a tree like params in the
    leaves' dtypes (zeros for a leaf the loss does not use), everything
    detached.  The parameters themselves are left as they are (the
    autograd leaves are detached aliases of them)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        with span("train.forward"):
            total, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        with span("train.backward"):
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), tree_unflatten(params, grads)


def _microbatches(batch: Dict[str, torch.Tensor], n: int, size: int):
    """The batch's rows cut into ``n`` microbatches of ``size`` (the JAX
    step's reshape to [n, size, ...])."""
    return [{k: v[j * size:(j + 1) * size] for k, v in batch.items()}
            for j in range(n)]


def build_train_step(cfg: ModelConfig, tc: TrainConfig,
                     seq_chunks: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    With tc.microbatch set, the global batch is split into
    B/microbatch accumulation steps, the fp32 gradients summed over them
    and divided by their number, the metrics averaged and
    ``total_loss`` the mean of the microbatches' losses (the JAX step's
    ``lax.scan``).  The metrics carry ``ce_loss``, ``tokens``,
    ``aux_loss``, ``total_loss``, ``grad_norm`` and ``lr``.
    """
    loss_fn = build_loss_fn(cfg, seq_chunks)

    def compute_grads(params, batch):
        if tc.microbatch:
            B = batch["tokens"].shape[0]
            n = B // tc.microbatch
            assert n * tc.microbatch == B, (B, tc.microbatch)
            g_acc = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            l_acc = torch.zeros((), dtype=torch.float32,
                                device=batch["tokens"].device)
            ms = []
            for mb in _microbatches(batch, n, tc.microbatch):
                (l, m), g = value_and_grad(loss_fn, params, mb)
                for a, b in zip(tree_leaves(g_acc), tree_leaves(g)):
                    a.add_(b.float())
                l_acc = l_acc + l
                ms.append(m)
            grads = tree_map(lambda g: g / n, g_acc)
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]), dim=0)
                       for k in ms[0]}
            metrics["total_loss"] = l_acc / n
            return grads, metrics
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        return grads, metrics

    def train_step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        params, opt_state, opt_metrics = optim.adamw_update(
            params, grads, opt_state, tc)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def build_train_step_compressed(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """Variant with int8 error-feedback gradient compression:
    (params, opt_state, error_buf, batch) -> (params, opt_state, error_buf,
    metrics)."""
    loss_fn = build_loss_fn(cfg)

    def train_step(params, opt_state, error_buf, batch):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        grads, error_buf = comp.compress_grads_ef(grads, error_buf)
        params, opt_state, opt_metrics = optim.adamw_update(
            params, grads, opt_state, tc)
        return params, opt_state, error_buf, dict(metrics, **opt_metrics)

    return train_step


def build_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """Prompt prefill into a dense cache of ``max_len`` slots.

    (params, batch {"tokens": [B,S], ...}) -> (last logits [B,1,V],
    cache)."""
    def prefill_step(params, batch):
        return model_lib.prefill(params, cfg, batch, max_len=max_len)
    return prefill_step


def build_decode_step(cfg: ModelConfig) -> Callable:
    """One-token decode over the dense cache at its shared position.

    (params, cache, token [B,1]) -> (logits [B,1,V], cache); the cache
    is updated in place."""
    def decode_step(params, cache, token):
        return model_lib.decode_step(params, cfg, cache, token)
    return decode_step


def build_paged_decode_step(cfg: ModelConfig) -> Callable:
    """One-token decode over the page-pool cache; per-row positions.

    (params, cache, token [B,1], active [B] bool) -> (logits, cache)."""
    def paged_decode_step(params, cache, token, active):
        return model_lib.decode_step_paged(params, cfg, cache, token,
                                           active)
    return paged_decode_step


def build_prefill_chunk_step(cfg: ModelConfig) -> Callable:
    """One prompt chunk per row into the page-pool cache.

    (params, cache, tokens [B,C], start [B], chunk_lens [B],
    active [B] bool) -> (last-valid-token logits [B,1,V], cache)."""
    def prefill_chunk_step(params, cache, tokens, start, chunk_lens,
                           active):
        return model_lib.prefill_chunk(params, cfg, cache, tokens,
                                       start, chunk_lens, active)
    return prefill_chunk_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    """The dry-run's decode entry: one new token, greedy sample.

    (params, token [B,1], cache) -> (next_token [B,1] int32, cache); the
    cache is updated in place."""
    def serve_step(params, token, cache):
        logits, cache = model_lib.decode_step(params, cfg, cache, token)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, cache
    return serve_step
