"""Step builders for serving (dense-cache and paged).

Function factories that close over the static config, as in the JAX
package's ``train/step.py``; PyTorch runs them eagerly (no ``jit``).
The training builders come with a later slice.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


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
