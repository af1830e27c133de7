"""Step builders for paged serving.

Function factories that close over the static config, as in the JAX
package's ``train/step.py``; PyTorch runs them eagerly (no ``jit``).
The training and dense-cache builders come with later slices.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


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
