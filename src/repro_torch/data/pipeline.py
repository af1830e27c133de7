"""Deterministic, shardable synthetic data pipeline.

Every batch is a pure function of (seed, step, shard) — workers on
different hosts slice disjoint shards of the same logical batch with no
coordination, and a restarted job regenerates exactly the batch it would
have seen (checkpoint/restart determinism, tested).

Two generators:
  * ``lm_synthetic``  — structured pseudo-text (Zipfian unigrams + local
    bigram structure) so cross-entropy has learnable signal.
  * ``copy_task``     — [BOS, payload..., SEP, payload...]; loss on the
    second half. A ~100M model learns this quickly — the quickstart's
    convergence check.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    kind: str = "lm_synthetic"   # lm_synthetic | copy_task
    seed: int = 1234
    zipf_a: float = 1.3


def _rng_for(dc: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, shard]))


def _zipf_tokens(rng, shape, vocab, a):
    # rejection-free bounded zipf via inverse-CDF on a truncated support
    ranks = rng.zipf(a, size=shape)
    return np.minimum(ranks, vocab - 1).astype(np.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, dc: DataConfig,
               step: int, shard: int = 0, num_shards: int = 1
               ) -> Dict[str, np.ndarray]:
    """One (shard of a) global batch for `train` kind shapes."""
    B = shape.global_batch // num_shards
    S = shape.seq_len
    rng = _rng_for(dc, step, shard)

    if dc.kind == "copy_task":
        half = S // 2
        payload = rng.integers(3, cfg.vocab_size, size=(B, half - 1),
                               dtype=np.int32)
        seq = np.concatenate(
            [np.full((B, 1), 1, np.int32), payload,
             np.full((B, 1), 2, np.int32), payload], axis=1)[:, :S]
        tokens = seq[:, :-1]
        labels = seq[:, 1:]
        mask = np.zeros_like(labels, np.float32)
        mask[:, half - 1:] = 1.0
        tokens = np.pad(tokens, ((0, 0), (0, S - tokens.shape[1])))
        labels = np.pad(labels, ((0, 0), (0, S - labels.shape[1])))
        mask = np.pad(mask, ((0, 0), (0, S - mask.shape[1])))
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    # lm_synthetic: zipf unigrams with injected bigram structure
    toks = _zipf_tokens(rng, (B, S + 1), cfg.vocab_size, dc.zipf_a)
    # bigram structure: with p=0.5, next token = (tok*7+3) % vocab
    follow = (toks[:, :-1] * 7 + 3) % cfg.vocab_size
    coin = rng.random((B, S)) < 0.5
    toks[:, 1:] = np.where(coin, follow, toks[:, 1:])
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "loss_mask": np.ones((B, S), np.float32)}

    if cfg.family == "vlm":
        s_img = S // 4
        batch["tokens"] = batch["tokens"][:, : S - s_img]
        batch["patch_embeds"] = rng.normal(
            0, 0.02, (B, s_img, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        half = S // 2
        batch = {"tokens": batch["tokens"][:, :half],
                 "labels": batch["labels"][:, :half],
                 "loss_mask": batch["loss_mask"][:, :half],
                 "enc_embeds": rng.normal(
                     0, 0.02, (B, half, cfg.d_model)).astype(np.float32)}
    return batch


def batch_iterator(cfg: ModelConfig, shape: ShapeConfig,
                   dc: Optional[DataConfig] = None, start_step: int = 0,
                   shard: int = 0, num_shards: int = 1
                   ) -> Iterator[Dict[str, np.ndarray]]:
    dc = dc or DataConfig()
    step = start_step
    while True:
        yield make_batch(cfg, shape, dc, step, shard, num_shards)
        step += 1
