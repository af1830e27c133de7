"""Cells of the benchmark cut to a size a CPU test can hold: the same
files, the model's widths and the traffic's lengths made small."""
from __future__ import annotations

import copy

from chipbench.harness import cells

BATCH = "qwen3-moe-30b-a3b.chat-batch"
TRAIN = "qwen3-0.6b.train-16k"
#: a request's median gap is read where it was served this many tokens
MIN_TOKENS = 4
#: an open loop on the dense model, for the tests alone (no cell of the
#: benchmark serves qwen3-0.6b yet): code completions with Poisson
#: arrivals
OPEN = "qwen3-0.6b.open-loop"
OPEN_WORKLOAD = {
    "name": OPEN, "kind": "serve",
    "requests": {
        "arrivals": "poisson", "rate_per_s": 0.8, "base_seed": 302,
        "shuffle_block": 1,
        "prompt": {"median": 1536, "sigma": 0.5, "min": 256, "max": 4096},
        "output": {"median": 24, "sigma": 0.7, "min": 4, "max": 128}},
    "window": {"opens": "lead", "lead_s": 10.0},
    "profile_s": 4.0,
    "check": {"sample_tokens": 256, "most_requests": 16,
              "limits": {"logit_gap_max": 0.15}}}


def small_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, num_hidden_layers=2, vocab_size=256,
             intermediate_size=192)
    if c["model_type"] == "qwen3_moe":
        c.update(num_experts=8, num_experts_per_tok=2,
                 moe_intermediate_size=96, capacity_factor=4.0)
    c["serving"] = dict(c["serving"], max_batch=4, kv_pool_tokens=512,
                        prefill_chunk=16)
    return c


def _open_loop() -> cells.Cell:
    train = cells.load(TRAIN)
    serve = cells.load(BATCH)
    return cells.Cell(name=OPEN, chips=1, config=train.config,
                      workload=copy.deepcopy(OPEN_WORKLOAD),
                      end_to_end=serve.end_to_end,
                      per_layer=serve.per_layer)


def cell(name: str) -> cells.Cell:
    c = _open_loop() if name == OPEN else cells.load(name)
    c.config = small_config(c.config)
    wl = c.workload
    if c.kind == "serve":
        wl["requests"]["prompt"] = {"median": 40, "sigma": 0.5, "min": 8,
                                    "max": 120}
        wl["requests"]["output"] = {"median": 8, "sigma": 0.5, "min": 2,
                                    "max": 24}
        if wl["requests"]["arrivals"] == "poisson":
            wl["requests"]["rate_per_s"] = 4.0
            wl["window"]["lead_s"] = 0.5
        wl["check"]["sample_tokens"] = 96
        wl["check"]["request_min_tokens"] = MIN_TOKENS
    else:
        wl["batches"] = {"batch": 2, "seq": 32}
    return c
