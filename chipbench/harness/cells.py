"""A cell, found by its name: its entry in ``BENCHMARK.json``, its
configuration file, its workload file under ``chipbench/workloads/`` and
the metrics that name it.  Nothing here is specific to one cell."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

#: the checkout's root (``chipbench/`` lies in it)
ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file, as it is run
    workload: dict      # the cell's file under chipbench/workloads/
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.workload["kind"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json "
                         f"(cells: {', '.join(sorted(cells))})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"])
                        .read_text())
    workload = json.loads((root / "chipbench" / "workloads"
                           / f"{name}.json").read_text())
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                workload=workload,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def model_config(config: dict, training: bool = False, **overrides):
    """The port's ``ModelConfig`` of a qwen3 / qwen3_moe configuration
    file (the keys of the published ``config.json``); with ``training``,
    the file's training settings (parameter dtype, recomputation)."""
    from repro_torch.configs.base import ModelConfig
    moe = config["model_type"] == "qwen3_moe"
    if config["model_type"] not in ("qwen3", "qwen3_moe"):
        raise ValueError(f"no mapping for {config['model_type']!r}")
    kw = dict(
        name=config["name"], family="moe" if moe else "dense",
        num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"],
        d_ff=0 if moe else config["intermediate_size"],
        vocab_size=config["vocab_size"],
        use_qk_norm=True, rope_theta=float(config["rope_theta"]),
        tie_embeddings=bool(config["tie_word_embeddings"]),
        norm_eps=float(config["rms_norm_eps"]),
        act=config["hidden_act"],
        param_dtype=config["torch_dtype"],
        compute_dtype=config["torch_dtype"])
    if moe:
        kw.update(num_experts=config["num_experts"],
                  experts_per_token=config["num_experts_per_tok"],
                  moe_d_ff=config["moe_intermediate_size"],
                  capacity_factor=float(config["capacity_factor"]))
    if training:
        kw.update(param_dtype=config["training"]["param_dtype"],
                  remat=config["training"]["remat"])
    kw.update(overrides)
    return ModelConfig(**kw)
