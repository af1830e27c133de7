"""A cell, found by its name: its entry in ``BENCHMARK.json``, its
configuration file, its workload file under ``chipbench/workloads/`` and
the metrics that name it.  Nothing here is specific to one cell."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

from chipbench import archs

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
    """The port's config object of a configuration file, by its
    architecture's module (``chipbench/archs/``)."""
    return archs.for_config(config).model_config(config, training,
                                                 **overrides)
