"""Cells, configurations and metrics are files found by name: a cell
added in a copy of the benchmark is found with no edit of the harness."""
import json
import re
import shutil
from pathlib import Path

import pytest

from chipbench.harness import cells
from chipbench.metrics import reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert NAME.match(c["name"])
    for w in BENCH["workloads"]:
        cell = cells.load(w["name"])
        assert cell.workload["name"] == w["name"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert callable(reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "qwen3-0.6b"])
def test_config_maps_to_the_port_s(name):
    """The configuration file is the port's registered architecture, at
    the MoE's dropless capacity."""
    from repro_torch.configs import get_config
    config = json.loads((ROOT / f"chipbench/configs/{name}.json")
                        .read_text())
    mine = cells.model_config(config)
    port = get_config(name)
    if port.family == "moe":
        port = port.replace(capacity_factor=port.num_experts
                            / port.experts_per_token)
    assert mine == port


def test_a_cell_added_in_a_copy_is_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    new = "qwen3-0.6b.chat-batch"
    bench["workloads"].append({"name": new, "config": "qwen3-0.6b",
                               "traffic": "chat-batch", "chips": 1,
                               "why": "the chat backlog on the small model"})
    for m in bench["end_to_end"]:
        if m["name"] in ("output_tok_s", "itl_p95_ms"):
            m["workloads"].append(new)
    bench["per_layer"].append({
        "name": "decode_rows_mean.small", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "engine", "moves":
        "output_tok_s", "workloads": [new]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = json.loads((ROOT / "chipbench/workloads/"
                     "qwen3-moe-30b-a3b.chat-batch.json").read_text())
    wl["name"] = new
    (tmp_path / f"chipbench/workloads/{new}.json").write_text(
        json.dumps(wl))
    cell = cells.load(new, root=tmp_path)
    assert cell.config["name"] == "qwen3-0.6b"
    assert {m["name"] for m in cell.end_to_end} == {
        "output_tok_s", "itl_p95_ms", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["decode_rows_mean.small"]
    assert cells.load("qwen3-0.6b.train-16k", root=tmp_path).per_layer
    # the new metric is read by its quantity's reader: no file added
    assert reader("decode_rows_mean.small").__code__.co_filename \
        .endswith("decode_rows_mean.py")
