"""Architectures and kernel families are files found by name: each
configuration's ``model_type`` finds its module under ``chipbench/archs/``
(the port's config, the reference, the FLOP count), each kernel family
its module under ``chipbench/roofline/families/``.  The accepted
configurations map, count and bound exactly as before the lookup, and a
second architecture with a kernel family of its own joins a copy of the
benchmark with new files and appended ``BENCHMARK.json`` entries
only."""
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from chipbench import archs
from chipbench.harness import cells
from chipbench.roofline import kernels

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / f"chipbench/configs/{name}.json").read_text())


# --- (a) the lookup -------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "qwen3-0.6b"])
def test_each_configuration_finds_qwen3_s_module(name):
    arch = archs.for_config(_config(name))
    assert arch.__name__ == "chipbench.archs.qwen3"
    assert arch.reference.__name__ == "chipbench.reference.qwen3"
    for fn in ("model_config", "forward_flops", "train_step_flops"):
        assert callable(getattr(arch, fn))


def test_an_unclaimed_model_type_is_refused_with_the_claimed_ones():
    with pytest.raises(ValueError, match=r"'deepseek_v2'.*claimed: qwen3, "
                                         r"qwen3_moe"):
        archs.for_config(dict(_config("qwen3-0.6b"),
                              model_type="deepseek_v2"))


# --- (b) the accepted configurations, as before the lookup ----------------
# Values computed before the architecture modules and family files
# existed (cells.model_config, roofline/model_flops.py and
# roofline/kernels.py as they were).

#: the port config's fields that the configuration file sets
PORT = {
    "qwen3-moe-30b-a3b": dict(
        name="qwen3-moe-30b-a3b", family="moe", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=4, head_dim=128, d_ff=0,
        vocab_size=151936, num_experts=128, experts_per_token=8,
        moe_d_ff=768, capacity_factor=16.0, use_qk_norm=True,
        rope_theta=1e6, tie_embeddings=False, norm_eps=1e-6, act="silu",
        param_dtype="bfloat16", compute_dtype="bfloat16"),
    "qwen3-0.6b": dict(
        name="qwen3-0.6b", family="dense", num_layers=28, d_model=1024,
        num_heads=16, num_kv_heads=8, head_dim=128, d_ff=3072,
        vocab_size=151936, use_qk_norm=True, rope_theta=1e6,
        tie_embeddings=True, norm_eps=1e-6, act="silu",
        param_dtype="bfloat16", compute_dtype="bfloat16"),
}
#: forward FLOPs at ROWS (4 logits rows) and at 16 decode rows at 700,
#: a train step's at 16 x 1,024
ROWS = [(0, 32), (100, 32), (511, 17), (2000, 1)]
FLOPS = {"qwen3-moe-30b-a3b": (462162755584.0, 106153639936.0,
                               318817569865728.0),
         "qwen3-0.6b": (76933464064.0, 21644181504.0, 64365722075136.0)}
#: least ms of a chunk call and a decode call, and of a train step, at
#: the launches of ``_launches``
LEAST_MS = {"qwen3-moe-30b-a3b": (0.3745944835820895, 0.3875630614925373,
                                  38.36309809671641),
            "qwen3-0.6b": (0.12217053611940298, 0.43884700656716413,
                           12.690955004179104)}
LENS = [1, 17, 300, 2816] * 4


def _launches(L):
    pre = {"rmsnorm_fwd": 1, "add_rmsnorm_fwd": 2 * L, "qk_norm_rope_fwd": L}
    train = {"rmsnorm_fwd": 2, "add_rmsnorm_fwd": 4 * L,
             "qk_norm_rope_fwd": 2 * L, "rmsnorm_bwd": 1,
             "add_rmsnorm_bwd": 2 * L, "qk_norm_rope_bwd": L}
    return pre, dict(pre, paged_attention_fwd=L), train


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "qwen3-0.6b"])
def test_port_config_is_the_parent_s(name):
    from repro_torch.configs.base import ModelConfig
    config = _config(name)
    assert dataclasses.asdict(cells.model_config(config)) == \
        dataclasses.asdict(ModelConfig(**PORT[name]))
    if "training" in config:
        # bf16 parameters, every layer recomputed: the defaults
        assert cells.model_config(config, training=True) == \
            ModelConfig(**PORT[name])


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "qwen3-0.6b"])
def test_flops_and_least_times_are_the_parent_s(name):
    config = _config(name)
    arch = archs.for_config(config)
    cfg = arch.model_config(config)
    fwd, dec, step = FLOPS[name]
    assert arch.forward_flops(cfg, ROWS, 4) == fwd
    assert arch.forward_flops(cfg, [(700, 1)] * 16, 16) == dec
    assert arch.train_step_flops(cfg, 16, 1024) == step
    pre, decode, train = _launches(cfg.num_layers)
    want_pre, want_dec, want_train = LEAST_MS[name]
    shape = kernels.CallShape("prefill", 16, 32, [(0, 32)] * 8, [], 16)
    assert kernels.serving_call_ms(cfg, shape, pre) == want_pre
    shape = kernels.CallShape("decode", 16, 32, [(n - 2, 1) for n in LENS],
                              LENS, 16)
    assert kernels.serving_call_ms(cfg, shape, decode) == want_dec
    # summed over the families in the order of their files: within one
    # rounding of the sum in the old order
    assert kernels.train_step_ms(cfg, 16, 1024, train) == \
        pytest.approx(want_train, rel=1e-15)


# --- (c) a second architecture, added in a copy ---------------------------

ARCH = '''"""A dense architecture of its own model_type, mapped as qwen3."""
from chipbench.archs import qwen3
from chipbench.archs.qwen3 import (  # noqa: F401
    forward_flops, reference, train_step_flops)

MODEL_TYPES = ("toy_dense",)


def model_config(config, training=False, **overrides):
    return qwen3.model_config(dict(config, model_type="qwen3"), training,
                              **overrides)
'''

FAMILY = '''"""The dense decode kernel, at a fixed least time a launch."""
PATTERN = r"dense_decode_split_kernel"
ENTRIES = {"decode_attention_fwd":
           "repro_torch.kernels.decode_attention.kernel"}


def serving_ms(cfg, call, launches):
    return 0.001 * launches.get("decode_attention_fwd", 0)
'''

DUPLICATE = 'MODEL_TYPES = ("qwen3",)\n'

CHECK = r'''
import importlib, json, sys
from chipbench import archs
from chipbench.harness import cells, serve
from chipbench.harness.counters import Counters
from chipbench.metrics import reader
from chipbench.reference.compare import judge
from chipbench.roofline import kernels
from chipbench.tests import smoke

cell = cells.load("toy-dense.chat-batch")
arch = archs.for_config(cell.config)
assert arch.__name__ == "chipbench.archs.toy_dense", arch
assert {m["name"] for m in cell.end_to_end} == {
    "output_tok_s", "itl_p95_ms", "setup_s"}
cfg = arch.model_config(cell.config)
assert cfg.name == "toy-dense" and cfg.num_layers == 28
assert "dense_decode" in kernels.KERNEL_FAMILIES
assert "decode_attention_fwd" in Counters().snapshot()
shape = kernels.CallShape("decode", 4, 32, [(5, 1)] * 4, [7] * 4, 16)
base = {"paged_attention_fwd": 28}
got = kernels.serving_call_ms(cfg, shape, dict(base, decode_attention_fwd=3))
assert abs(got - kernels.serving_call_ms(cfg, shape, base) - 0.003) < 1e-12

small = smoke.cell("toy-dense.chat-batch")
small.workload["check"].update(sample_tokens=48)
rec, rd = serve.run(small, 11, 2.0, False, device="cpu")
assert rec.arch is arch
print(json.dumps({"correct": judge(rd["numbers"],
                                   small.workload["check"]["limits"]),
                  "mfu": reader("mfu.batch")(rec),
                  "tokens": sum(len(s) for s in rd["sample"]["served"])}))

open("chipbench/archs/qwen3_again.py", "w").write(sys.argv[1])
importlib.invalidate_caches()
try:
    archs.for_config(cell.config)
except ValueError as e:
    assert "claimed by both" in str(e), e
    print("refused twice claimed")
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_second_architecture_joins_with_new_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "chipbench")
    new = "toy-dense.chat-batch"
    config = dict(_config("qwen3-0.6b"), name="toy-dense",
                  model_type="toy_dense")
    workload = json.loads((ROOT / "chipbench/workloads/"
                           "qwen3-moe-30b-a3b.chat-batch.json").read_text())
    workload["name"] = new
    added = {"configs/toy-dense.json": json.dumps(config),
             f"workloads/{new}.json": json.dumps(workload),
             "archs/toy_dense.py": ARCH,
             "roofline/families/dense_decode.py": FAMILY}
    for rel, text in added.items():
        (tmp_path / "chipbench" / rel).write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy-dense", "source": "https://example.org/toy-dense",
        "file": "chipbench/configs/toy-dense.json", "reduced": [],
        "why": "a second architecture"})
    bench["workloads"].append({"name": new, "config": "toy-dense",
                               "traffic": "chat-batch", "chips": 1,
                               "why": "the chat backlog on it"})
    for m in bench["end_to_end"]:
        if m["name"] in ("output_tok_s", "itl_p95_ms"):
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", CHECK, DUPLICATE],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    *_, line, refused = out.stdout.strip().splitlines()
    result = json.loads(line)
    assert result["correct"] and result["tokens"] > 0
    assert 0 < result["mfu"] < 100
    assert refused == "refused twice claimed"
    # no file the copy had was edited
    after = _digests(tmp_path / "chipbench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(added) | {
        "archs/qwen3_again.py"}
