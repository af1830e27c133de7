"""The port's dry-run (``repro_torch.launch.dryrun``): qwen3-0.6b at 2
layers (full width) in each of its three shapes on the 16x16 and the
2x16x16 mesh, each cell run as rank 0 of a ``fake`` process group of 256
or 512 ranks on fake tensors.  Every fake-group run is a subprocess of
its own, so no later test sees that group; the three start together.

* each cell is ``ok`` and its record has every key the JAX dry-run's
  readers read (``core/features.py::features_from_record``,
  ``benchmarks/roofline.py``, ``core/workloads.py::tpu_jobs_suite``),
  and ``features_from_record`` gives 22 finite values from it;
* the argument bytes are the sum of the local shards' bytes of the
  parameters, the AdamW state, the batch, the token and the cache under
  the port's rule tables (``param_specs``, ``zero1_opt_specs``,
  ``batch_specs``, ``cache_specs``), computed here from the specs alone,
  also for mamba2-780m at 2 layers, whose Mamba2 layers compute their
  H/M heads on each rank (one subprocess of its own); its cells issue
  per Mamba2 layer forward two all-reduces (the gated norm's sum of
  squares, ``out_proj``) and gather no head-split leaf or SSM state;
* the decode cell (qwen3's 8 kv heads over 16 model ranks: the KV
  cache split over the sequence) issues per layer one all-gather of the
  q heads and one all-to-all of the partials, and holds the whole KV
  cache's bytes over M * D per device;
* ``count_params`` equals the JAX dry-run's for every arch's full config
  (JAX's side through ``jax.eval_shape`` only, in a process of its own:
  the JAX module sets 512 host devices when imported);
* the command line skips cached cells, and with ``--only-missing``
  failed ones too, and records a failing cell ``ok: false`` with its
  error.

Comparisons of ``flops_per_device`` and the argument bytes with the
JAX dry-run's compiled cells (XLA on 512 host devices), qwen3-0.6b's and
mamba2-780m's train_4k, are marked slow."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.features import TPU_FEATURE_NAMES, features_from_record
from repro_torch.launch import sharding as shd
from repro_torch.launch.dryrun import arch_train_config, count_params
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as model_lib
from repro_torch.train import optim
from repro_torch.utils.tree import flatten_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
ARCH, LAYERS = "qwen3-0.6b", 2
MAMBA = "mamba2-780m"
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k"]
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
CELLS = [(s, mp) for s in SHAPE_NAMES for mp in (False, True)]
CELL_IDS = [f"{s}-{'2x16x16' if mp else '16x16'}" for s, mp in CELLS]

#: every record key the dry-run's readers read
READ_KEYS = {
    "roofline": ("compute_s", "memory_s", "collective_s", "dominant"),
    "cost": ("flops_per_device", "hbm_bytes_per_device"),
    "memory": ("argument_bytes", "temp_bytes", "output_bytes"),
    "collectives": ("total_bytes", "bytes", "counts"),
    "hlo_ops": ("dot", "fusion", "while"),
}
TOP_KEYS = ("loops", "tokens", "params_total", "params_active", "chips",
            "kind", "shape", "ok", "arch", "mesh")

_CELLS = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch.dryrun import lower_cell
out = {}
for shape, mp in %r:
    out[f"{shape}|{mp}"] = lower_cell(sys.argv[2], shape, mp,
                                      {"num_layers": %d})[0]
json.dump(out, open(sys.argv[1], "w"))
""" % (CELLS, LAYERS)

_CLI = f"""
import contextlib, io, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch.dryrun import main
out, runs = sys.argv[1], []
base = ["--out", out, "--mesh", "single", "--override", "num_layers=1"]
for argv in (["--arch", {ARCH!r}, "--shape", "decode_32k"],
             ["--arch", {ARCH!r}, "--shape", "decode_32k"],
             ["--arch", {ARCH!r}, "--shape", "decode_1k"],
             ["--arch", {ARCH!r}, "--shape", "decode_1k", "--only-missing"],
             ["--arch", {ARCH!r}, "--shape", "decode_32k", "--only-missing"],
             ["--arch", {ARCH!r}, "--shape", "decode_1k"]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv + base)
    runs.append({{"stdout": buf.getvalue(), "results": res}})
json.dump(runs, open(out + ".runs", "w"))
"""

_JAX_COUNTS = """
import json, sys
from repro.configs import get_config
from repro.configs.registry import ARCH_IDS
from repro.launch.dryrun import count_params
from repro.models import model as jm
json.dump({a: count_params(get_config(a), jm.abstract(get_config(a)))
           for a in ARCH_IDS}, open(sys.argv[1], "w"))
"""


def _start(code, out, *args):
    return subprocess.Popen([sys.executable, "-c", code, str(out), *args],
                            cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc, timeout=300):
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {"cells": _start(_CELLS, tmp / "cells.json", ARCH),
             "mamba": _start(_CELLS, tmp / "mamba.json", MAMBA),
             "cli": _start(_CLI, tmp / "cli.json"),
             "jax": _start(_JAX_COUNTS, tmp / "jax.json")}
    for p in procs.values():
        _wait(p)
    return {"cells": json.load(open(tmp / "cells.json")),
            "mamba": json.load(open(tmp / "mamba.json")),
            "cli": json.load(open(tmp / "cli.json.runs")),
            "jax": json.load(open(tmp / "jax.json"))}


def _cfg(arch=ARCH):
    return get_config(arch).replace(num_layers=LAYERS)


def _local_bytes(tree, specs, mesh: dict) -> int:
    """Bytes of the local shard of each leaf of ``tree`` under ``specs``
    on a mesh of axis sizes ``mesh``."""
    total = 0
    for (_, t), (_, s) in zip(flatten_with_paths(tree),
                              flatten_with_paths(specs), strict=True):
        n = t.numel() * t.element_size()
        for part in s:
            for a in (part if isinstance(part, tuple) else (part,)):
                if a is not None:
                    assert n % mesh[a] == 0
                    n //= mesh[a]
        total += n
    return total


def _want_argument_bytes(shape_name: str, multi_pod: bool,
                         arch: str = ARCH) -> int:
    cfg, shape = _cfg(arch), SHAPES[shape_name]
    mesh = MeshShape(MESHES[multi_pod])
    specs = input_specs(cfg, shape)
    params = model_lib.abstract(cfg)
    if shape.kind == "train":
        opt = optim.abstract_opt_state(params, arch_train_config(arch))
        ps = shd.param_specs(cfg, params, mesh, kind="train")
        zs = shd.zero1_opt_specs(ps, params, mesh)
        return (_local_bytes(params, ps, mesh.shape)
                + _local_bytes(opt, optim.OptState(m=zs, v=zs,
                                                   count=shd.P()),
                               mesh.shape)
                + _local_bytes(specs, shd.batch_specs(specs, mesh),
                               mesh.shape))
    ps = shd.param_specs(cfg, params, mesh, kind="serve")
    if shape.kind == "prefill":
        return (_local_bytes(params, ps, mesh.shape)
                + _local_bytes(specs, shd.batch_specs(specs, mesh),
                               mesh.shape))
    ba = shd.batch_axes(mesh, shape.global_batch)
    return (_local_bytes(params, ps, mesh.shape)
            + _local_bytes(specs["token"], shd.P(ba, None), mesh.shape)
            + _local_bytes(specs["cache"],
                           shd.cache_specs(cfg, specs["cache"], mesh),
                           mesh.shape))


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_each_cell_is_ok_with_every_key_the_readers_read(runs, cell):
    shape_name, mp = cell
    rec = runs["cells"][f"{shape_name}|{mp}"]
    assert rec["ok"] and rec["kind"] == SHAPES[shape_name].kind
    assert rec["chips"] == (512 if mp else 256)
    assert rec["mesh"] == ("2x16x16" if mp else "16x16")
    for k in TOP_KEYS:
        assert k in rec, k
    for group, keys in READ_KEYS.items():
        for k in keys:
            assert k in rec[group], (group, k)
    # the JAX record's other keys, kept
    for k in ("alias_bytes", "peak_bytes"):
        assert k in rec["memory"]
    for k in ("xla_flops_raw", "xla_bytes_raw"):
        assert k in rec["cost"]
    assert set(rec["timing"]) == {"lower_s", "compile_s"}
    assert rec["bytes_by_op"] and rec["cost"]["flops_per_device"] > 0
    phases = ("forward", "backward") if shape_name == "train_4k" \
        else ("forward",)
    assert rec["loops"] == [{"name": "layers", "trip": LAYERS, "phase": ph}
                            for ph in phases]


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_features_from_a_port_record_are_22_finite_values(runs, cell):
    rec = runs["cells"][f"{cell[0]}|{cell[1]}"]
    f = features_from_record(rec)
    assert f.shape == (len(TPU_FEATURE_NAMES),) == (22,)
    assert np.all(np.isfinite(f))


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_argument_bytes_are_the_local_shards_under_the_rule_tables(runs,
                                                                   cell):
    rec = runs["cells"][f"{cell[0]}|{cell[1]}"]
    assert rec["memory"]["argument_bytes"] == _want_argument_bytes(*cell)


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_mamba2_argument_bytes_are_the_local_shards_under_the_rule_tables(
        runs, cell):
    rec = runs["mamba"][f"{cell[0]}|{cell[1]}"]
    assert rec["ok"] and rec["arch"] == MAMBA
    assert rec["memory"]["argument_bytes"] == _want_argument_bytes(
        *cell, arch=MAMBA)


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_the_mamba2_cells_compute_their_heads(runs, cell):
    """48 SSM heads over 16 model ranks: per Mamba2 layer forward one
    all-reduce for the gated norm's sum of squares and one for
    ``out_proj`` (the 50,280-row embedding and LM head do not split over
    16 ranks: computed whole, they add none); the train step's backward
    adds the norm's second sum and the input's gradient, and the step
    its gradient sums.  Every step gathers ``in_proj``, ``conv_w`` and
    ``conv_b`` (their column runs cross the packed boundaries), a
    prefill also its conv state's x channels on the way out, a decode
    step the conv state on the way in too; never a head-split leaf or
    the SSM state."""
    shape_name, mp = cell
    rec = runs["mamba"][f"{shape_name}|{mp}"]
    counts = rec["collectives"]["counts"]
    if shape_name == "train_4k":
        assert counts["all-reduce"] >= 4 * LAYERS
        assert counts["all-gather"] == 3
    else:
        assert counts["all-reduce"] == 2 * LAYERS
        assert counts["all-gather"] == (4 if shape_name == "prefill_32k"
                                        else 5)


@pytest.mark.parametrize("mp", [False, True], ids=["16x16", "2x16x16"])
def test_the_sequence_split_decode_cell(runs, mp):
    """qwen3's 8 kv heads over 16 model ranks: each rank holds every kv
    head of 2,048 of the 32,768 slots of its rows; per layer one q
    all-gather and one all-to-all of (o, lse) for its heads."""
    rec = runs["cells"][f"decode_32k|{mp}"]
    cfg, shape = _cfg(), SHAPES["decode_32k"]
    M, D = 16, 32 if mp else 16
    whole_kv = 2 * LAYERS * shape.global_batch * shape.seq_len \
        * cfg.num_kv_heads * cfg.head_dim * 2
    # the cache is written in place: its local bytes are the aliased ones
    assert rec["memory"]["alias_bytes"] == whole_kv // (M * D)
    counts, by = rec["collectives"]["counts"], rec["collectives"]["bytes"]
    assert counts["all-to-all"] == LAYERS
    # wk / wv gathered (the replicated kv route) and the q heads per layer
    assert counts["all-gather"] == 2 + LAYERS
    rows = shape.global_batch // D
    assert by["all-to-all"] == LAYERS * rows * cfg.num_heads \
        * (cfg.head_dim + 1) * 4


def test_count_params_equals_the_jax_dry_runs(runs):
    assert sorted(runs["jax"]) == sorted(ARCH_IDS)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert count_params(cfg, model_lib.abstract(cfg)) \
            == runs["jax"][arch], arch


def test_cached_cells_are_skipped(runs):
    first, second = runs["cli"][:2]
    assert "=== qwen3-0.6b|decode_32k|single ===" in first["stdout"]
    assert "skip qwen3-0.6b|decode_32k|single (cached)" in second["stdout"]
    assert second["results"] == first["results"]


def test_a_failing_cell_is_recorded_with_its_error_and_only_missing_skips_it(
        runs):
    fail, only_missing_fail, only_missing_ok, again = runs["cli"][2:]
    rec = fail["results"]["qwen3-0.6b|decode_1k|single"]
    assert rec["ok"] is False and "decode_1k" in rec["error"]
    assert "FAIL" in fail["stdout"]
    for r in (only_missing_fail, only_missing_ok):
        assert "(cached)" in r["stdout"] and "===" not in r["stdout"]
    # without --only-missing a failed cell runs again
    assert "=== qwen3-0.6b|decode_1k|single ===" in again["stdout"]
    assert "1/2 cells ok" in again["stdout"]


_JAX_CELL = """
import json, sys
from repro.launch.dryrun import lower_cell
rec, _ = lower_cell(sys.argv[2], sys.argv[3], False, {"num_layers": 2})
json.dump(rec, open(sys.argv[1], "w"))
"""


def _jax_cell(tmp_path, arch, shape_name):
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CELL, str(tmp_path / "j.json"), arch,
         shape_name], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    _wait(proc, timeout=1800)
    return json.load(open(tmp_path / "j.json"))


@pytest.mark.slow
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
def test_flops_per_device_against_the_jax_dry_runs_compiled_cell(
        runs, tmp_path, shape_name):
    """The JAX dry-run compiles the cell with XLA for 512 host devices
    (JAX's own process, its compile as heavy as the cell), so this is
    tier 2.  The argument bytes are
    JAX's exactly.  The port computes more per device than GSPMD where it
    computes a leaf whole (qwen3's kv projections, which 16 ranks cannot
    split by whole heads; the norms), so its FLOPs are at least JAX's and
    within RTOL of them."""
    want = _jax_cell(tmp_path, ARCH, shape_name)
    got = runs["cells"][f"{shape_name}|False"]
    assert got["memory"]["argument_bytes"] \
        == want["memory"]["argument_bytes"]
    f, wf = (r["cost"]["flops_per_device"] for r in (got, want))
    assert wf <= f <= wf * (1 + RTOL), (f, wf)


#: how far above JAX's per-device FLOPs the port's may lie: measured
#: 1.14 (decode), 1.21 (prefill) and 1.35 (train) times JAX's
RTOL = 0.5


@pytest.mark.slow
def test_mamba2_flops_per_device_against_the_jax_dry_runs_compiled_cell(
        runs, tmp_path):
    """mamba2-780m's train_4k at 2 layers on 16x16: the argument bytes
    are JAX's exactly, and with each rank computing its 3 of the 48 SSM
    heads the FLOPs are within MAMBA_RTOL above JAX's (both compute the
    50,280-row LM head whole: 16 ranks do not split it)."""
    want = _jax_cell(tmp_path, MAMBA, "train_4k")
    got = runs["mamba"]["train_4k|False"]
    assert got["memory"]["argument_bytes"] \
        == want["memory"]["argument_bytes"]
    f, wf = (r["cost"]["flops_per_device"] for r in (got, want))
    assert wf <= f <= wf * (1 + MAMBA_RTOL), (f, wf)


#: measured 1.012 times JAX's (3.1765e13 against 3.1378e13 per device;
#: 1.483 while the Mamba2 layers computed whole)
MAMBA_RTOL = 0.05
