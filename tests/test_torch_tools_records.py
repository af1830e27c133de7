"""The port's record tools (``repro_torch.tools.roofline`` and
``colocation``) against the JAX package's ``benchmarks/roofline.py`` and
``benchmarks/tpu_colocation.py``.

* roofline over the port's dry-run records of two qwen3-0.6b cells (2
  layers, 16x16 mesh; written by ``repro_torch.launch.dryrun`` in a
  process of its own, as ``test_torch_dryrun.py`` writes its cells): each
  cell's ``useful_flops_ratio`` equals JAX's ``model_flops`` over the
  same record, its ``roofline_fraction`` the JAX formula's times 197e12 /
  989e12 (the v5e's bf16 peak against the H100's), and no records print
  ``SKIPPED``;
* colocation at ``REPRO_BENCH_SMOKE=1`` with no dry-run records: every
  scenario's STP, ANTT reduction, OOMs and binding axes equal the JAX
  tool's (run in a process of its own, so each side's ``results/`` is a
  temporary directory), though the port's pods are 256 H100s of 80 GiB
  allocated a card at a time and JAX's 4,096 GB allocated 64 GB at a
  time; and ``tpu_jobs_suite`` gives every job the same weight GB and
  per-ktoken GB on both sides.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks.roofline import model_flops as jax_model_flops
from repro.core import tpu_jobs_suite as jax_jobs_suite
from repro.launch.mesh import PEAK_FLOPS_BF16 as V5E_PEAK
from repro_torch.core import tpu_jobs_suite
from repro_torch.launch.mesh import PEAK_FLOPS_BF16
from repro_torch.tools import colocation, common, roofline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
ENV.pop("REPRO_ESTIMATOR", None)

_CELLS = """
import sys
import torch
torch.set_num_threads(1)
from repro_torch.launch.dryrun import main
for shape in ("train_4k", "decode_32k"):
    main(["--arch", "qwen3-0.6b", "--shape", shape, "--mesh", "single",
          "--override", "num_layers=2", "--out", sys.argv[1]])
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "dryrun.json"
    res = subprocess.run([sys.executable, "-c", _CELLS, str(path)],
                         cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return path


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def test_roofline_matches_jax_formula(records, results, capsys):
    out = roofline.main(["--dryrun", str(records)])
    recs = json.loads(records.read_text())
    assert sorted(k for k in out if k != "summary") == sorted(recs)
    for key, rec in recs.items():
        assert rec["ok"], rec.get("error")
        r, got = rec["roofline"], out[key]
        step = max(r["compute_s"], r["memory_s"], r["collective_s"])
        hlo = rec["cost"]["flops_per_device"] * rec["chips"]
        mf = jax_model_flops(rec)
        assert got["model_flops"] == mf
        assert got["useful_flops_ratio"] == pytest.approx(mf / hlo,
                                                          rel=1e-12)
        jax_frac = mf / (rec["chips"] * V5E_PEAK) / step
        assert got["roofline_fraction"] == pytest.approx(
            jax_frac * V5E_PEAK / PEAK_FLOPS_BF16, rel=1e-12)
        assert np.isfinite(got["roofline_fraction"])
    assert PEAK_FLOPS_BF16 == 989e12 and V5E_PEAK == 197e12
    assert out["summary"]["cells"] == 2
    saved = json.loads((results / "bench_torch_roofline.json").read_text())
    assert saved["summary"]["cells"] == 2
    assert "roofline_median_fraction," in capsys.readouterr().out


def test_roofline_skips_without_records(results, capsys):
    assert roofline.main(["--dryrun", str(results / "none.json")]) == {}
    assert "roofline,SKIPPED" in capsys.readouterr().out


def _scenarios(payload):
    out = {k: payload[k] for k in ("ours", "oracle", "pairwise")}
    for scen in ("multiaxis", "netaxis"):
        out.update({f"{scen}/{k}": v for k, v in payload[scen].items()})
    return out


def test_colocation_smoke_equals_jax(results, tmp_path_factory):
    jax_dir = tmp_path_factory.mktemp("jax_results")
    proc = subprocess.Popen(
        [sys.executable, "-m", "benchmarks.tpu_colocation"], cwd=ROOT,
        env=dict(ENV, REPRO_RESULTS=str(jax_dir), REPRO_BENCH_SMOKE="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    mine = colocation.main(["--smoke", "--dryrun",
                            str(results / "none.json")])
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    theirs = json.loads((jax_dir / "bench_tpu_colocation.json").read_text())
    mine = json.loads(json.dumps(mine, default=float))
    assert _scenarios(mine) == _scenarios(theirs)
    assert mine["multiaxis"]["ours"]["binding_axes"]["host_ram"] > 0
    assert mine["netaxis"]["ours"]["binding_axes"]["net"] > 0
    assert (results / "bench_torch_colocation.json").exists()


def test_colocation_pod_is_h100s():
    assert colocation.CARD_GB == 80.0
    assert colocation.RANKS_PER_POD == 256
    assert colocation.POD_GB == 256 * 80.0


def test_jobs_suite_same_curves_as_jax():
    mine, theirs = tpu_jobs_suite(), jax_jobs_suite()
    assert [j.name for j in mine] == [j.name for j in theirs]
    for a, b in zip(mine, theirs):
        assert (a.true_fn.family, a.true_fn.m, a.true_fn.b) == \
            (b.true_fn.family, b.true_fn.m, b.true_fn.b), a.name
        assert a.cpu_load == b.cpu_load and a.rate == b.rate
        np.testing.assert_array_equal(a.features, b.features)
