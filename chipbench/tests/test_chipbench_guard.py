"""What a run refuses, and what it may not load: no module whose
top-level name (compared whole) is JAX's or the JAX package's; the
reference loads nothing of the program."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from chipbench.harness import guard

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_compares_whole_top_level_names():
    names = ["repro_torch", "repro_torch.serve", "reproducible", "jax",
             "jax.numpy", "jaxlib.xla", "repro", "repro.models", "flax",
             "benchmarks.run", "chipbench.harness"]
    assert guard.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "repro", "repro.models", "flax",
         "benchmarks.run"])


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)


def test_harness_and_program_load_no_jax():
    """Every module of the benchmark and the program paths it drives,
    imported in a fresh process, load no forbidden module."""
    code = (
        "import importlib, pathlib, sys\n"
        "for p in sorted(pathlib.Path('chipbench').rglob('*.py')):\n"
        "    if 'tests' in p.parts or p.name in ('run.py', 'sweep.py',"
        " 'calibrate.py') or '.' in p.stem: continue\n"
        "    importlib.import_module('.'.join(p.with_suffix('').parts)"
        ".replace('.__init__', ''))\n"
        "import repro_torch.serve, repro_torch.sched, repro_torch.train.step\n"
        "import repro_torch.kernels.rmsnorm.kernel\n"
        "from chipbench.harness import guard\n"
        "print(guard.forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_loads_nothing_of_the_program():
    out = _python("import sys\n"
                  "import chipbench.reference.qwen3, chipbench.reference.train\n"
                  "import chipbench.reference.compare\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip()))
    assert not tops & {"repro_torch", "repro", "jax"}


def test_run_refuses_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         "qwen3-0.6b.train-16k", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_run_refuses_in_a_tree_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's own
    files: no program to run, non-zero, no result."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload",
         bench["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")


def test_require_clean_exits_when_jax_is_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["os"])
    with pytest.raises(SystemExit):
        guard.require_clean()
