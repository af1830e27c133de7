"""Boundaries of the PyTorch port.

* Isolation: no module of ``src/repro_torch`` (and not ``chip_smoke.py``)
  imports ``jax`` or anything of the JAX package ``repro``.
* Copy drift: the numpy control plane is a verbatim copy of the JAX
  package's with only ``repro.`` -> ``repro_torch.`` applied; the ported
  files keep every top-level definition of their original the same way,
  apart from the named exceptions.  A fix to the JAX control plane
  therefore cannot leave the port silently behind.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
JAX = SRC / "repro"


def _prefix(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_pulls_in_no_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


# --- copy drift -------------------------------------------------------------

VERBATIM = sorted(
    [p.relative_to(JAX) for p in (JAX / "core").glob("*.py")
     if p.name != "features.py"]
    + [p.relative_to(JAX) for d in ("sched", "obs")
       for p in (JAX / d).glob("*.py")]
    + [Path("serve") / f for f in ("request.py", "queue.py", "batcher.py",
                                   "engine.py", "metrics.py")]
    + [p.relative_to(JAX) for p in (JAX / "configs").glob("*.py")
       if p.name not in ("registry.py", "__init__.py")]
    + [Path("data") / "pipeline.py"])


@pytest.mark.parametrize("rel", VERBATIM, ids=str)
def test_verbatim_copy_has_not_drifted(rel):
    assert (PORT / rel).read_text() == _prefix((JAX / rel).read_text()), \
        f"{rel}: re-copy from src/repro with repro. -> repro_torch."


def _rewritten(*names):
    """Names the port keeps under the same name, rewritten for PyTorch."""
    return {n: n for n in names}


#: original file -> {original name: port name or None (left out)}; every
#: other top-level name must be in the port verbatim (``repro.`` ->
#: ``repro_torch.`` applied)
PORTED = {
    "serve/backends.py": {"JaxBackend": "TorchBackend"},
    "serve/paged.py": {"PagedJaxBackend": "TorchPagedBackend"},
    "serve/__init__.py": {"JaxBackend": "TorchBackend",
                          "PagedJaxBackend": "TorchPagedBackend"},
    "configs/registry.py": _rewritten("input_specs", "concrete_inputs"),
    "configs/__init__.py": {},
    # TPU_FEATURE_NAMES, _safe_log and features_from_record are verbatim
    "core/features.py": _rewritten("extract_features"),
    "launch/serve.py": {"main": "main"},
    "launch/train.py": {"main": "main"},
    "train/step.py": _rewritten(
        "build_loss_fn", "build_train_step", "build_train_step_compressed",
        "build_prefill_step", "build_decode_step", "build_paged_decode_step",
        "build_prefill_chunk_step", "build_serve_step"),
    "train/loss.py": _rewritten("_ce_from_hidden", "lm_loss"),
    "train/optim.py": _rewritten(
        "OptState", "init_opt_state", "abstract_opt_state", "cosine_schedule",
        "global_norm", "clip_by_global_norm", "adamw_update"),
    "train/compression.py": _rewritten(
        "init_error_buffer", "quantize_int8", "dequantize_int8",
        "compress_grads_ef"),
    # save, _gc and latest_step are verbatim
    "checkpoint/checkpoint.py": _rewritten("_to_numpy_tree", "restore",
                                           "AsyncCheckpointer"),
}


def _definitions(path: Path):
    """Top-level defs, classes and assignments -> their source."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.get_source_segment(text, node)
    return out


def _exported(path: Path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


@pytest.mark.parametrize("rel", sorted(PORTED))
def test_ported_file_keeps_original_definitions(rel):
    exempt = PORTED[rel]
    orig, port = JAX / rel, PORT / rel
    if rel.endswith("__init__.py"):
        want = {exempt.get(n, n) for n in _exported(orig)} - {None}
        assert _exported(port) == want
        return
    odefs, pdefs = _definitions(orig), _definitions(port)
    for name, src in odefs.items():
        if name in exempt:
            new = exempt[name]
            assert new is None or new in pdefs, (rel, name, new)
            continue
        assert name in pdefs, f"{rel}: port lost {name}"
        assert pdefs[name] == _prefix(src), \
            f"{rel}: {name} drifted from the JAX package's"
