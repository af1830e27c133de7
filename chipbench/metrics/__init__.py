"""One reader per per-layer quantity: ``read(rec)`` returns the metric's
value from a run's record, or None where the run holds nothing to read.
Metric ``<quantity>.<cell suffix>`` is read by ``<quantity>.<cell
suffix>.py`` where that file exists, else by ``<quantity>.py``."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of metric ``name`` (found by its file)."""
    path = HERE / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise SystemExit(f"no reader for metric {name!r} under {HERE}")
    spec = importlib.util.spec_from_file_location(
        f"chipbench.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
