"""Architectures, one module each, found by the ``model_type`` of a
configuration file.  A module names the ``model_type`` values it claims
(``MODEL_TYPES``) and gives:

* ``model_config(config, training=False, **overrides)``: the port's
  config object for a configuration file (with ``training``, the file's
  training settings);
* ``reference``: the plain float32 reference module the check runs.  It
  offers ``Dims.of(config)``, ``served_gaps(params, dm, prompts, served,
  device, quant=False)``, and for the training path ``no_tf32()``,
  ``all_layers(blocks)``, ``block(x, w, dm, quant)``, ``head_weight(
  params, dm)`` and ``final_logits(h, final_w, head, dm, quant)``;
  ``quant=True`` is the control (the reference in fp8);
* ``forward_flops(cfg, rows, logits_rows)`` and ``train_step_flops(cfg,
  batch, seq)``: the useful FLOPs that ``mfu.*`` counts.

A module added to this package is found with no edit of any file."""
from __future__ import annotations

import importlib
import pkgutil
from types import ModuleType
from typing import Dict


def claims() -> Dict[str, ModuleType]:
    """model_type -> the module that claims it, over every module of the
    package; a model_type claimed twice is refused."""
    out: Dict[str, ModuleType] = {}
    for info in sorted(pkgutil.iter_modules(__path__), key=lambda m: m.name):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        for t in mod.MODEL_TYPES:
            if t in out:
                raise ValueError(f"model_type {t!r} is claimed by both "
                                 f"{out[t].__name__} and {mod.__name__}")
            out[t] = mod
    return out


def for_config(config: dict) -> ModuleType:
    """The architecture module of a configuration file."""
    found = claims()
    t = config["model_type"]
    if t not in found:
        raise ValueError(f"no module under chipbench/archs/ claims "
                         f"model_type {t!r} (claimed: "
                         f"{', '.join(sorted(found))})")
    return found[t]
