"""Parameter specification system.

Models declare their parameters as a nested dict of ``P`` specs (shape +
init rule).  The same spec tree produces either

* ``device="meta"`` tensors (abstract: shapes and dtypes, no allocation),
* initialized tensors from a ``torch.Generator`` (same init rules as the
  JAX package, different random numbers), or
* tensors bridged bit for bit from a JAX param tree (``from_jax``),

so the abstract and concrete paths can never drift apart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}


def torch_dtype(name) -> torch.dtype:
    """Config dtype name (``"bfloat16"``) -> ``torch.dtype``."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


@dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed | small
    axis: int = -2        # fan-in axis for fan_in init
    scale: Optional[float] = None
    dtype: Optional[str] = None


def _map_specs(fn, tree):
    """Apply ``fn`` to every ``P`` leaf, dict keys in sorted order (the
    leaf order of ``jax.tree.flatten``)."""
    if isinstance(tree, P):
        return fn(tree)
    return {k: _map_specs(fn, tree[k]) for k in sorted(tree)}


def _init_leaf(spec: P, generator: torch.Generator, dtype,
               device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype or dtype)
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 1.0
    elif spec.init == "small":
        std = spec.scale if spec.scale is not None else 0.02
    else:  # fan_in (default): std = scale / sqrt(fan_in)
        fan_axis = spec.axis if spec.axis >= 0 else len(shape) + spec.axis
        fan_in = shape[fan_axis] if shape else 1
        std = ((spec.scale if spec.scale is not None else 1.0)
               / np.sqrt(max(fan_in, 1)))
    if len(shape) < 3:
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(device=device, dtype=dt)
    # a stacked [L, ...] leaf is drawn one leading slice at a time into a
    # tensor of the target dtype, so the fp32 draw never exceeds a slice
    # (qwen3-moe's w_gate whole would be 38.7 GB of fp32)
    out = torch.empty(shape, dtype=dt, device=device)
    for i in range(shape[0]):
        x = torch.randn(shape[1:], generator=generator, dtype=torch.float32,
                        device=generator.device)
        out[i] = x * std
    return out


def abstract_params(spec_tree, dtype: str):
    """Spec tree -> ``device="meta"`` tensor tree (no allocation)."""
    return _map_specs(
        lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype or dtype),
                              device="meta"),
        spec_tree)


def init_params(spec_tree, generator: torch.Generator, dtype: str,
                device) -> dict:
    """Spec tree -> initialized tensor tree on ``device``.  The numbers
    come from ``generator`` (drawn on its own device), leaf by leaf in
    sorted-key order, a leaf of three or more dims one leading slice at a
    time (peak fp32 scratch: one layer's slice of the largest weight)."""
    return _map_specs(
        lambda s: _init_leaf(s, generator, dtype, device), spec_tree)


def _leaf_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":   # ml_dtypes: no torch.from_numpy path
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax(tree) -> dict:
    """Bridge a JAX param tree, given as numpy arrays (a nested dict whose
    leaves are ``np.ndarray``; bf16 leaves are ``ml_dtypes.bfloat16``),
    to the port's dict of CPU tensors: same keys, same layouts (``wq``
    stays ``[d, Hq*hd]``, layers stay stacked ``[L, ...]``), bit for
    bit."""
    if isinstance(tree, dict):
        return {k: from_jax(v) for k, v in tree.items()}
    return _leaf_from_numpy(tree)
