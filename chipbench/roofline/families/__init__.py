"""The port's kernel families, one module each, and the arithmetic they
share.  A family's least time on the card is the larger of its necessary
bytes over the memory rate and its operations over the peak rate; the
formulas are copies of ``repro_torch.tools.kernel_bench``'s bounds (a
CPU test holds them equal), with the model's widths passed in.

A module gives:

* ``PATTERN``: a regular expression that finds the family's kernels by
  the names the device trace gives them;
* ``ENTRIES``: each launcher entry (``<launcher>.launches``) whose
  launches those kernels are, and the module that defines it;
* where the family has a least time of its own in a serving call or a
  train step, ``serving_ms(cfg, call, launches)`` (``call`` a
  ``CallShape``) or ``train_ms(cfg, B, S, launches)``: the least ms of
  its launches there (``launches``: by launcher entry).

``found()`` finds every module of the package, so a family added here is
found with no edit of any file."""
from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Sequence, Tuple

from chipbench.roofline.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_S

PEAK_OPS_S = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
BF16 = 2


@dataclass(frozen=True)
class CallShape:
    """A serving call as launched: ``kind`` "prefill" (a chunk of
    ``chunk`` positions on each of ``cap`` rows) or "decode"; ``rows``
    the (first position, tokens) of each active row (a chunk call: each
    prefilling row's start and chunk length); ``lens`` the kv length each
    of the ``cap`` rows attends in a decode call; ``page`` the page
    size."""
    kind: str
    cap: int
    chunk: int
    rows: Sequence[Tuple[int, int]]
    lens: Sequence[int]
    page: int


def bound(nbytes: float, ops: float, dtype: str) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def widths(cfg) -> Dict[str, int]:
    return dict(d=cfg.d_model, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                D=cfg.head_dim, qk_norm=int(cfg.use_qk_norm))


def found() -> List[ModuleType]:
    """Every family module, in the order of their names."""
    return [importlib.import_module(f"{__name__}.{m.name}")
            for m in sorted(pkgutil.iter_modules(__path__),
                            key=lambda m: m.name)]
