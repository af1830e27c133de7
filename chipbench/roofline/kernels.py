"""Each port kernel's least time on the card, over the kernel families
of ``chipbench/roofline/families/`` (one module each): the families'
device-name patterns, their launcher entries, and the least time of a
serving call's or a train step's launches as the sum over the
families."""
from __future__ import annotations

from typing import Dict

from chipbench.roofline.families import (  # noqa: F401
    CallShape, bound, found, widths)
from chipbench.roofline.families.norm_bwd import norm_bwd_bound  # noqa: F401
from chipbench.roofline.families.norm_fwd import (  # noqa: F401
    add_rmsnorm_bound, rmsnorm_bound)
from chipbench.roofline.families.paged_decode import (  # noqa: F401
    paged_bound_ms)
from chipbench.roofline.families.paged_prefill import (  # noqa: F401
    paged_prefill_bound)
from chipbench.roofline.families.qk_norm_rope_fwd import (  # noqa: F401
    qk_norm_rope_bound)

FAMILIES = {m.__name__.rsplit(".", 1)[1]: m for m in found()}

#: the port's kernels as the device trace names them, and the launcher
#: entries (``<launcher>.launches``) whose launches each name counts
KERNEL_FAMILIES = {name: (m.PATTERN, tuple(m.ENTRIES))
                   for name, m in FAMILIES.items()}


def _entries() -> Dict[str, str]:
    out: Dict[str, str] = {}
    for name, m in FAMILIES.items():
        for entry, module in m.ENTRIES.items():
            if out.setdefault(entry, module) != module:
                raise ValueError(f"launcher {entry!r}: family {name} says "
                                 f"{module}, another {out[entry]}")
    return out


#: launcher entry -> the module that defines it, over every family
ENTRIES = _entries()


def serving_by_family(cfg, call: CallShape,
                      launches: Dict[str, int]) -> Dict[str, float]:
    """Each family's least ms of the launches of one serving call."""
    return {name: m.serving_ms(cfg, call, launches)
            for name, m in FAMILIES.items() if hasattr(m, "serving_ms")}


def train_by_family(cfg, B: int, S: int,
                    launches: Dict[str, int]) -> Dict[str, float]:
    """Each family's least ms of the launches of a train step, every one
    on the step's [B * S] rows."""
    return {name: m.train_ms(cfg, B, S, launches)
            for name, m in FAMILIES.items() if hasattr(m, "train_ms")}


def serving_call_ms(cfg, call: CallShape, launches: Dict[str, int]) -> float:
    """Least ms of the port kernels one serving call launched."""
    return sum(serving_by_family(cfg, call, launches).values())


def train_step_ms(cfg, B: int, S: int, launches: Dict[str, int]) -> float:
    """Least ms of the port kernels a train step launched."""
    return sum(train_by_family(cfg, B, S, launches).values())
