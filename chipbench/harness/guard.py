"""What a run refuses: a machine without the cards the cell asks for,
and a process that has loaded JAX or the JAX package."""
from __future__ import annotations

import sys
from typing import Iterable, List

#: top-level module names that no process of the benchmark may hold: JAX,
#: the JAX package (``repro``; the port's ``repro_torch`` is another
#: name, compared whole) and the JAX package's benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Sorted loaded module names whose top-level name (the part before
    the first dot, whole) is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def require_cards(chips: int) -> None:
    """Exit non-zero, printing no result, without ``chips`` CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chipbench: torch.cuda.is_available() is false; "
                         "the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"chipbench: the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} visible")


def require_clean() -> None:
    """Exit non-zero, printing no result, if JAX or the JAX package is
    loaded in this process; names what was found on stderr."""
    found = forbidden_modules()
    if found:
        print("chipbench: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        raise SystemExit(3)
