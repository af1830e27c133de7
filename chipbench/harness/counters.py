"""The program's launch counters: each CUDA launcher of the port adds
one to its own ``.launches`` per launch."""
from __future__ import annotations

import importlib
from typing import Dict

#: launcher entry -> module that defines it, over every kernel family
from chipbench.roofline.kernels import ENTRIES


class Counters:
    """Reads the launchers' counters; ``since(snapshot)`` gives the
    launches made after it, by entry (entries that made none left out)."""

    def __init__(self):
        self._fns = {e: getattr(importlib.import_module(m), e)
                     for e, m in ENTRIES.items()}

    def snapshot(self) -> Dict[str, int]:
        return {e: int(f.launches) for e, f in self._fns.items()}

    def since(self, before: Dict[str, int]) -> Dict[str, int]:
        now = self.snapshot()
        return {e: now[e] - before[e] for e in now if now[e] != before[e]}
