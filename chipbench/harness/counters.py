"""The program's launch counters: each CUDA launcher of the port adds
one to its own ``.launches`` per launch."""
from __future__ import annotations

import importlib
from typing import Dict

#: launcher entry -> module that defines it
ENTRIES = {
    "paged_attention_fwd": "repro_torch.kernels.paged_attention.kernel",
    "rmsnorm_fwd": "repro_torch.kernels.rmsnorm.kernel",
    "add_rmsnorm_fwd": "repro_torch.kernels.rmsnorm.kernel",
    "qk_norm_rope_fwd": "repro_torch.kernels.rmsnorm.kernel",
    "rmsnorm_bwd": "repro_torch.kernels.rmsnorm.kernel",
    "add_rmsnorm_bwd": "repro_torch.kernels.rmsnorm.kernel",
    "qk_norm_rope_bwd": "repro_torch.kernels.rmsnorm.kernel",
}


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
