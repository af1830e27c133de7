"""What one run leaves for the metric readers: the model calls, the
tokens' stamps, the requests' due and join times, the window, the
profiled slice and the train steps, with the port's config and the
architecture module (``chipbench/archs/``) whose FLOP count the readers
take."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class ServeRecord:
    cfg: object                                  # the port's ModelConfig
    arch: object                                 # its chipbench.archs module
    window: Tuple[float, float]
    calls: list                                  # wall.Call, in order
    stamps: Dict[int, List[float]]               # rid -> token stamps
    due: Dict[int, float]                        # rid -> wall due time
    joined: Dict[int, float]                     # rid -> wall first join
    cap: int                                     # rows per call
    chunk: int
    page: int
    profile: Optional[object] = None             # profiling.Summary
    profiled: Tuple[float, float] = (0.0, 0.0)   # wall span of the slice

    def calls_in(self, kind: str, *, profiled: bool = False) -> list:
        """Calls of ``kind`` inside the window and outside the profiled
        slice, or (``profiled``) every call inside the slice."""
        w0, w1 = self.window
        p0, p1 = self.profiled
        out = []
        for c in self.calls:
            if c.kind != kind:
                continue
            inside = p1 > p0 and c.t0 >= p0 and c.t1 <= p1
            if profiled and inside or (not profiled and not inside
                                       and c.t0 >= w0 and c.t1 <= w1):
                out.append(c)
        return out


@dataclass
class TrainRecord:
    cfg: object
    arch: object
    window: Tuple[float, float]
    step_ends: List[float]                       # wall end of each step
    tokens_per_step: int
    batch: int
    seq: int
    profile: Optional[object] = None
    profiled_launches: Dict[str, int] = field(default_factory=dict)
    profiled_steps: int = 0
