"""Model weights made on the device from the run seed, in the dtype they
are served in, in a few large calls: one normal draw per dtype over one
flat buffer, then one scale or fill per stacked leaf.  The program's
parameter specs give each leaf's shape, dtype and initial scale."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

#: elements per ``normal_`` call (below 2**31)
_DRAW = 1 << 30


def _leaves(tree, prefix="") -> List[Tuple[str, object]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_leaves(v, f"{prefix}{k}/"))
        else:
            out.append((prefix + k, v))
    return out


def _std(spec) -> float:
    if spec.init == "embed":
        return spec.scale if spec.scale is not None else 1.0
    if spec.init == "small":
        return spec.scale if spec.scale is not None else 0.02
    axis = spec.axis if spec.axis >= 0 else len(spec.shape) + spec.axis
    fan_in = spec.shape[axis] if spec.shape else 1
    return (spec.scale if spec.scale is not None else 1.0) / np.sqrt(
        max(fan_in, 1))


def _set(tree: dict, path: str, value) -> None:
    *parents, last = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = value


def make(cfg, seed: int, device) -> Dict:
    """The parameter tree of ``cfg`` (the program's layout), drawn from
    ``seed`` on ``device``."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.params import torch_dtype
    device = torch.device(device)
    leaves = _leaves(model_lib.param_specs(cfg))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    by_dtype: Dict[torch.dtype, list] = {}
    for path, spec in leaves:
        dt = torch_dtype(spec.dtype or cfg.param_dtype)
        by_dtype.setdefault(dt, []).append((path, spec))
    tree: Dict = {}
    for dt in sorted(by_dtype, key=str):
        group = by_dtype[dt]
        total = sum(int(np.prod(s.shape)) for _, s in group)
        buf = torch.empty(total, dtype=dt, device=device)
        for lo in range(0, total, _DRAW):
            buf[lo:lo + _DRAW].normal_(generator=gen)
        off = 0
        for path, spec in group:
            n = int(np.prod(spec.shape))
            leaf = buf[off:off + n].view(spec.shape)
            off += n
            if spec.init == "ones":
                leaf.fill_(1.0)
            elif spec.init == "zeros":
                leaf.zero_()
            else:
                leaf.mul_(_std(spec))
            _set(tree, path, leaf)
    return tree
