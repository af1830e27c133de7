"""Helpers over nested dicts (and lists/tuples) of tensors."""
from __future__ import annotations

from typing import Iterator

import torch


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The leaves of a nested dict/list/tuple, dict keys in sorted order
    (the order ``jax.tree.leaves`` uses for dicts)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tree_leaves(x)
    else:
        yield tree


def tree_bytes(tree) -> int:
    """Total bytes across all leaves; ``device="meta"`` tensors count
    ``numel * element_size`` like any other, so abstract trees allocate
    nothing."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
