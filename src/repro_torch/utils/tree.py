"""Helpers over nested dicts (and lists, tuples and NamedTuples) of
tensors, in the leaf order and with the path strings of the JAX
package's ``utils/tree.py``: dict keys sorted, sequence items by index,
a NamedTuple's fields in field order under their names.  Checkpoints are
keyed by these paths, so a path here must be the JAX package's string."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(path part, child) of a node in flatten order; [] for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The leaves of a nested dict/list/tuple, dict keys in sorted order
    (the order ``jax.tree.leaves`` uses for dicts)."""
    if _is_leaf(tree):
        yield tree
        return
    for _, child in _children(tree):
        yield from tree_leaves(child)


def tree_bytes(tree) -> int:
    """Total bytes across all leaves; ``device="meta"`` tensors count
    ``numel * element_size`` like any other, so abstract trees allocate
    nothing."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_size(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(x.numel() for x in tree_leaves(tree))


def _map(fn, tree, rest, path: str):
    if _is_leaf(tree):
        return fn(path, tree, *rest)
    kids = {}
    for key, child in _children(tree):
        sub = [(r[key] if isinstance(r, dict) else
                getattr(r, key) if _is_namedtuple(r) else r[int(key)])
               for r in rest]
        kids[key] = _map(fn, child, sub, f"{path}/{key}" if path else key)
    if isinstance(tree, dict):
        return {k: kids[str(k)] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(**kids)
    return type(tree)(kids[str(i)] for i in range(len(tree)))


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest at the same place)`` over a tree, in a
    tree of the same structure (``jax.tree.map``)."""
    return _map(lambda _, *xs: fn(*xs), tree, rest, "")


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in
    ``tree_leaves`` order (``jax.tree.unflatten``)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map_with_path(fn: Callable, tree):
    """Map ``fn(path_str, leaf)`` over a tree."""
    return _map(fn, tree, (), "")


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """Return [(path_str, leaf), ...] for a tree."""
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out
