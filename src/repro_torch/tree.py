"""Nested dict/list parameter trees: the port's stand-in for
``jax.tree``.  Leaves are visited in insertion order (dict keys as
stored, list, tuple and NamedTuple items in order), the same order in :func:`tree_leaves`,
:func:`tree_map` and :func:`tree_unflatten`.  ``None`` is an empty
subtree, as in ``jax.tree``: it holds no leaf and maps to ``None`` (an
``AdamState`` without a master, a decoder's empty ``cycles`` slot)."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    each tree in ``rest`` (same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = (tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree))
        if hasattr(tree, "_fields"):                # a NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves: Iterable) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
