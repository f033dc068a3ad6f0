"""Nested dicts and lists of tensors (the port's parameter and optimizer
trees), walked in ``jax.tree`` order.

The reference's trees are pytrees: ``jax.tree.leaves`` visits a dict's keys
sorted and a list's items in order, and ``jax.tree_util`` names a leaf by
its key path (``['params']/['layers']/[0]/['w']``).  The optimizer flattens
in this order so that its global norm sums in the reference's order, and
the checkpoint names its arrays by these key strings, so that a checkpoint
the reference wrote restores into the port's tree.  ``None`` is an empty
subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def flatten_with_path(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(key path, leaf) pairs in ``jax.tree`` order; a path is a tuple of
    ``jax.tree_util`` key strings (``"['w']"``, ``"[0]"``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_path(tree[k], path + (f"[{k!r}]",))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in flatten_with_path(v, path + (f"[{i}]",))]
    return [(path, tree)]


def keystr(path: tuple) -> str:
    """The reference checkpoint's name of a leaf: its key strings joined
    by ``/``."""
    return "/".join(path)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(tree, it: Iterator):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
