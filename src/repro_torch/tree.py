"""The port's own flatten of parameter and state trees (what
``jax.tree`` does for the JAX package): dicts (keys in sorted order,
as JAX orders them), lists and tuples (in order), dataclasses (fields
in declaration order, as ``jax.tree_util.register_dataclass`` orders
them) and ``None`` (a node with no leaves); anything else is a leaf."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional


def _children(tree):
    """(kind, keys, children) of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", keys, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return type(tree), None, list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        keys = [f.name for f in dataclasses.fields(tree)]
        return "dataclass", keys, [getattr(tree, k) for k in keys]
    if tree is None:
        return "none", None, []
    return None


def leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves of ``tree`` in flatten order; ``is_leaf(node)`` true
    makes a node a leaf (a tuple of axis names, say)."""
    node = None if is_leaf is not None and is_leaf(tree) \
        else _children(tree)
    if node is None:
        return [tree]
    return [x for c in node[2] for x in leaves(c, is_leaf)]


def unflatten(like, new_leaves, is_leaf: Optional[Callable] = None) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (an
    iterable, consumed in flatten order)."""
    it = iter(new_leaves)
    out = _rebuild(like, it, is_leaf)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def _rebuild(like, it: Iterator, is_leaf=None):
    node = None if is_leaf is not None and is_leaf(like) \
        else _children(like)
    if node is None:
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the structure holds")
        return leaf
    kind, keys, kids = node
    new = [_rebuild(c, it, is_leaf) for c in kids]
    if kind == "dict":
        return dict(zip(keys, new))
    if kind == "dataclass":
        return dataclasses.replace(like, **dict(zip(keys, new)))
    if kind == "none":
        return None
    return kind(new)


def map(fn: Callable, tree, *rest,
        is_leaf: Optional[Callable] = None) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure; ``is_leaf`` applies to ``tree``'s nodes alone."""
    flat = [leaves(tree, is_leaf)] + [leaves(t) for t in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)], is_leaf)
