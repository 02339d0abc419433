"""Nested-container helpers of the port: the parts of ``jax.tree_util``
that ``repro/optim/adamw.py`` and ``repro/checkpoint/ckpt.py`` use
(``tree.map``, ``tree_flatten_with_path``, ``tree_unflatten``).

A tree is a dict, list, tuple or ``NamedTuple`` of trees, or a leaf
(anything else: a tensor, an array, a number).  ``None`` is an empty
subtree, as in JAX.  Dicts are walked in sorted key order, as JAX walks
them; a leaf's path is its keys, indices and field names joined by
``/``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    raise TypeError(type(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in flattening order."""
    if tree is None:
        return
    if not _is_node(tree):
        yield prefix, tree
        return
    for key, child in _children(tree):
        yield from leaves_with_paths(child, f"{prefix}/{key}" if prefix
                                     else key)


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_unflatten(tree_like, leaves) -> Any:
    """A tree shaped as ``tree_like`` whose leaves are ``leaves``, taken in
    flattening order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            out = {k: None for k in node}       # keep the caller's order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        built = [build(c) for _, c in _children(node)]
        if isinstance(node, list):
            return built
        return type(node)(*built) if hasattr(node, "_fields") else \
            tuple(built)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees of its shape."""
    first = tree_leaves(tree)
    others = [tree_leaves(t) for t in rest]
    if any(len(o) != len(first) for o in others):
        raise ValueError("trees of different shapes")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(first, *others)])
