"""Parameter trees walked as ``jax.tree`` walks them.

The reference's optimizer, gradient norm and training checkpoints walk a
param tree through ``jax.tree``: dict keys in sorted order, NamedTuple
fields and sequence items in order, ``None`` holding no leaf; a tree it
rebuilds (``jax.jit``'s outputs) has its dicts in sorted key order. The
port's trees are nested dicts (the CNNs), NamedTuples (``LMParams``),
tuples and lists of tensors; these helpers give the same walk, so a sum
over leaves adds them in the reference's order and a checkpoint names
them as it does (``::``-joined paths).
"""

from __future__ import annotations

from typing import Any, Callable

SEP = "::"


def _children(tree) -> list | None:
    """(name, child) pairs of a node in jax.tree's order; None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    if tree is None:
        return []
    return None


def flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in jax.tree's order; a path is the tuple of dict keys,
    field names and indices from the root."""
    out: list = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, v in kids:
            walk(v, path + (k,))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_name(path: tuple, sep: str = "/") -> str:
    return sep.join(str(p) for p in path)


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (in
    :func:`leaves` order); its dicts come back in sorted key order, as a
    tree rebuilt by ``jax.tree`` does."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in kids}
        if node is None:
            return None
        vals = [build(v) for _, v in kids]
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and the same
    leaves of ``rest``; the result's dicts in sorted key order."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in zip(leaves(tree), *others)])
