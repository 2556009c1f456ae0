"""Nested dicts of tensors — the port's parameter and optimizer trees —
walked in the order ``jax.tree`` flattens a dict: keys sorted at every
level."""

from __future__ import annotations


def tree_items(tree: dict, prefix: tuple = ()):
    """``(path, leaf)`` for every leaf, keys sorted at each level."""
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from tree_items(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def tree_leaves(tree: dict) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), as a tree of the same structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def tree_unflatten(like: dict, leaves) -> dict:
    """The tree of ``like``'s structure whose leaves, in
    :func:`tree_items` order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    return build(like)
