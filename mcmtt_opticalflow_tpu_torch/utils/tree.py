"""Map over the leaves of nested tuples and NamedTuples (the states and
outputs the port passes around; jax.tree.map's part the port needs)."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """fn over corresponding leaves of `tree` and `rest` (same structure);
    tuples and NamedTuples are nodes, everything else is a leaf."""
    if not isinstance(tree, tuple):
        return fn(tree, *rest)
    items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def tree_leaves(tree) -> List[Any]:
    """The leaves of `tree`, depth first."""
    if not isinstance(tree, tuple):
        return [tree]
    return [leaf for x in tree for leaf in tree_leaves(x)]
