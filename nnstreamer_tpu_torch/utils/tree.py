"""Maps over the parameter trees of this package: nested dicts, lists and
tuples with tensors at the leaves."""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, zipping ``rest`` of the same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_named(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in ``tree_leaves``' order, the path's keys and
    indices joined by dots (``blocks.0.wq``)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in tree_named(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_named(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]
