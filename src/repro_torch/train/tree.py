"""Trees of (named) tuples, lists and dicts with tensor leaves: the part
of ``jax.tree_util`` the optimizer and the checkpoints need.

The order of leaves and their key paths are JAX's: NamedTuple fields and
sequence items in order, dict keys sorted; ``None`` is a leaf. A path
joins NamedTuple field names, sequence indices and dict keys with "/"
(``params/convs/0/w``), as ``repro/train/checkpoint.py`` writes them.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node) -> tuple[list[str], list] | None:
    """(keys, children) of an inner node; None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node._fields), list(node)
    if isinstance(node, (tuple, list)):
        return [str(i) for i in range(len(node))], list(node)
    if isinstance(node, dict):
        keys = sorted(node)
        return [str(k) for k in keys], [node[k] for k in keys]
    return None


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in zip(*kids):
        out += leaves_with_path(child, f"{prefix}/{key}" if prefix else key)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure); the result has ``tree``'s
    structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    keys, children = kids
    others = [_children(r)[1] for r in rest]
    mapped = [tree_map(fn, c, *(o[i] for o in others))
              for i, c in enumerate(children)]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), mapped))
    if hasattr(tree, "_fields"):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def tree_unflatten(template, leaves: list):
    """A tree of ``template``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
