"""Minimal pytrees over dicts, tuples and lists.

Leaf order follows the reference package's pytrees: dict children in
sorted key order, sequences in order. The order matters where it is
observable, above all in the key words of a Sort whose key function
returns several fields.

The walks are module-level functions: a nested function that calls
itself is a reference cycle, and one that also holds the leaves kept
every leaf tensor alive until the cyclic garbage collector ran.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

LEAF = None          # the treedef of a single leaf


def _walk(t: Any, leaves: List[Any]) -> Any:
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", tuple(keys), tuple(_walk(t[k], leaves) for k in keys))
    if isinstance(t, (tuple, list)):
        return (type(t).__name__, len(t), tuple(_walk(c, leaves) for c in t))
    leaves.append(t)
    return LEAF


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, treedef) of ``tree``."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(td: Any, it) -> Any:
    if td is LEAF:
        return next(it)
    kind, meta, kids = td
    vals = [_build(k, it) for k in kids]
    if kind == "dict":
        return dict(zip(meta, vals))
    return tuple(vals) if kind == "tuple" else list(vals)


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    return _build(treedef, iter(leaves))


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    lv, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(lv, *others)])
