"""Declarative reduce functors for ReduceByKey / ReducePair /
ReduceToIndex (counterpart of the reference package's
``api/functors.py``).

:class:`FieldReduce` names a combine op per field of the item tree. It
stays an ordinary associative callable for the generic engine (the
segmented scan calls it), and lets the device engines fold each field
with one segment or scatter reduction instead.

Example (WordCount)::

    counts = words.ReduceByKey(lambda t: t["w"],
                               FieldReduce({"w": "first", "c": "sum"}))

Ops per field: ``"first"`` (keep the first-seen row's value, the usual
choice for the carried key field), ``"sum"``, ``"min"``, ``"max"``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..common import tree as pt

_OPS = ("first", "sum", "min", "max")


class FieldReduce:
    """Associative combine described per item-tree field: ``spec`` is a
    pytree with the items' structure and an op string at every leaf."""

    def __init__(self, spec: Any) -> None:
        for s in pt.leaves(spec):
            if s not in _OPS:
                raise ValueError(
                    f"FieldReduce: unknown op {s!r} (expected one of {_OPS})")
        self.spec = spec

    def __call__(self, a, b):
        spec_leaves, spec_td = pt.flatten(self.spec)
        (la, td_a), (lb, td_b) = pt.flatten(a), pt.flatten(b)
        if td_a != spec_td or td_b != spec_td:
            raise TypeError(
                f"FieldReduce spec structure {spec_td} does not match the "
                f"item structure {td_a if td_a != spec_td else td_b}; for "
                f"ReducePair with a string op the value must be a single "
                f"leaf; pass an explicit FieldReduce spec mirroring the "
                f"item tree instead")

        def comb(op, x, y):
            if op == "first":
                return x
            if op == "sum":
                return x + y
            return torch.minimum(x, y) if op == "min" else torch.maximum(x, y)

        return pt.unflatten(spec_td, [comb(*z) for z in
                                      zip(spec_leaves, la, lb)])

    def flat_spec(self, treedef):
        """Per-leaf op strings in ``treedef``'s leaf order, or None if
        the spec's structure does not match the item tree."""
        leaves, td = pt.flatten(self.spec)
        return leaves if td == treedef else None

    def _key(self):
        leaves, td = pt.flatten(self.spec)
        return (td, tuple(leaves))

    def __eq__(self, other) -> bool:
        return isinstance(other, FieldReduce) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"FieldReduce({self.spec!r})"
