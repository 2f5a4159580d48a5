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

As a callable the spec is a prefix of the item tree, as ``jax.tree.map``
reads it in the reference: an op applies to the whole subtree at its
place (``("first", "sum")`` takes a tuple key whole). Host values fold
with numpy's ``minimum``/``maximum`` (a Python float comes back as
``np.float64``, as in the reference), tensors with torch's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
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
        try:
            return _combine(self.spec, a, b)
        except _Mismatch:
            spec_td = pt.flatten(self.spec)[1]
            td_a, td_b = pt.flatten(a)[1], pt.flatten(b)[1]
            raise TypeError(
                f"FieldReduce spec structure {spec_td} does not match the "
                f"item structure {td_a if td_a != spec_td else td_b}; for "
                f"ReducePair with a string op the value must be a single "
                f"leaf; pass an explicit FieldReduce spec mirroring the "
                f"item tree instead") from None

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


class _Mismatch(Exception):
    pass


def _combine(spec, a, b):
    """``a`` and ``b`` combined field by field, ``spec`` read as a
    prefix of their trees."""
    if isinstance(spec, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == spec.keys() == b.keys()):
            raise _Mismatch
        return {k: _combine(spec[k], a[k], b[k]) for k in sorted(spec)}
    if isinstance(spec, (tuple, list)):
        if not (type(a) is type(spec) is type(b)
                and len(a) == len(spec) == len(b)):
            raise _Mismatch
        return type(spec)(_combine(s, x, y) for s, x, y in zip(spec, a, b))
    if spec == "first":
        return a
    if spec == "sum":
        return a + b
    lib = torch if isinstance(a, torch.Tensor) or isinstance(
        b, torch.Tensor) else np
    return lib.minimum(a, b) if spec == "min" else lib.maximum(a, b)


def acc_plan(op: str, dtype, ndim: int):
    """The native accumulator of one FieldReduce column (reference:
    ``thrill_tpu/api/functors.py:116``): ``(opcode, conv_dtype)`` for
    ``native/hostsort.cpp`` ``hash_group_acc_u64`` given the op, the
    column's numpy dtype and its ndim, or None when the column must go
    through the generic fold. ``"first"`` is ``(-1, None)``: its rows
    are gathered from the groups' heads.

    ``conv_dtype`` is the 8-byte type the column is converted to for the
    pass; the result converts back to the column's type, exactly mod
    2**bits for integer sums (numpy's wraparound) and, for float32 sums,
    after an f64 accumulation."""
    dtype = np.dtype(dtype)
    if op == "first":
        return (-1, None)
    if ndim != 1:
        return None
    if op == "sum":
        if dtype == np.uint64:
            return (0, np.uint64)
        if np.issubdtype(dtype, np.integer):
            return (0, np.int64)
        if np.issubdtype(dtype, np.floating):
            return (3, np.float64)
        return None
    if op in ("min", "max"):
        lo = op == "min"
        if dtype == np.uint64:
            return (6 if lo else 7, np.uint64)
        if np.issubdtype(dtype, np.signedinteger):
            return (1 if lo else 2, np.int64)
        if np.issubdtype(dtype, np.unsignedinteger):
            return (6 if lo else 7, np.uint64)
        if np.issubdtype(dtype, np.floating):
            return (4 if lo else 5, np.float64)
        return None
    return None
