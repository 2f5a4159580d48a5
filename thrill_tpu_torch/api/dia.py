"""The DIA handle: a lazily evaluated distributed immutable array
(counterpart of the reference package's ``api/dia.py``).

A handle is a node plus a stack of local operations. ``Map``/``Filter``
extend the stack; ``Sort`` and the reduces cut it with a new node;
actions run the graph.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .dia_base import DIABase, ParentLink
from .stack import Stack, StackOp


class DIA:
    def __init__(self, node: DIABase, stack: Stack = ()) -> None:
        self.node = node
        self.stack = stack

    @property
    def context(self):
        return self.node.context

    def _link(self) -> ParentLink:
        return ParentLink(self.node, self.stack)

    # -- local ops -----------------------------------------------------
    def Map(self, fn: Callable) -> "DIA":
        return DIA(self.node, self.stack + (StackOp("map", fn),))

    def Filter(self, fn: Callable) -> "DIA":
        return DIA(self.node, self.stack + (StackOp("filter", fn),))

    # -- distributed ops -----------------------------------------------
    def Sort(self, key_fn: Optional[Callable] = None) -> "DIA":
        """Globally sorted by ``key_fn`` (batched, default identity);
        equal keys keep their global order."""
        from .ops import sort as _s
        return _s.Sort(self, key_fn)

    def ReduceByKey(self, key_fn: Callable, reduce_fn: Callable,
                    dup_detection=None) -> "DIA":
        """Combine items of equal ``key_fn`` with the associative
        ``reduce_fn``. ``dup_detection`` (reference:
        DuplicateDetectionTag) keeps globally unique keys on their
        worker instead of shuffling them; None, the default, leaves it to
        the cost model (core/preshuffle.py), True/False force it. Rows
        come out key-sorted per worker; dup detection changes which
        worker holds a unique key, not the result set."""
        from .ops import reduce as _r
        return _r.ReduceByKey(self, key_fn, reduce_fn, dup_detection)

    def ReducePair(self, reduce_fn: Callable) -> "DIA":
        """Items are (key, value) pairs; ``reduce_fn`` (a callable or
        "sum"/"min"/"max") combines values."""
        from .ops import reduce as _r
        return _r.ReducePair(self, reduce_fn)

    def ReduceToIndex(self, index_fn: Callable, reduce_fn: Callable,
                      size: int, neutral: Any = None) -> "DIA":
        """Dense output of ``size`` rows: row ``i`` folds the items with
        ``index_fn == i``, rows without items hold ``neutral`` (zeros
        when None). Worker ``w`` holds the range
        ``dense_range_bounds(size, W)[w:w+2]``."""
        from .ops import reduce as _r
        return _r.ReduceToIndex(self, index_fn, reduce_fn, size, neutral)

    # -- consume control -----------------------------------------------
    def Keep(self, n: int = 1) -> "DIA":
        self.node.keep(n)
        return self

    def Execute(self) -> "DIA":
        self.node.materialize()
        return self

    # -- actions -------------------------------------------------------
    def Size(self) -> int:
        from .ops import actions
        return actions.Size(self)

    def AllGather(self) -> list:
        from .ops import actions
        return actions.AllGather(self)

    def AllGatherArrays(self):
        """The items as one pytree of tensors ``[total, ...]`` on the
        device, in worker-rank order."""
        from .ops import actions
        return actions.AllGatherArrays(self)
