"""The DIA handle: a lazily evaluated distributed immutable array
(counterpart of the reference package's ``api/dia.py``).

A handle is a node plus a stack of local operations. ``Map``/``Filter``
extend the stack; ``Sort`` cuts it with a new node; actions run the
graph.
"""

from __future__ import annotations

from typing import Callable, Optional

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
