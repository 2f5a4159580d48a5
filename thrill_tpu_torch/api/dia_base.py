"""DIA graph nodes (counterpart of the reference package's
``api/dia_base.py``, without fusion, checkpoints or memory negotiation).

An action materializes its parent, which recursively computes its own
parents. A result stays cached on its node until its consume budget is
spent; ``Keep()`` raises the budget, as the reference's consume counters
do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ..data.shards import DeviceShards
from .stack import Stack, apply_stack_device

NEW = "NEW"
EXECUTED = "EXECUTED"
DISPOSED = "DISPOSED"


@dataclasses.dataclass
class ParentLink:
    """A node's link to a parent node plus the LOp stack on the edge."""
    node: "DIABase"
    stack: Stack

    def pull(self, consume: bool = True) -> DeviceShards:
        shards = self.node.materialize(consume=consume)
        if not self.stack:
            return shards
        return apply_stack_device(shards, self.stack)


class DIABase:
    """A node of the DIA dataflow graph."""

    def __init__(self, ctx, label: str,
                 parents: Sequence[ParentLink] = ()) -> None:
        self.context = ctx
        self.label = label
        self.parents: List[ParentLink] = list(parents)
        self.id = ctx._register_node(self)
        self.state = NEW
        self._shards: Optional[DeviceShards] = None
        # every node's result may be used once; Keep(n) allows n more
        self.consume_budget = 1

    def compute(self) -> DeviceShards:
        raise NotImplementedError

    def materialize(self, consume: bool = False) -> DeviceShards:
        if self.state == DISPOSED:
            raise RuntimeError(
                f"DIA node {self.label}#{self.id} was consumed/disposed "
                f"(consume budget exhausted); call .Keep() before reusing "
                f"a DIA in more than one operation")
        if self._shards is None:
            self._shards = self.compute()
            self.state = EXECUTED
        result = self._shards
        if consume:
            self.consume_budget -= 1
            if self.consume_budget <= 0:
                self.dispose()
        return result

    def keep(self, n: int = 1) -> None:
        self.consume_budget += n

    def dispose(self) -> None:
        self._shards = None
        self.state = DISPOSED

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.label}#{self.id} {self.state}>"
