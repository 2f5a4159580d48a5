"""Block: an item range of a shared byte block in the spill store
(counterpart of the reference package's ``data/block.py``; Thrill:
thrill/data/block.hpp:52). The bytes are one serialized batch in the
BlockPool; a Block names items ``[lo, hi)`` of it and releases its
reference to the bytes when dropped. The reference's zero-copy slicing
of Blocks is not ported: nothing in the port carves Files yet."""

from __future__ import annotations

from typing import Any, Iterator

from .serializer import deserialize_iter


class Block:
    __slots__ = ("pool", "bid", "lo", "hi")

    def __init__(self, pool, bid: int, lo: int, hi: int) -> None:
        self.pool = pool
        self.bid = bid
        self.lo = lo
        self.hi = hi

    @property
    def num_items(self) -> int:
        return self.hi - self.lo

    def iter_items(self) -> Iterator[Any]:
        """The items, decoded at the first pull."""
        if self.hi == self.lo:
            return iter(())
        return deserialize_iter(self.pool.get(self.bid), self.lo, self.hi)

    def release(self) -> None:
        """Give up this view; the pool frees the bytes with the last."""
        if self.bid >= 0:
            self.pool.release(self.bid)
            self.bid = -1
