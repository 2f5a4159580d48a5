"""File: an ordered sequence of item Blocks in the spill store
(counterpart of the reference package's ``data/file.py``; Thrill:
thrill/data/file.hpp:56, block_writer.hpp:53). A BlockWriter fills
blocks of ``block_items`` items; the keep reader streams them back and
leaves them, the consume reader drops each block once read. The
reference's prefetching reader, random access and zero-copy slicing
(``get_item_at``, ``slice``, ``scatter``) are not ported."""

from __future__ import annotations

from typing import Any, Iterator, List, Optional

from .block import Block
from .block_pool import BlockPool
from .serializer import serialize_batch

DEFAULT_BLOCK_ITEMS = 4096


class File:
    def __init__(self, pool: Optional[BlockPool] = None,
                 block_items: int = DEFAULT_BLOCK_ITEMS) -> None:
        self.pool = pool or BlockPool()
        self._owns_pool = pool is None
        self.block_items = block_items
        self.blocks: List[Block] = []

    def writer(self) -> "BlockWriter":
        return BlockWriter(self)

    @property
    def num_items(self) -> int:
        return sum(b.num_items for b in self.blocks)

    def keep_reader(self) -> Iterator[Any]:
        """The items, the file left as it is (Thrill: KeepFileBlockSource,
        file.hpp:349)."""
        for b in self.blocks:
            yield from b.iter_items()

    def consume_reader(self) -> Iterator[Any]:
        """The items, each block dropped once read (Thrill:
        ConsumeFileBlockSource, file.hpp:414)."""
        while self.blocks:
            b = self.blocks.pop(0)
            yield from b.iter_items()
            b.release()

    def clear(self) -> None:
        for b in self.blocks:
            b.release()
        self.blocks.clear()

    def close(self) -> None:
        self.clear()
        if self._owns_pool:
            self.pool.close()


class BlockWriter:
    def __init__(self, file: File) -> None:
        self.file = file
        self._buf: List[Any] = []

    def put(self, item: Any) -> None:
        self._buf.append(item)
        if len(self._buf) >= self.file.block_items:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        bid = self.file.pool.put(serialize_batch(self._buf))
        self.file.blocks.append(Block(self.file.pool, bid, 0,
                                      len(self._buf)))
        self._buf = []

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "BlockWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
