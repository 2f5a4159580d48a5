"""File: an ordered sequence of item Blocks in the spill store
(counterpart of the reference package's ``data/file.py``; Thrill:
thrill/data/file.hpp:56, block_writer.hpp:53). A BlockWriter fills
blocks of ``block_items`` items (``append_block`` adopts one written
elsewhere); the keep reader streams them back and leaves them, the
consume reader drops each block once read, and the prefetch reader does
either with the next block read ahead. Readers take ``project``, which
yields one tuple element of each item. The reference's random access
and zero-copy slicing (``get_item_at``, ``slice``, ``scatter``) are not
ported."""

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

    @property
    def block_ids(self) -> List[int]:
        return [b.bid for b in self.blocks]

    @property
    def block_counts(self) -> List[int]:
        return [b.num_items for b in self.blocks]

    def writer(self) -> "BlockWriter":
        return BlockWriter(self)

    def append_block(self, block: Block) -> None:
        """Adopt a Block (and its one reference to the bytes)."""
        if block.num_items:
            self.blocks.append(block)
        else:
            block.release()

    @property
    def num_items(self) -> int:
        return sum(b.num_items for b in self.blocks)

    def keep_reader(self, project=None) -> Iterator[Any]:
        """The items, the file left as it is (Thrill: KeepFileBlockSource,
        file.hpp:349)."""
        for b in self.blocks:
            yield from b.iter_items(project)

    def consume_reader(self, project=None) -> Iterator[Any]:
        """The items, each block dropped once read (Thrill:
        ConsumeFileBlockSource, file.hpp:414)."""
        while self.blocks:
            b = self.blocks.pop(0)
            yield from b.iter_items(project)
            b.release()

    def prefetch_reader(self, consume: bool = False, submit=None,
                        project=None) -> Iterator[Any]:
        """The keep or consume reader with the next block read ahead on
        a readahead pool (Thrill: the BlockPool's prefetch,
        thrill/data/block_pool.hpp:177): while one block decodes, the
        next one's bytes come from the store. ``submit`` is a readahead
        pool's submit (``data/writeback.py`` ``make_readahead``); None
        gives the plain reader. A failed background read falls back to
        a read on the consumer's thread. Only blocks on disk are read
        ahead: a block in RAM is a copy, cheaper than the queue."""
        if submit is None:
            return (self.consume_reader(project) if consume
                    else self.keep_reader(project))
        return self._prefetch_iter(consume, submit, project)

    def _prefetch_iter(self, consume: bool, submit,
                       project=None) -> Iterator[Any]:
        from .serializer import deserialize_iter
        from .writeback import readahead_get, readahead_job
        pool = self.pool
        idx = 0

        def next_block():
            nonlocal idx
            if consume:
                return self.blocks.pop(0) if self.blocks else None
            if idx < len(self.blocks):
                idx += 1
                return self.blocks[idx - 1]
            return None

        def start(b):
            if pool.resident(b.bid):
                return None
            return submit(readahead_job(lambda: pool.get(b.bid),
                                        "file.prefetch"))

        b = next_block()
        fut = start(b) if b is not None else None
        while b is not None:
            nb = next_block()
            nfut = start(nb) if nb is not None else None
            raw = readahead_get(fut, lambda blk=b: pool.get(blk.bid),
                                "file.prefetch")
            if b.hi > b.lo:
                yield from deserialize_iter(raw, b.lo, b.hi, project)
            if consume:
                b.release()
            b, fut = nb, nfut

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
