"""K-way merge of sorted runs (counterpart of the reference package's
``core/multiway_merge.py``; Thrill's tournament tree,
``thrill/core/multiway_merge.hpp``). ``heapq.merge`` plays the tree;
:func:`multiway_merge_files` merges spilled File runs a block at a time
with a bounded merge degree.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Iterable, Iterator, List, Optional

from ..data.file import File

#: run readers open at once in a merge (the reference's default of
#: ``THRILL_TPU_MAX_MERGE_DEGREE``, which the port does not read)
MAX_MERGE_DEGREE = 64


def multiway_merge(runs: List[Iterable[Any]],
                   key: Optional[Callable] = None) -> Iterator[Any]:
    """Stable k-way merge: ties resolve by run index (run order wins),
    as ``heapq.merge`` resolves them."""
    return heapq.merge(*runs, key=key)


def multiway_merge_files(files: List[File], key: Optional[Callable] = None,
                         consume: bool = False,
                         max_merge_degree: int = 0,
                         submit=None) -> Iterator[Any]:
    """Merge sorted Files a block at a time, at most
    ``max_merge_degree`` readers open at once (Thrill:
    MaxMergeDegreePrefetch, thrill/data/block_pool.hpp:177, and Sort's
    partial merges, api/sort.hpp:229-260): past that, the smallest runs
    are merged into intermediate Files first. 0 takes
    :data:`MAX_MERGE_DEGREE`. ``submit`` (a readahead pool's,
    ``data/writeback.py``) reads each run's next block ahead."""
    max_merge_degree = max(max_merge_degree or MAX_MERGE_DEGREE, 2)
    files = list(files)
    made = []
    try:
        while len(files) > max_merge_degree:
            files.sort(key=lambda f: f.num_items)
            group, files = (files[:max_merge_degree],
                            files[max_merge_degree:])
            merged = File(pool=group[0].pool)
            with merged.writer() as w:
                readers = [f.prefetch_reader(consume=consume, submit=submit)
                           for f in group]
                for item in multiway_merge(readers, key):
                    w.put(item)
            if consume:
                for f in group:
                    f.clear()
            made.append(merged)
            files.append(merged)
        readers = [f.prefetch_reader(consume=consume or f in made,
                                     submit=submit) for f in files]
        yield from multiway_merge(readers, key)
    finally:
        for f in made:
            f.clear()
