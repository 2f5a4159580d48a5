"""K-way merge of sorted runs (counterpart of ``multiway_merge`` in the
reference package's ``core/multiway_merge.py``; Thrill's tournament
tree, ``thrill/core/multiway_merge.hpp``). ``heapq.merge`` plays the
tree.

The reference's ``multiway_merge_files`` merges spilled File runs; it
comes with the out-of-core layer (ROADMAP.md queue A 'Still to port'
item 5), so this module imports nothing of ``data``.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Iterable, Iterator, List, Optional


def multiway_merge(runs: List[Iterable[Any]],
                   key: Optional[Callable] = None) -> Iterator[Any]:
    """Stable k-way merge: ties resolve by run index (run order wins),
    as ``heapq.merge`` resolves them."""
    return heapq.merge(*runs, key=key)
