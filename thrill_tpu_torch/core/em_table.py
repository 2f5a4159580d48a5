"""External-memory host tables of ReduceByKey and GroupByKey
(counterpart of the reference package's ``core/em_table.py``).

Thrill: thrill/core/reduce_by_hash_post_phase.hpp:44-120. The post table
splits into partitions by hash; over its budget it spills the fullest
partitions to Files, and at emit it re-reduces each spilled partition
through a child table keyed on deeper hash bits, until a slice fits.
GroupByKey's buffer (api/group_by_key.hpp:188-216) spills sorted runs
and merges them, so one group at a time is in RAM.

The budget is an entry cap sized from the RAM grant over one pickled
sample (``entry_cap``), with the process's RSS growth past the grant
(``RssBudget``) as the backstop; the spill store keeps spills in RAM up
to its soft limit and writes the rest to disk. Each depth partitions on
its own 4 bits of the 64-bit ``stable_host_hash``, top bits first; at
``MAX_DEPTH`` (48 bits) a slice holds only keys whose hashes collide and
stays in RAM.

``THRILL_TPU_HOST_TABLE_CAP`` sets the entry cap whatever the grant: a
test hook that forces spills at small sizes.
"""

from __future__ import annotations

import heapq
import os
import pickle
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..common import hashing
from ..data.file import File
from ..mem.manager import RssBudget

PARTITION_BITS = 4
NUM_PARTITIONS = 1 << PARTITION_BITS
MAX_DEPTH = 12

_CAP_ENV = "THRILL_TPU_HOST_TABLE_CAP"


def entry_cap(mem_limit: int, sample: Any, floor: int = 64) -> int:
    """In-RAM entries of one host table: the grant over one pickled
    sample's size plus 96 bytes (Thrill sizes its table from the
    DIAMemUse grant over sizeof(KeyValuePair) the same way)."""
    env = os.environ.get(_CAP_ENV)
    if env:
        return max(int(env), 8)
    if not mem_limit:
        return 1 << 22
    try:
        est = len(pickle.dumps(sample, protocol=pickle.HIGHEST_PROTOCOL)) + 96
    except Exception:
        est = 256
    return max(floor, min(mem_limit // est, 1 << 26))


def _new_stats() -> Dict[str, int]:
    return {"spills": 0, "spilled_entries": 0, "max_depth": 0,
            "peak_entries": 0}


class EMReduceTable:
    """A reducing hash table that spills and re-reduces recursively.

    ``insert`` folds (key, value) under ``reduce_fn``; past the entry cap
    (or the RSS grant) the fullest partitions spill to Files. ``emit``
    yields every reduced value once, partition by partition, re-reducing
    a spilled partition through a child table one depth down. Inserted
    values may be partial aggregates: ``reduce_fn`` is associative, so
    re-reducing spilled partials is exact.
    """

    def __init__(self, reduce_fn: Callable[[Any, Any], Any], pool,
                 mem_limit: Optional[int], depth: int = 0,
                 stats: Optional[Dict[str, int]] = None) -> None:
        self.reduce_fn = reduce_fn
        self.pool = pool
        self.mem_limit = int(mem_limit or 0)
        self.depth = depth
        self.tables: List[dict] = [dict() for _ in range(NUM_PARTITIONS)]
        self.files: List[Optional[File]] = [None] * NUM_PARTITIONS
        self.stats = _new_stats() if stats is None else stats
        if depth > self.stats["max_depth"]:
            self.stats["max_depth"] = depth
        self.budget = RssBudget(self.mem_limit)
        self.cap: Optional[int] = None
        self.n = 0

    def _pidx(self, h: int) -> int:
        shift = 64 - PARTITION_BITS * (self.depth + 1)
        return (h >> shift) & (NUM_PARTITIONS - 1)

    def insert(self, key, value, h: Optional[int] = None) -> None:
        if h is None:
            h = hashing.stable_host_hash(key)
        t = self.tables[self._pidx(h)]
        cur = t.get(key)
        if cur is not None:
            t[key] = (h, self.reduce_fn(cur[1], value))
            # aggregates that grow (concatenation, union) can blow the
            # grant at a constant entry count
            if self.depth < MAX_DEPTH and self.n >= 16 \
                    and self.budget.exceeded():
                self._spill_over_budget()
            return
        if self.cap is None:
            self.cap = entry_cap(self.mem_limit, (key, value))
        t[key] = (h, value)
        self.n += 1
        if self.n > self.stats["peak_entries"]:
            self.stats["peak_entries"] = self.n
        if self.depth < MAX_DEPTH and self.n >= 16 and (
                self.n >= self.cap or self.budget.exceeded()):
            self._spill_over_budget()

    def _spill_over_budget(self) -> None:
        """Spill the fullest partitions until at most half the cap stays,
        and always at least the fullest one: an RSS-triggered call may
        come with few entries whose aggregates grew large (Thrill spills
        one partition an overflow, reduce_by_hash_post_phase.hpp:92)."""
        target = max((self.cap or 64) // 2, 8)
        order = sorted(range(NUM_PARTITIONS),
                       key=lambda p: -len(self.tables[p]))
        spilled_any = False
        for p in order:
            if spilled_any and self.n <= target:
                break
            t = self.tables[p]
            if not t:
                break
            f = self.files[p]
            if f is None:
                f = self.files[p] = File(pool=self.pool)
            with f.writer() as w:
                for k, (h, v) in t.items():
                    w.put((h, k, v))
            self.stats["spills"] += 1
            self.stats["spilled_entries"] += len(t)
            self.n -= len(t)
            t.clear()
            spilled_any = True
        self.budget.reset()

    def emit(self) -> Iterator[Any]:
        """Every reduced value once: a partition in RAM as it is, a
        spilled one with its RAM remainder appended and re-reduced
        through a child table."""
        for p in range(NUM_PARTITIONS):
            t = self.tables[p]
            f = self.files[p]
            if f is None:
                for (_h, v) in t.values():
                    yield v
                self.n -= len(t)
                t.clear()
                continue
            if t:
                with f.writer() as w:
                    for k, (h, v) in t.items():
                        w.put((h, k, v))
                self.n -= len(t)
                t.clear()
            child = EMReduceTable(self.reduce_fn, self.pool,
                                  self.mem_limit, self.depth + 1,
                                  self.stats)
            for h, k, v in f.consume_reader():
                child.insert(k, v, h)
            f.clear()
            self.files[p] = None
            yield from child.emit()
            child.close()

    def close(self) -> None:
        for t in self.tables:
            t.clear()
        for f in self.files:
            if f is not None:
                f.clear()
        self.files = [None] * NUM_PARTITIONS
        self.n = 0


def _run_order(row: Tuple[int, int, Any, Any]) -> Tuple[int, int]:
    return (row[0], row[1])


class EMGroupBuffer:
    """Grouping in arrival order, with sorted runs spilled.

    ``add`` buffers (hash, seq, key, item) rows; over budget the buffer
    spills as a run sorted by (hash, seq). ``groups`` yields ``(key,
    [items])`` per key: unspilled, from an insertion-ordered dict; spilled,
    from a k-way merge of the runs on (hash, seq), which brings all rows
    of one hash together (one hash bucket in RAM at a time) and keeps
    each group's items in arrival order across runs.
    """

    def __init__(self, pool, mem_limit: Optional[int],
                 stats: Optional[Dict[str, int]] = None) -> None:
        self.pool = pool
        self.mem_limit = int(mem_limit or 0)
        self.rows: List[Tuple[int, int, Any, Any]] = []
        self.runs: List[File] = []
        self.seq = 0
        self.cap: Optional[int] = None
        self.budget = RssBudget(self.mem_limit)
        self.stats = _new_stats() if stats is None else stats

    def add(self, key, item, h: Optional[int] = None) -> None:
        if h is None:
            h = hashing.stable_host_hash(key)
        if self.cap is None:
            self.cap = entry_cap(self.mem_limit, (h, 0, key, item))
        self.rows.append((h, self.seq, key, item))
        self.seq += 1
        if len(self.rows) > self.stats["peak_entries"]:
            self.stats["peak_entries"] = len(self.rows)
        if len(self.rows) >= 16 and (len(self.rows) >= self.cap
                                     or self.budget.exceeded()):
            self._spill()

    def _spill(self) -> None:
        self.rows.sort(key=_run_order)
        f = File(pool=self.pool)
        with f.writer() as w:
            for r in self.rows:
                w.put(r)
        self.runs.append(f)
        self.stats["spills"] += 1
        self.stats["spilled_entries"] += len(self.rows)
        self.rows = []
        self.budget.reset()

    def groups(self) -> Iterator[Tuple[Any, List[Any]]]:
        if not self.runs:
            g: dict = {}
            for _h, _s, k, v in self.rows:
                g.setdefault(k, []).append(v)
            self.rows = []
            yield from g.items()
            return
        if self.rows:
            self._spill()
        stream = heapq.merge(*[f.consume_reader() for f in self.runs],
                             key=_run_order)
        bucket_h: Optional[int] = None
        bucket: dict = {}
        for h, _s, k, v in stream:
            if h != bucket_h and bucket:
                yield from bucket.items()
                bucket = {}
            bucket_h = h
            bucket.setdefault(k, []).append(v)
        if bucket:
            yield from bucket.items()

    def close(self) -> None:
        for f in self.runs:
            f.clear()
        self.runs = []
        self.rows = []
