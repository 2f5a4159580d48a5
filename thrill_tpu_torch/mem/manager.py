"""Memory accounting (counterpart of the reference package's
``mem/manager.py``): the byte counters of ``MemoryManager`` (the HBM
governor's ledger), the RSS probe, the RSS spill trigger and the RAM
split.

Reference: thrill/api/context.cpp:1082-1093 splits total RAM into one
third block pool, one third operator workspace, one third floating heap.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def process_rss() -> int:
    """Resident set size of this process in bytes, from
    ``/proc/self/statm`` (0 where it is missing)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


class MemoryManager:
    """Thread-safe byte counter with a peak and a limit; a child adds
    and subtracts through its parents too (Thrill: mem/manager.hpp)."""

    def __init__(self, parent: Optional["MemoryManager"] = None,
                 name: str = "root", limit: int = 0) -> None:
        self.parent = parent
        self.name = name
        self.limit = limit          # 0 = unlimited
        self.total = 0
        self.peak = 0
        self.allocs = 0
        self._lock = threading.Lock()

    def add(self, nbytes: int) -> None:
        with self._lock:
            self.total += nbytes
            self.allocs += 1
            if self.total > self.peak:
                self.peak = self.total
        if self.parent is not None:
            self.parent.add(nbytes)

    def subtract(self, nbytes: int) -> None:
        with self._lock:
            self.total -= nbytes
        if self.parent is not None:
            self.parent.subtract(nbytes)

    @property
    def exceeded(self) -> bool:
        """Over the limit (Thrill's ``memory_exceeded`` flag)."""
        return self.limit > 0 and self.total > self.limit


class RssBudget:
    """Real-memory spill trigger: snapshots the RSS when a phase starts
    accumulating, and ``exceeded()`` says whether it has grown past the
    grant since (the reference's ``mem::memory_exceeded``, which Python
    cannot feed by interposing malloc). ``exceeded`` reads ``/proc``
    only every ``stride`` calls."""

    def __init__(self, grant_bytes: int, stride: int = 1024) -> None:
        self.grant = int(grant_bytes)
        self.stride = max(int(stride), 1)
        self.base = process_rss()
        self._n = 0

    def exceeded(self) -> bool:
        self._n += 1
        if self._n % self.stride:
            return False
        return self.exceeded_now()

    def exceeded_now(self) -> bool:
        if self.grant <= 0 or self.base <= 0:
            return False
        rss = process_rss()
        return rss > 0 and rss - self.base > self.grant

    def reset(self) -> None:
        """Snapshot again after a spill released what had accumulated."""
        self.base = process_rss()
        self._n = 0


@dataclasses.dataclass
class MemoryConfig:
    """RAM split between the block pool, operator workspace and the
    floating heap, one third each."""

    ram: int
    ram_block_pool_hard: int
    ram_block_pool_soft: int
    ram_workers: int
    ram_floating: int

    @staticmethod
    def split(total_ram: int) -> "MemoryConfig":
        third = total_ram // 3
        return MemoryConfig(
            ram=total_ram,
            ram_block_pool_hard=third,
            ram_block_pool_soft=int(third * 0.9),
            ram_workers=third,
            ram_floating=total_ram - 2 * third,
        )
