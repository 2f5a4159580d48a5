"""Timers, counters and scalar aggregates (counterpart of the reference
package's ``common/stats.py``).

Equivalents of the reference's StatsTimer / StatsCounter
(reference: thrill/common/stats_timer.hpp, stats_counter.hpp) and
Aggregate (reference: thrill/common/aggregate.hpp): cheap instrumentation
that can be compiled out; here a module-level ``STATS_ENABLED`` flag makes
the instances no-ops when disabled.
"""

from __future__ import annotations

import math
import time

STATS_ENABLED = True


class StatsTimer:
    """Accumulating wall-clock timer, usable as a context manager."""

    __slots__ = ("seconds", "_start", "_running")

    def __init__(self, start: bool = False) -> None:
        self.seconds = 0.0
        self._start = 0.0
        self._running = False
        if start and STATS_ENABLED:
            self.start()

    def start(self) -> "StatsTimer":
        if STATS_ENABLED and not self._running:
            self._start = time.perf_counter()
            self._running = True
        return self

    def stop(self) -> "StatsTimer":
        if self._running:
            self.seconds += time.perf_counter() - self._start
            self._running = False
        return self

    def __enter__(self) -> "StatsTimer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def ms(self) -> float:
        return self.seconds * 1e3

    @property
    def us(self) -> float:
        return self.seconds * 1e6


class StatsCounter:
    __slots__ = ("value",)

    def __init__(self, value: int = 0) -> None:
        self.value = value

    def incr(self, delta: int = 1) -> None:
        if STATS_ENABLED:
            self.value += delta

    def __int__(self) -> int:
        return self.value


class Aggregate:
    """Running min/max/mean/stdev over added values.

    Reference: thrill/common/aggregate.hpp (used e.g. for per-worker
    balance statistics in SortNode, api/sort.hpp:656-662).
    """

    __slots__ = ("count", "total", "min", "max", "_mean", "_m2")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._mean = 0.0
        self._m2 = 0.0

    def add(self, x: float) -> "Aggregate":
        x = float(x)
        self.count += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        d = x - self._mean
        self._mean += d / self.count
        self._m2 += d * (x - self._mean)
        return self

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def stdev(self) -> float:
        if self.count < 2:
            return 0.0
        return math.sqrt(self._m2 / (self.count - 1))

    def __iadd__(self, other: "Aggregate") -> "Aggregate":
        if other.count:
            new_count = self.count + other.count
            delta = other._mean - self._mean
            self._m2 += (other._m2 + delta * delta * self.count
                         * other.count / new_count)
            self._mean = (self._mean * self.count
                          + other._mean * other.count) / new_count
            self.count = new_count
            self.total += other.total
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        return self
