"""Sampling: the growing reservoir of the host Sort's splitters and the
global sample budget's split over workers (copies of
``ReservoirSamplingGrow`` and ``hypergeometric_split`` from the
reference package's ``common/sampling.py``, kept here so the port
imports nothing of it; both stay numpy, so the same generator gives the
reference's samples and split).
"""

from __future__ import annotations

import math
from typing import Generic, List, TypeVar

import numpy as np

T = TypeVar("T")


class ReservoirSamplingGrow(Generic[T]):
    """Reservoir sampling whose reservoir grows with the stream.

    Maintains a uniform sample of size ~ ``desired_imbalance**-2 * log2(n)``
    style growth: the reference grows the reservoir so relative splitter
    error stays bounded as more items arrive. We implement the same
    behavior with a simpler growth rule: size = max(min_size,
    ceil(growth_factor * sqrt(n))) capped at max_size.
    """

    def __init__(self, rng: np.random.Generator, min_size: int = 128,
                 max_size: int = 1 << 16, growth_factor: float = 4.0) -> None:
        self.rng = rng
        self.min_size = min_size
        self.max_size = max_size
        self.growth_factor = growth_factor
        self.count = 0
        self.samples: List[T] = []

    def desired_size(self) -> int:
        if self.count <= 0:
            return self.min_size
        want = int(math.ceil(self.growth_factor * math.sqrt(self.count)))
        return max(self.min_size, min(self.max_size, want))

    def add(self, item: T) -> None:
        self.count += 1
        size = self.desired_size()
        if self.count <= size:
            # stream shorter than reservoir: keep everything
            self.samples.append(item)
            return
        # admit with probability size/count even when the reservoir has
        # just grown (len < size); unconditional append here would bias
        # the sample toward items at growth boundaries
        j = int(self.rng.integers(0, self.count))
        if j < size:
            if len(self.samples) < size:
                self.samples.append(item)
            else:  # len == size here, so j indexes in range
                self.samples[j] = item

    def add_batch(self, items) -> None:
        for it in items:
            self.add(it)

    def add_batch_indexed(self, start: int, items) -> None:
        """Vectorized batch add of ``(start + i, items[i])`` pairs.

        Same admission distribution as per-item :meth:`add` (each item
        draws j ~ U[0, its running count) and is admitted iff
        j < desired_size at that count) with ONE vectorized draw per
        batch; pair tuples are only constructed for admitted items.
        The EM sort's spill loop calls this per run chunk — per-item
        Python sampling was a profiled hotspot there."""
        m = len(items)
        if m == 0:
            return
        i = 0
        # fill phase (stream shorter than the growing reservoir):
        # bounded by max(min_size, ...) early counts — rare past startup
        while i < m:
            self.count += 1
            if self.count > self.desired_size():
                self.count -= 1
                break
            self.samples.append((start + i, items[i]))
            i += 1
        if i == m:
            return
        counts = np.arange(self.count + 1, self.count + (m - i) + 1)
        sizes = np.clip(
            np.ceil(self.growth_factor * np.sqrt(counts)),
            self.min_size, self.max_size).astype(np.int64)
        draws = self.rng.integers(0, counts)
        self.count += m - i
        for k in np.flatnonzero(draws < sizes):
            item = (start + i + int(k), items[i + int(k)])
            j = int(draws[k])
            if len(self.samples) < int(sizes[k]):
                self.samples.append(item)
            else:
                self.samples[j] = item

    def sample_rate(self) -> float:
        if self.count == 0:
            return 1.0
        return len(self.samples) / self.count




def hypergeometric_split(rng: np.random.Generator, total_samples: int,
                         counts: np.ndarray) -> np.ndarray:
    """Split a global sample budget over partitions w/o communication bias.

    Given per-worker item counts, returns per-worker sample counts whose sum
    is ``total_samples``, distributed according to the multivariate
    hypergeometric distribution — i.e. exactly as if sampling
    ``total_samples`` items without replacement from the concatenation.
    Reference: thrill/api/sample.hpp:235 uses sequential hypergeometric
    draws the same way.
    """
    counts = np.asarray(counts, dtype=np.int64)
    n = int(counts.sum())
    k = min(int(total_samples), n)
    out = np.zeros(len(counts), dtype=np.int64)
    remaining_pop = n
    remaining_k = k
    for i, c in enumerate(counts):
        if remaining_k <= 0:
            break
        c = int(c)
        if remaining_pop <= c:
            out[i] = remaining_k
            remaining_k = 0
            break
        draw = int(rng.hypergeometric(c, remaining_pop - c, remaining_k))
        out[i] = draw
        remaining_k -= draw
        remaining_pop -= c
    return out
