"""The global sample budget's split over workers (a copy of
``hypergeometric_split`` from the reference package's
``common/sampling.py``, kept here so the port imports nothing of it; it
stays numpy, so the same seed gives the reference's split)."""

from __future__ import annotations

import numpy as np


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
