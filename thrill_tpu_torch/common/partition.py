"""The dense range split shared by every op that lays out a size-``n``
dense index space across ``W`` workers (a copy of the reference
package's ``common/partition.py``, kept here so the port imports
nothing of it)."""

from __future__ import annotations

import numpy as np


def dense_range_bounds(n: int, W: int) -> np.ndarray:
    """``W+1`` split points of ``range(n)`` over ``W`` workers:
    worker ``w`` owns ``[bounds[w], bounds[w+1])``."""
    return np.array([(w * n) // W for w in range(W + 1)],
                    dtype=np.int64)
