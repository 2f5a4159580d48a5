"""Duplicate detection for host ReduceByKey (counterpart of the
reference package's ``core/duplicate_detection.py``; Thrill:
thrill/core/duplicate_detection.hpp:46): a key hash that only one worker
holds is globally unique, so its item cannot combine with anything on
another worker and need not be shuffled."""

from __future__ import annotations

from typing import Iterable, List, Set

import numpy as np

from .location_detection import _MASK, fingerprint


def find_non_unique_hashes(per_worker_hashes: List[Iterable[int]]
                           ) -> Set[int]:
    """Truncated hashes that two or more workers hold."""
    fps = [fingerprint(hs) for hs in per_worker_hashes]
    if not fps:
        return set()
    vals, counts = np.unique(np.concatenate(fps), return_counts=True)
    return set(vals[counts >= 2].tolist())


def is_unique(h: int, non_unique: Set[int]) -> bool:
    return (h & _MASK) not in non_unique
