"""Key-location discovery on host storage (counterpart of the reference
package's ``core/location_detection.py``; Thrill:
thrill/core/location_detection.hpp:70): each worker's key hashes,
truncated to 32 bits, as a sorted fingerprint; a hash held on both sides
of a join marks keys that may find a partner.

The reference ships the fingerprints through a Golomb-Rice codec
(``core/golomb.py``, not ported) whose round trip gives them back as
they are, so the port keeps them as they are.
"""

from __future__ import annotations

from typing import Iterable, List, Set

import numpy as np

HASH_SPACE_BITS = 32
_MASK = (1 << HASH_SPACE_BITS) - 1


def fingerprint(hashes: Iterable[int]) -> np.ndarray:
    """Sorted unique truncated hashes of one worker's keys."""
    return np.unique(np.asarray([h & _MASK for h in hashes],
                                dtype=np.int64))


def common_hashes(left: List[Iterable[int]],
                  right: List[Iterable[int]]) -> Set[int]:
    """Truncated hashes that some worker holds on each side (the
    reference's ``LocationDetection.common_hashes`` of both sides)."""
    def held(per_worker):
        fps = [fingerprint(hs) for hs in per_worker]
        return set(np.concatenate(fps).tolist()) if fps else set()
    return held(left) & held(right)
