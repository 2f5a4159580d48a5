"""Key-location discovery on host storage (counterpart of the reference
package's ``core/location_detection.py``; Thrill:
thrill/core/location_detection.hpp:70).

Before items are shuffled, each worker's key hashes, truncated to 32
bits, travel as a sorted fingerprint, delta and Golomb-Rice coded
(``core/golomb.py``); from them every hash maps to the workers that hold
it, so an item can target one of them, or be dropped when the other
side of a join holds no matching key. On one controller the exchange
is the codec's round trip, so its wire bytes are measured and the codec
runs on every fingerprint. The host join's location path goes through
:class:`LocationDetection`; the device path's counterpart is the join's
presence-register filter.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set, Tuple

import numpy as np

from .golomb import decode_sorted_np, encode_sorted_np, rice_parameter

HASH_SPACE_BITS = 32          # fingerprints truncated to 32-bit space
_MASK = (1 << HASH_SPACE_BITS) - 1


def fingerprint(hashes: Iterable[int]) -> np.ndarray:
    """Sorted unique truncated hashes of one worker's keys."""
    return np.unique(np.asarray([h & _MASK for h in hashes],
                                dtype=np.int64))


def encode_fingerprint(fp: np.ndarray) -> Tuple[bytes, int, int, int]:
    """The wire message of a fingerprint: (payload, nbits, count, k),
    the Rice parameter ``k`` from the mean gap of the hash space."""
    if len(fp) == 0:
        return b"", 0, 0, 0
    k = rice_parameter((1 << HASH_SPACE_BITS) / max(len(fp), 1))
    payload, nbits, count = encode_sorted_np(np.asarray(fp), k)
    return payload, nbits, count, k


def decode_fingerprint(msg: Tuple[bytes, int, int, int]) -> np.ndarray:
    payload, nbits, count, k = msg
    return decode_sorted_np(payload, nbits, count, k)


class LocationDetection:
    """Every worker's fingerprint, aggregated into a map from hash to
    the workers that hold it."""

    def __init__(self, num_workers: int) -> None:
        self.num_workers = num_workers
        self._present: Dict[int, List[int]] = {}

    def add_worker(self, worker: int, hashes: Iterable[int]) -> int:
        """Register a worker's key hashes; returns the bytes its encoded
        fingerprint takes on the wire."""
        msg = encode_fingerprint(fingerprint(hashes))
        for h in decode_fingerprint(msg).tolist():   # the codec's trip
            self._present.setdefault(h, []).append(worker)
        return len(msg[0])

    def workers_of(self, h: int) -> List[int]:
        return self._present.get(h & _MASK, [])

    def target_of(self, h: int) -> int:
        """The hash's home worker: its first holder, else the truncated
        hash modulo W (Thrill sends every matching item to one
        discovered location)."""
        ws = self.workers_of(h)
        return ws[0] if ws else (h & _MASK) % self.num_workers

    def common_hashes(self, other: "LocationDetection") -> Set[int]:
        """Truncated hashes present on both sides (a join's
        candidates)."""
        return set(self._present) & set(other._present)
