"""Hash functions for partitioning (counterpart of the reference
package's ``common/hashing.py``): a splitmix64 finalizer over 64-bit key
words.

The reference hashes uint64 arrays. The port carries every word as the
int64 with the same bit pattern (see ``core/keys.py``), so:

* the constants above 2^63 are written as their two's-complement int64
  values;
* a logical right shift is the arithmetic one with the sign-extended
  high bits masked off;
* products and sums wrap modulo 2^64, as uint64 arithmetic does.

``h.view(uint64)`` on the host then gives the reference's hash bit for
bit. :func:`umod` is the unsigned remainder of such a word, which torch's
signed ``%`` is not.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _i64(u: int) -> int:
    """The int64 with the bit pattern of the uint64 ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


# splitmix64 finalizer constants
_C1 = _i64(0xBF58476D1CE4E5B9)
_C2 = _i64(0x94D049BB133111EB)
_GOLDEN = _i64(0x9E3779B97F4A7C15)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns."""
    x = x.to(torch.int64)
    x = x ^ _shr(x, 30)
    x = x * _C1
    x = x ^ _shr(x, 27)
    x = x * _C2
    return x ^ _shr(x, 31)


def hash_combine64(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Combine a new word into a running hash (boost-style)."""
    return mix64(h ^ (x + _GOLDEN + (h << 6) + _shr(h, 2)))


def hash_key_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Hash equally shaped int64 key words into one int64 word."""
    if not words:
        raise ValueError("hash_key_words needs at least one word")
    h = mix64(words[0] + _GOLDEN)
    for w in words[1:]:
        h = hash_combine64(h, w)
    return h


def umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h mod m`` with ``h`` read as an unsigned 64-bit word, for
    ``1 <= m <= 2^31``: ``(hi * (2^32 mod m) + lo) mod m`` from the two
    32-bit halves, every intermediate below 2^63."""
    if not 1 <= m <= 1 << 31:
        raise ValueError(f"umod: modulus {m} outside [1, 2^31]")
    hi = _shr(h, 32) % m
    lo = h & 0xFFFFFFFF
    return (hi * ((1 << 32) % m) + lo) % m


def np_mix64(x: np.ndarray) -> np.ndarray:
    """NumPy version of :func:`mix64` on uint64 (host path)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64)
        x = x ^ (x >> np.uint64(30))
        x = x * np.uint64(0xBF58476D1CE4E5B9)
        x = x ^ (x >> np.uint64(27))
        x = x * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x
