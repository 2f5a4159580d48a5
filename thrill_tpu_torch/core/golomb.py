"""Golomb-Rice coded bit streams over delta-coded sorted integers
(counterpart of the reference package's ``core/golomb.py``, byte for
byte).

Thrill's bit, Golomb and delta streams (thrill/core/bit_stream.hpp:29,
golomb_bit_stream.hpp:29,145, delta_stream.hpp) carry LocationDetection's
sorted hash lists compactly: sorted values are delta-coded and each
delta is Golomb-Rice encoded with parameter b = 2^k (the quotient in
unary, the remainder in k bits, most significant bit first).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np


class BitWriter:
    def __init__(self) -> None:
        self._bits: List[int] = []

    def put_bits(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def put_unary(self, q: int) -> None:
        self._bits.extend([1] * q)
        self._bits.append(0)

    def to_bytes(self) -> bytes:
        bits = self._bits
        out = bytearray((len(bits) + 7) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 1 << (7 - (i & 7))
        return bytes(out)

    def __len__(self) -> int:
        return len(self._bits)


class BitReader:
    def __init__(self, data: bytes, nbits: int) -> None:
        self.data = data
        self.nbits = nbits
        self.pos = 0

    def get_bit(self) -> int:
        b = (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v

    def get_unary(self) -> int:
        q = 0
        while self.get_bit():
            q += 1
        return q

    @property
    def exhausted(self) -> bool:
        return self.pos >= self.nbits


def rice_parameter(mean_delta: float) -> int:
    """Rice k ~ log2(mean delta) (reference picks b from the expected
    gap n_total/space like GolombKeyCounterPair setups)."""
    k = 0
    while (1 << (k + 1)) < mean_delta:
        k += 1
    return k


def encode_sorted(values: Iterable[int], k: int) -> tuple:
    """Delta + Rice(2^k) encode a sorted non-negative sequence.
    Returns (payload bytes, nbits, count)."""
    w = BitWriter()
    prev = -1
    count = 0
    for v in values:
        delta = v - prev - 1        # strictly increasing -> delta >= 0
        assert delta >= 0, "encode_sorted requires strictly increasing"
        w.put_unary(delta >> k)
        if k:
            w.put_bits(delta & ((1 << k) - 1), k)
        prev = v
        count += 1
    return w.to_bytes(), len(w), count


def decode_sorted(payload: bytes, nbits: int, count: int, k: int
                  ) -> Iterator[int]:
    r = BitReader(payload, nbits)
    prev = -1
    for _ in range(count):
        q = r.get_unary()
        rem = r.get_bits(k) if k else 0
        delta = (q << k) | rem
        prev = prev + delta + 1
        yield prev


def encode_sorted_np(values: np.ndarray, k: int) -> tuple:
    """Vectorized twin of :func:`encode_sorted` — bit-identical output
    (same MSB-first layout ``np.packbits`` produces), numpy-speed.

    The per-bit Python writer above costs about 1 us a bit; this one
    encodes a whole fingerprint column at numpy speed. Layout per value: ``delta >> k`` one-bits, a zero terminator, then
    the low ``k`` delta bits MSB-first.
    """
    v = np.asarray(values, dtype=np.int64)
    if v.size == 0:
        return b"", 0, 0
    if int(v[0]) < 0:
        raise AssertionError("encode_sorted requires strictly increasing")
    gaps = np.diff(v)
    if v.size > 1 and int(gaps.min()) <= 0:
        raise AssertionError("encode_sorted requires strictly increasing")
    deltas = np.empty(v.size, dtype=np.uint64)
    deltas[0] = np.uint64(int(v[0]))              # delta = v0 - (-1) - 1
    deltas[1:] = (gaps - 1).astype(np.uint64)
    q = deltas >> np.uint64(k)
    widths = q + np.uint64(1 + k)                 # bits per value
    ends = np.cumsum(widths)                      # bit offset AFTER value i
    total = int(ends[-1])
    bits = np.ones(total, dtype=np.uint8)         # unary runs default to 1
    # zero terminator of value i sits k+1 bits before its end
    bits[(ends - np.uint64(1 + k)).astype(np.int64)] = 0
    if k:
        rem = deltas & np.uint64((1 << k) - 1)
        for j in range(k):                        # MSB-first remainder
            bits[(ends - np.uint64(k - j)).astype(np.int64)] = \
                ((rem >> np.uint64(k - 1 - j)) & np.uint64(1)).astype(
                    np.uint8)
    return np.packbits(bits).tobytes(), total, int(v.size)


def decode_sorted_np(payload: bytes, nbits: int, count: int,
                     k: int) -> np.ndarray:
    """Vectorized twin of :func:`decode_sorted` (returns int64 array).

    Unary terminators interleave with fixed-width remainders, so the
    stream is walked value by value — but each step is O(log z) over
    the precomputed zero-bit positions (searchsorted), not a per-bit
    Python loop, and the remainder bits extract vectorized at the end.
    """
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8),
                         count=nbits)
    zeros_at = np.flatnonzero(bits == 0)
    starts = np.empty(count, dtype=np.int64)      # unary-run starts
    terms = np.empty(count, dtype=np.int64)       # zero-terminator pos
    pos = 0
    zi = 0
    for i in range(count):
        zi = np.searchsorted(zeros_at, pos, side="left")
        if zi >= len(zeros_at):
            raise ValueError("golomb: truncated Rice stream")
        z = int(zeros_at[zi])
        starts[i] = pos
        terms[i] = z
        pos = z + 1 + k
    if pos > nbits:
        raise ValueError("golomb: truncated Rice stream")
    q = (terms - starts).astype(np.uint64)
    deltas = q << np.uint64(k)
    if k:
        rem = np.zeros(count, dtype=np.uint64)
        for j in range(k):                        # MSB-first remainder
            rem = (rem << np.uint64(1)) | bits[terms + 1 + j].astype(
                np.uint64)
        deltas |= rem
    return (np.cumsum(deltas.astype(np.int64) + 1) - 1).astype(np.int64)
