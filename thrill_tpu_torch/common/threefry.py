"""jax's default PRNG in torch: threefry2x32, bit for bit.

The reference package draws with ``jax.random`` under two settings it
runs with: ``jax_enable_x64`` on (so ``uniform`` draws f64 by default)
and ``jax_threefry_partitionable`` on (jax's default since 0.5), where
element ``i`` of a draw of shape ``s`` hashes the 64-bit counter ``i``
(row-major over ``s``) split into its high and low 32-bit words. This
module computes the same bits on any torch device:

* :func:`prng_key` is ``jax.random.PRNGKey(seed)`` (the seed as an
  int64: high word, low word);
* :func:`fold_in` is ``jax.random.fold_in(key, data)``;
* :func:`random_bits` is ``jax.random.bits`` of 32 or 64 bits;
* :func:`uniform` is ``jax.random.uniform`` in [0, 1), f64 or f32, by
  the same mantissa fill (random high bits under the exponent of 1.0,
  minus 1.0).

Every 32-bit word lives in an int64 tensor, masked to ``[0, 2^32)``
after each add (fault C1's rule: torch has no unsigned 32-bit
arithmetic on every device), so the CPU and the card compute the same
bits. A key is a pair of Python ints (what :func:`prng_key` gives, and
:func:`fold_in` of it by an int: computed on the host, no upload, so a
program that draws can run inside a CUDA graph) or an int64 tensor
``[..., 2]`` (a batch of keys, one a leading index).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

Key = Union[Tuple[int, int], torch.Tensor]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    # v < 2^32 and r <= 29: v << r stays below 2^61, no sign bit
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher of 20 rounds on counter words
    ``(x0, x1)`` under key ``(k0, k1)`` (words in ``[0, 2^32)``; ints or
    int64 tensors that broadcast). Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _words(key: Key):
    if isinstance(key, torch.Tensor):
        return key[..., 0], key[..., 1]
    return int(key[0]), int(key[1])


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed as an int64, its high and
    low 32-bit words."""
    s = int(seed)
    if not -(1 << 63) <= s < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit an int64")
    s &= (1 << 64) - 1
    return s >> 32, s & _M32


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``: ``data`` as a uint32, hashed as
    the counter ``(0, data)``. An int key and an int ``data`` give an int
    pair; a tensor ``data`` gives one key per element, ``[..., 2]``, on
    its device."""
    k0, k1 = _words(key)
    if isinstance(data, int) and not isinstance(key, torch.Tensor):
        return threefry2x32(k0, k1, 0, data & _M32)
    d = torch.as_tensor(data, dtype=torch.int64,
                        device=key.device if isinstance(key, torch.Tensor)
                        else None) & _M32
    if isinstance(key, torch.Tensor):
        k0 = k0.reshape(k0.shape + (1,) * (d.dim() - k0.dim()))
        k1 = k1.reshape(k1.shape + (1,) * (d.dim() - k1.dim()))
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    n = 1
    for d in shape:
        n *= int(d)
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))
    return i >> 32, i & _M32


def _bits_pair(key: Key, shape: Sequence[int], device):
    """The two output words for every element of ``shape``: a ``[...,
    2]`` key tensor draws the array of ``shape`` once per leading
    index."""
    if isinstance(key, torch.Tensor):
        device = key.device
    hi, lo = _counters(shape, device)
    k0, k1 = _words(key)
    if isinstance(key, torch.Tensor):
        lead = tuple(key.shape[:-1])
        k0 = k0.reshape(lead + (1,) * len(shape))
        k1 = k1.reshape(lead + (1,) * len(shape))
    return threefry2x32(k0, k1, hi, lo)


def random_bits(key: Key, bit_width: int, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32|uint64)`` as int64 (the 64-bit
    pattern in its two's-complement view), on ``device`` for an int
    key. A ``[..., 2]`` key batch draws one array of ``shape`` per
    key."""
    b0, b1 = _bits_pair(key, shape, device)
    if bit_width == 32:
        return b0 ^ b1
    if bit_width == 64:
        # (b0 << 32) | b1 as an unsigned 64-bit pattern: the high word's
        # top bit becomes the sign bit
        hi = torch.where(b0 >= (1 << 31), b0 - (1 << 32), b0)
        return (hi << 32) | b1
    raise ValueError(f"bit_width {bit_width}: 32 or 64")


def uniform(key: Key, shape: Sequence[int],
            dtype: torch.dtype = torch.float64, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` in [0, 1): the draw's
    top mantissa bits under the exponent of 1.0, minus 1.0."""
    if dtype == torch.float64:
        bits = random_bits(key, 64, shape, device)
        # logical shift right by 12: mask the sign extension away
        mant = (bits >> 12) & ((1 << 52) - 1)
        return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape, device)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32)
        return f.view(torch.float32) - 1.0
    raise ValueError(f"uniform of {dtype}: float64 or float32")
