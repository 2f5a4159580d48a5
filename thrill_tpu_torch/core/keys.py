"""Key encoding: item keys to lexicographic 64-bit key words
(counterpart of the reference package's ``core/keys.py``).

The reference emits uint64 words. Torch on the CPU has no unsigned
64-bit shifts or compares, so the port carries every word as the int64
with the same bit pattern: ``w.view(uint64)`` on the host gives the
reference's value. Order between two words is unsigned order, which
signed compares give after ``w ^ SIGN_BIT`` (see :func:`order_view`).
Digits come out exactly as ``(w >> s) & 255`` in spite of the arithmetic
shift.

Encodings (all order-preserving, identical bits to the reference):
* unsigned ints  -> zero-extended
* signed ints    -> sign bit flipped
* floats         -> as float64: negative values all bits flipped, others
                    sign bit set (total order, -0 < +0, NaN last)
* uint8[..., L]  -> big-endian packed into ceil(L/8) words, zero padded
                    (memcmp order of fixed-width fields, e.g. TeraSort)
"""

from __future__ import annotations

from typing import Any, List

import torch

from ..common import tree as pt

SIGN_BIT = -(1 << 63)            # int64 with only bit 63 set

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def order_view(w: torch.Tensor) -> torch.Tensor:
    """int64 key word -> int64 whose signed order is the word's
    unsigned order."""
    return w ^ SIGN_BIT


def encode_key_words(key_tree: Any) -> List[torch.Tensor]:
    """Encode a batched key pytree (leaves ``[n]`` or ``[n, L]``) to a
    list of int64 ``[n]`` key words, most significant first."""
    words: List[torch.Tensor] = []
    for leaf in pt.leaves(key_tree):
        dt = leaf.dtype
        if dt == torch.uint8 and leaf.dim() >= 2:
            words.extend(_pack_bytes(leaf))
        elif dt in _UNSIGNED:
            words.append(leaf.to(torch.int64))
        elif dt == torch.uint64:
            words.append(leaf.view(torch.int64))
        elif dt == torch.bool or not (dt.is_floating_point
                                      or dt.is_complex):
            words.append(leaf.to(torch.int64) ^ SIGN_BIT)
        elif dt.is_floating_point:
            bits = leaf.to(torch.float64).view(torch.int64)
            words.append(torch.where(bits < 0, ~bits, bits | SIGN_BIT))
        else:
            raise TypeError(f"unsupported key leaf dtype {dt}")
    if not words:
        raise ValueError("key function produced an empty pytree")
    return words


def worker_key_words(key_fn, tree: Any) -> List[torch.Tensor]:
    """Key words ``[W, cap]`` of every row of ``[W, cap, ...]`` leaves:
    ``key_fn`` sees the batched columns of all workers as one item
    axis."""
    W, cap = pt.leaves(tree)[0].shape[:2]
    flat = pt.tree_map(lambda l: l.reshape((W * cap,) + tuple(l.shape[2:])),
                       tree)
    return [w.reshape(W, cap) for w in encode_key_words(key_fn(flat))]


def _pack_bytes(leaf: torch.Tensor) -> List[torch.Tensor]:
    """``[..., L]`` uint8 -> ceil(L/8) big-endian words ``[...]``: the
    bytes, zero padded to whole words, reversed within each word and
    read as little-endian int64."""
    L = leaf.shape[-1]
    k = -(-L // 8)
    if L < 8 * k:
        leaf = torch.nn.functional.pad(leaf, (0, 8 * k - L))
    be = leaf.reshape(leaf.shape[:-1] + (k, 8)).flip(-1).contiguous()
    words = be.view(torch.int64).reshape(leaf.shape[:-1] + (k,))
    return [words[..., j] for j in range(k)]
