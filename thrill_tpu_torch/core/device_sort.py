"""The device sort engine (counterpart of the reference package's
``core/device_sort.py``): one entry point, ``argsort_words``, a stable
argsort by a list of int64 key words (``core/keys.py``).

On a CUDA tensor it always takes the radix engine, so the histogram
and stable-partition kernels run. On the CPU it runs the plain engine:
a stable ``torch.argsort`` per word, from the last word to the first.
Choosing between engines by modelled cost on the H100 is later work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .keys import order_view
from .pallas_sort import radix_argsort_device


def plain_argsort_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable LSD argsort by whole words: ``torch.argsort(stable=True)``
    of each word's order view, last word first."""
    shape = words[0].shape
    words = [w if w.dim() == 2 else w.unsqueeze(0) for w in words]
    R, n = words[0].shape
    perm = torch.arange(n, device=words[0].device).expand(R, n).contiguous()
    for w in reversed(words):
        key = order_view(torch.gather(w, 1, perm))
        perm = torch.gather(perm, 1, torch.argsort(key, dim=1, stable=True))
    return perm.reshape(shape)


def argsort_words(words: List[torch.Tensor],
                  word_bits: Optional[Sequence[int]] = None,
                  passes: Optional[List[Tuple[int, int]]] = None,
                  sync_free: bool = False) -> torch.Tensor:
    """Stable argsort by key words (``[n]`` or per worker ``[W, n]``,
    lexicographic, unsigned order). ``word_bits`` bounds the used bits
    of each word for the radix engine; ``sync_free`` (with ``word_bits``)
    sorts by every digit of those bits without reading which are live."""
    dev = words[0].device
    if dev.type == "cuda":
        return radix_argsort_device(words, word_bits=word_bits,
                                    passes=passes, sync_free=sync_free)
    if dev.type != "cpu":
        raise ValueError(f"argsort_words: unsupported device {dev}")
    return plain_argsort_words(words)
