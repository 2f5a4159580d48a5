"""Row movement by a permutation (counterpart of the reference
package's ``core/rowmove.py``).

The reference packs sub-word payload columns into u32 words because a
TPU's lanes are 32 bits wide. Here a row of 1, 2, 4, 8 or 16 bytes (a
16-byte word of WordCount, say) is gathered as one element of that
width: torch's ``index_select`` of rows with a trailing dim dominated a
WordCount on the H100 (PERF.md). Other rows go through a plain
``index_select``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

# one element per row for these row sizes (bytes); complex128 is only a
# 16-byte container here, copied bit for bit, never computed on
_WIDE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64,
         16: torch.complex128}


def _select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0, a row of a narrow trailing shape taken as
    one wide element."""
    trail = tuple(x.shape[1:])
    wide = _WIDE.get(x.element_size() * x[:1].numel()) if trail else None
    if wide is None or not x.is_contiguous():
        return x.index_select(0, idx)
    rows = x.view(torch.uint8).reshape(x.shape[0], -1).view(wide)
    return rows.reshape(-1).index_select(0, idx).view(torch.uint8).view(
        x.dtype).reshape((idx.shape[0],) + trail)


def scatter_slots(pos: torch.Tensor, keep: torch.Tensor,
                  size: int) -> torch.Tensor:
    """Flat scatter index of ``[W, n]`` rows into W regions of ``size +
    n`` rows each: ``pos`` where ``keep``, else the row's own dump slot
    ``size + i``, which no caller reads. Dropped rows never share a slot:
    one shared dump slot took millions of colliding stores or atomics on
    the card, and even 4096 shared ones cost time (PERF.md)."""
    W, n = pos.shape
    i = torch.arange(n, device=pos.device)[None, :]
    slot = torch.where(keep, pos, size + i)
    return (slot + torch.arange(W, device=pos.device)[:, None]
            * (size + n)).reshape(-1)


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumsum along dim 1 of ``[W, n]`` ``x``: one scan
    of the flattened rows minus each row's offset (a scan along dim 1
    runs about one block per row on the card)."""
    W, n = x.shape
    if n == 0:
        return torch.zeros((W, 0), dtype=torch.int64, device=x.device)
    c = torch.cumsum(x.reshape(-1).to(torch.int64), 0).reshape(W, n)
    off = torch.zeros((W, 1), dtype=torch.int64, device=x.device)
    off[1:, 0] = c[:-1, -1]
    return c - off


def take_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` in the order ``perm``.

    ``perm`` ``[m]`` gathers ``x`` ``[n, ...]``; ``perm`` ``[W, m]``
    gathers each worker's rows of ``x`` ``[W, n, ...]`` independently.
    """
    if perm.dim() == 1:
        return _select(x, perm)
    W, n = x.shape[0], x.shape[1]
    flat = (perm + torch.arange(W, device=perm.device)[:, None] * n
            ).reshape(-1)
    trail = tuple(x.shape[2:])
    return _select(x.reshape((W * n,) + trail), flat).reshape(
        (W, perm.shape[1]) + trail)


def take_rows_multi(leaves: Sequence[torch.Tensor],
                    perm: torch.Tensor) -> List[torch.Tensor]:
    """:func:`take_rows` of every leaf by one shared permutation."""
    return [take_rows(l, perm) for l in leaves]
