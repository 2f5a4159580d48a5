"""Row movement by a permutation (counterpart of the reference
package's ``core/rowmove.py``).

The reference packs sub-word payload columns into u32 words because a
TPU's lanes are 32 bits wide. Here a gather is a plain ``index_select``
of whole rows; packing waits for a measurement that asks for it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def take_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` in the order ``perm``.

    ``perm`` ``[m]`` gathers ``x`` ``[n, ...]``; ``perm`` ``[W, m]``
    gathers each worker's rows of ``x`` ``[W, n, ...]`` independently.
    """
    if perm.dim() == 1:
        return x.index_select(0, perm)
    W, n = x.shape[0], x.shape[1]
    flat = (perm + torch.arange(W, device=perm.device)[:, None] * n
            ).reshape(-1)
    trail = tuple(x.shape[2:])
    return x.reshape((W * n,) + trail).index_select(0, flat).reshape(
        (W, perm.shape[1]) + trail)


def take_rows_multi(leaves: Sequence[torch.Tensor],
                    perm: torch.Tensor) -> List[torch.Tensor]:
    """:func:`take_rows` of every leaf by one shared permutation."""
    return [take_rows(l, perm) for l in leaves]
