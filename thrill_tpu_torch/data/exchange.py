"""The dense exchange between the mesh's virtual workers (counterpart
of the dense subset of the reference package's ``data/exchange.py``).

Every helper works on all W workers at once: row ``w`` of a ``[W, ...]``
tensor is worker ``w``'s local value. The reference's ``all_to_all``
over the mesh axis becomes a transpose of the worker dimension.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.pallas_kernels import partition_histogram
from ..parallel.mesh import MeshExec


def send_counts(dest: torch.Tensor, W: int) -> torch.Tensor:
    """``[W, W]`` int32 send matrix: ``S[s, d]`` items of worker ``s``
    go to worker ``d``. ``dest`` ``[W, cap]`` uses ``W`` for invalid
    items, which the histogram kernel does not count."""
    return partition_histogram(dest.to(torch.int32).contiguous(), W)


def send_slot_index(dest: torch.Tensor, S: torch.Tensor, W: int,
                    M_pad: int, cap: int) -> torch.Tensor:
    """``[W, cap]`` flat position of each item in its worker's
    ``[W * M_pad]`` send buffer, or the dump slot ``W * M_pad`` for an
    invalid item. ``dest`` must be grouped by destination per worker."""
    S = S.to(torch.int64)
    off = torch.cumsum(S, dim=1) - S                  # [W, W] exclusive
    dc = dest.to(torch.int64).clamp(0, W - 1)
    slot = torch.arange(cap, device=dest.device)[None, :] - torch.gather(
        off, 1, dc)
    return torch.where(dest < W, dc * M_pad + slot,
                       torch.full_like(dc, W * M_pad))


def ship_blocks(x: torch.Tensor, send_idx: torch.Tensor, W: int,
                M_pad: int) -> torch.Tensor:
    """Scatter each worker's ``[cap, ...]`` rows of ``x`` into ``[W,
    M_pad]`` padded blocks, one per destination, and exchange them: the
    result ``[W, W * M_pad, ...]`` holds for each receiver the blocks of
    its senders in rank order.

    Every invalid row goes to its worker's dump slot ``W * M_pad``, so
    duplicate indices land only there and ``index_put_``'s choice among
    them is never read.
    """
    trail = tuple(x.shape[2:])
    per = W * M_pad + 1
    flat = (send_idx + torch.arange(W, device=x.device)[:, None] * per
            ).reshape(-1)
    buf = torch.zeros((W * per,) + trail, dtype=x.dtype, device=x.device)
    buf.index_put_((flat,), x.reshape((-1,) + trail))
    blocks = buf.reshape((W, per) + trail)[:, :W * M_pad].reshape(
        (W, W, M_pad) + trail)                        # [src, dst, M_pad]
    return blocks.transpose(0, 1).reshape((W, W * M_pad) + trail)


def leaf_item_bytes(leaves: Sequence[torch.Tensor]) -> int:
    """Bytes of one item across ``[W, cap, ...]`` leaves."""
    return sum(l.element_size() * int(np.prod(l.shape[2:], dtype=np.int64))
               for l in leaves)


def account_traffic(mex: MeshExec, S: np.ndarray, item_bytes: int) -> None:
    """Count one logical exchange of send matrix ``S`` on the mesh:
    items and bytes that leave their worker (the diagonal stays)."""
    moved = int(S.sum()) - int(np.trace(S))
    mex.stats_exchanges += 1
    mex.stats_items_moved += moved
    mex.stats_bytes_moved += moved * item_bytes
