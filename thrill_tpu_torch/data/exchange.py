"""The dense exchange between the mesh's virtual workers (counterpart
of the dense subset of the reference package's ``data/exchange.py``).

Every helper works on all W workers at once: row ``w`` of a ``[W, ...]``
tensor is worker ``w``'s local value. The reference's ``all_to_all``
over the mesh axis becomes a transpose of the worker dimension.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..common import tree as pt
from ..core.device_sort import argsort_words
from ..core.pallas_kernels import partition_histogram
from ..core.rowmove import scatter_slots, take_rows, take_rows_multi
from ..parallel.mesh import MeshExec
from .shards import DeviceShards, round_up_pow2


def send_counts(dest: torch.Tensor, W: int) -> torch.Tensor:
    """``[W, W]`` int32 send matrix: ``S[s, d]`` items of worker ``s``
    go to worker ``d``. ``dest`` ``[W, cap]`` (int32 or int64, read as it
    is) uses ``W`` for invalid items, which the histogram kernel does not
    count."""
    return partition_histogram(dest, W)


def send_slot_index(dest: torch.Tensor, S: torch.Tensor, W: int,
                    M_pad: int, cap: int) -> torch.Tensor:
    """Flat scatter index of each item of ``dest`` ``[W, cap]`` into the
    W send buffers of ``W * M_pad`` rows plus ``cap`` dump rows
    (``scatter_slots``): block ``d``, slot ``i - start of d``; an invalid
    item goes to its dump row. ``dest`` must be grouped by destination
    per worker."""
    S = S.to(torch.int64)
    off = torch.cumsum(S, dim=1) - S                  # [W, W] exclusive
    dc = dest.to(torch.int64).clamp(0, W - 1)
    slot = torch.arange(cap, device=dest.device)[None, :] - torch.gather(
        off, 1, dc)
    return scatter_slots(dc * M_pad + slot, dest < W, W * M_pad)


def ship_blocks(x: torch.Tensor, send_idx: torch.Tensor, W: int,
                M_pad: int) -> torch.Tensor:
    """Scatter each worker's ``[cap, ...]`` rows of ``x`` into ``[W,
    M_pad]`` padded blocks, one per destination, and exchange them: the
    result ``[W, W * M_pad, ...]`` holds for each receiver the blocks of
    its senders in rank order.

    ``send_idx`` comes from :func:`send_slot_index`; no two rows share a
    slot.
    """
    trail = tuple(x.shape[2:])
    per = W * M_pad + x.shape[1]
    buf = torch.zeros((W * per,) + trail, dtype=x.dtype, device=x.device)
    buf.index_put_((send_idx,), x.reshape((-1,) + trail))
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


def exchange(shards: DeviceShards, dest_builder: Callable) -> DeviceShards:
    """Move every valid item to the worker ``dest_builder`` names
    (counterpart of the reference's ``_phase_a`` plus ``exchange``).

    ``dest_builder(tree, mask, widx)`` sees the ``[W, cap, ...]`` leaves,
    the ``[W, cap]`` valid mask and the ``[W, 1]`` worker indices and
    returns ``[W, cap]`` destinations; invalid rows are dropped and
    valid ones clipped to ``[0, W)``. Each worker sorts its rows stably
    by destination, the send matrix is read once on the host, the blocks
    are shipped, and each receiver keeps its senders' runs in rank order,
    each run in its sender's order. The output capacity is the largest
    receive count rounded up to a power of two.
    """
    mex = shards.mesh_exec
    W, cap, dev = mex.num_workers, shards.cap, mex.device
    leaves, td = pt.flatten(shards.tree)
    mask = shards.valid_mask()
    widx = torch.arange(W, device=dev)[:, None]
    dest = torch.as_tensor(dest_builder(shards.tree, mask, widx),
                           device=dev).to(torch.int64)
    dest = torch.where(mask, dest.clamp(0, W - 1), torch.full_like(dest, W))
    perm = argsort_words([dest], [W.bit_length()], passes=mex.radix_passes)
    sorted_dest = torch.gather(dest, 1, perm)
    sorted_leaves = take_rows_multi(leaves, perm)
    S = mex.fetch(send_counts(sorted_dest, W)).astype(np.int64)
    R = S.sum(axis=0)
    M_pad = max(int(S.max()), 1)
    out_cap = round_up_pow2(max(int(R.max()), 1))
    account_traffic(mex, S, leaf_item_bytes(leaves))
    S_dev = mex.put_small(S)
    send_idx = send_slot_index(sorted_dest, S_dev, W, M_pad, cap)
    # receiver w's output row r comes from the sender s whose run holds
    # it: runs start at roff[w, s] and lie in block s of the received
    # [W * M_pad] rows; rows past R[w] read some shipped row (padding)
    incl = torch.cumsum(S_dev.T, dim=1)                      # [recv, send]
    r = torch.arange(out_cap, device=dev).expand(W, out_cap).contiguous()
    src = torch.searchsorted(incl, r, right=True).clamp(max=W - 1)
    roff = incl - S_dev.T
    pos = (src * M_pad + r - torch.gather(roff, 1, src)).clamp(
        0, W * M_pad - 1)
    out = [take_rows(ship_blocks(l, send_idx, W, M_pad), pos)
           for l in sorted_leaves]
    return DeviceShards(mex, pt.unflatten(td, out), R)
