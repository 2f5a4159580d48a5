"""Distributed item storage: columnar ``[W, cap, ...]`` leaves plus
per-worker valid counts (counterpart of the reference package's
``data/shards.py``, device storage only).

Rows ``[0, counts[w])`` of worker ``w`` are its items; rows past the
count are padding whose contents are unspecified.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from ..common import tree as pt
from ..common.partition import dense_range_bounds
from ..core.rowmove import row_cumsum, scatter_slots, take_rows
from ..parallel.mesh import DeviceLike, MeshExec


def round_up_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


class DeviceShards:
    """Leaves ``[W, cap, ...]`` on the mesh's device, counts on the host
    (numpy ``[W]`` int64)."""

    def __init__(self, mesh_exec: MeshExec, tree: Any,
                 counts: np.ndarray) -> None:
        self.mesh_exec = mesh_exec
        self.tree = tree
        self.counts = np.asarray(counts, dtype=np.int64)

    @property
    def num_workers(self) -> int:
        return self.mesh_exec.num_workers

    @property
    def cap(self) -> int:
        return pt.leaves(self.tree)[0].shape[1]

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def counts_device(self) -> torch.Tensor:
        """Counts as a ``[W]`` int64 tensor on the device."""
        return self.mesh_exec.put_small(self.counts)

    def valid_mask(self) -> torch.Tensor:
        """``[W, cap]`` bool: row is one of its worker's items."""
        ar = torch.arange(self.cap, device=self.mesh_exec.device)
        return ar[None, :] < self.counts_device()[:, None]

    @staticmethod
    def from_global_numpy(mesh_exec: MeshExec, tree: Any,
                          counts=None) -> "DeviceShards":
        """Range-split one global pytree (item axis 0; numpy arrays or
        tensors) across the workers, order preserved: evenly, or worker
        ``w`` taking the next ``counts[w]`` items."""
        W = mesh_exec.num_workers
        dev = mesh_exec.device
        leaves, td = pt.flatten(tree)
        n = int(leaves[0].shape[0]) if leaves else 0
        bnd = (dense_range_bounds(n, W) if counts is None else
               np.concatenate([[0], np.cumsum(counts)]).astype(np.int64))
        counts = np.diff(bnd)
        cap = round_up_pow2(int(counts.max()))
        # rows past a worker's count repeat row n-1 (masked by counts)
        idx = np.minimum(np.arange(cap)[None, :] + bnd[:W, None],
                         max(n - 1, 0)).reshape(-1)
        idx_t = torch.as_tensor(idx, device=dev)

        def place(leaf):
            t = torch.as_tensor(leaf).to(dev)
            if n == 0:
                return torch.zeros((W, cap) + tuple(t.shape[1:]),
                                   dtype=t.dtype, device=dev)
            return t.index_select(0, idx_t).reshape(
                (W, cap) + tuple(t.shape[1:]))

        return DeviceShards(mesh_exec, pt.unflatten(td, [place(l) for l in leaves]),
                            counts)

    def to_worker_arrays(self) -> List[Any]:
        """W pytrees of numpy arrays, trimmed to the counts."""
        host = pt.tree_map(self.mesh_exec.fetch, self.tree)
        return [pt.tree_map(lambda a, w=w: a[w, :int(self.counts[w])], host)
                for w in range(self.num_workers)]

    def to_global_numpy(self) -> Any:
        """All workers' items concatenated in worker-rank order."""
        per_worker = self.to_worker_arrays()
        return pt.tree_map(lambda *ls: np.concatenate(ls, axis=0),
                           *per_worker)


def from_numpy_shards(tree: Any, counts, device: DeviceLike = None
                      ) -> DeviceShards:
    """Shards given as ``[W, cap, ...]`` numpy leaves plus counts (for
    instance the reference package's DeviceShards fetched to the host)
    as the port's DeviceShards on a new W-worker mesh."""
    counts = np.asarray(counts, dtype=np.int64)
    mex = MeshExec(num_workers=len(counts), device=device)
    leaves, td = pt.flatten(tree)
    for l in leaves:
        if l.shape[0] != len(counts):
            raise ValueError(f"leaf of shape {l.shape} does not lead "
                             f"with W={len(counts)}")
    return DeviceShards(
        mex, pt.unflatten(td, [torch.tensor(np.asarray(l), device=mex.device)
                               for l in leaves]), counts)


def compact_valid(tree: Any, mask: torch.Tensor) -> Tuple[Any, torch.Tensor]:
    """Move each worker's valid rows to the front, stably.

    ``tree`` leaves ``[W, n, ...]``, ``mask`` ``[W, n]`` bool. Returns
    (tree, counts ``[W]``). One scatter of row indices builds each
    output row's source (invalid rows go to dump rows), and every leaf is
    gathered by it. Rows past a worker's count repeat row 0.
    """
    W, n = mask.shape
    region = 2 * n
    src = torch.zeros(W * region, dtype=torch.int64, device=mask.device)
    src.index_put_((scatter_slots(row_cumsum(mask) - 1, mask, n),),
                   torch.arange(n, device=mask.device).repeat(W))
    src = src.reshape(W, region)[:, :n]
    return pt.tree_map(lambda l: take_rows(l, src), tree), mask.sum(dim=1)
