"""Zip / ZipWithIndex (counterpart of the reference package's
``api/ops/zip_.py``; ZipWindow comes later).

Realignment is an index-range exchange: item ``g`` of a DIA goes to the
worker whose bound of the target partition holds it (the first DIA's
partition cut to the output size, or an even split in pad mode). A
partition that already matches is kept without an exchange. The local
zip then calls ``zip_fn`` on the batched columns of every worker.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...data import exchange
from ...data.shards import DeviceShards
from ..dia import DIA
from ..dia_base import DIABase
from ..stack import call_batched


def _offsets(shards: DeviceShards) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(shards.counts)])[:-1].astype(
        np.int64)


def _mask_tail(shards: DeviceShards, n_out: int) -> DeviceShards:
    """Trim counts so only the first ``n_out`` global items stay valid."""
    new_counts = np.clip(n_out - _offsets(shards), 0, shards.counts)
    return DeviceShards(shards.mesh_exec, shards.tree,
                        new_counts.astype(np.int64))


def _realign(shards: DeviceShards, target_bounds: np.ndarray,
             n_out: int) -> DeviceShards:
    """Worker ``w`` gets global items ``[target_bounds[w],
    target_bounds[w+1])``; items from ``n_out`` on are dropped. Order is
    kept: the exchange is stable and receivers keep senders' rank
    order."""
    mex = shards.mesh_exec
    offsets = mex.put_small(_offsets(shards))
    upper = mex.put_small(np.asarray(target_bounds[1:], dtype=np.int64))

    def dest(tree, mask, widx):
        cap = mask.shape[1]
        g = offsets[:, None] + torch.arange(cap, device=mex.device)[None, :]
        return torch.searchsorted(upper, g, right=True)

    # the exchange clips valid destinations into [0, W): the tail past
    # n_out must be invalid before it runs, or it lands on worker W-1
    return exchange.exchange(_mask_tail(shards, n_out), dest)


def _realign_or_keep(p: DeviceShards, tb: np.ndarray,
                     n_out: int) -> DeviceShards:
    off = np.concatenate([[0], np.cumsum(p.counts)])
    if len(off) == len(tb) and np.array_equal(np.clip(off, 0, n_out), tb):
        return _mask_tail(p, n_out)
    return _realign(p, tb, n_out)


def _zero_beyond_count(shards: DeviceShards) -> DeviceShards:
    """Zero every row at or past its worker's count: the pad items. The
    exchange leaves copies of shipped rows there."""
    mask = shards.valid_mask()

    def zero(leaf):
        m = mask.reshape(mask.shape + (1,) * (leaf.dim() - 2))
        return torch.where(m, leaf, torch.zeros((), dtype=leaf.dtype,
                                                device=leaf.device))

    return DeviceShards(shards.mesh_exec, pt.tree_map(zero, shards.tree),
                        shards.counts.copy())


def _repad(shards: DeviceShards, cap: int) -> DeviceShards:
    """Zero rows appended up to capacity ``cap``."""
    if shards.cap >= cap:
        return shards
    pad = cap - shards.cap
    tree = pt.tree_map(lambda l: torch.cat(
        [l, torch.zeros((l.shape[0], pad) + tuple(l.shape[2:]),
                        dtype=l.dtype, device=l.device)], dim=1), shards.tree)
    return DeviceShards(shards.mesh_exec, tree, shards.counts)


class ZipNode(DIABase):
    def __init__(self, ctx, links, zip_fn: Optional[Callable],
                 mode: str) -> None:
        super().__init__(ctx, "Zip", links)
        if mode not in ("strict", "cut", "pad"):
            raise ValueError(f"Zip: unknown mode {mode!r}")
        self.zip_fn = zip_fn
        self.mode = mode

    def _out_size(self, totals: List[int]) -> int:
        if self.mode == "cut":
            return min(totals)
        if self.mode == "pad":
            return max(totals)
        if len(set(totals)) != 1:
            raise ValueError(
                f"Zip: unequal sizes {totals}; use mode='cut' or 'pad'")
        return totals[0]

    def compute(self) -> DeviceShards:
        pulls = [l.pull() for l in self.parents]
        mex = pulls[0].mesh_exec
        W = mex.num_workers
        totals = [p.total for p in pulls]
        n_out = self._out_size(totals)
        if self.mode == "pad" and max(totals) != min(totals):
            # every input realigned to an even split of n_out; a short
            # input's missing rows are zero items
            tb = dense_range_bounds(n_out, W)
            counts = np.diff(tb).astype(np.int64)
            aligned = [
                DeviceShards(mex, _repad(_zero_beyond_count(
                    _realign_or_keep(p, tb, n_out)), int(counts.max())).tree,
                             counts.copy())
                for p in pulls]
        else:
            # the first DIA's partition, cut to n_out
            tb = np.clip(np.concatenate([[0], np.cumsum(pulls[0].counts)]),
                         0, n_out)
            counts = np.diff(tb).astype(np.int64)
            aligned = [_realign_or_keep(p, tb, n_out) for p in pulls]
        cap = max(a.cap for a in aligned)
        trees = [_repad(a, cap).tree for a in aligned]
        return DeviceShards(mex, call_batched(self.zip_fn, trees, W, cap,
                                              mex.device), counts)


def _zwi_default(it, i):
    return (it, i)


class ZipWithIndexNode(DIABase):
    """``zip_fn(item, global_index)`` (reference: api/zip_with_index.hpp)."""

    def __init__(self, ctx, link, zip_fn: Optional[Callable]) -> None:
        super().__init__(ctx, "ZipWithIndex", [link])
        self.zip_fn = zip_fn or _zwi_default

    def compute(self) -> DeviceShards:
        shards = self.parents[0].pull()
        mex = shards.mesh_exec
        W, cap = shards.num_workers, shards.cap
        g = (mex.put_small(_offsets(shards))[:, None]
             + torch.arange(cap, device=mex.device)[None, :])
        tree = call_batched(self.zip_fn, [shards.tree, g], W, cap,
                            mex.device)
        return DeviceShards(mex, tree, shards.counts.copy())


def Zip(dias: List[DIA], zip_fn=None, mode: str = "strict") -> DIA:
    if len(dias) < 2:
        raise ValueError("Zip needs at least two DIAs")
    return DIA(ZipNode(dias[0].context, [d._link() for d in dias], zip_fn,
                       mode))


def ZipWithIndex(dia: DIA, zip_fn=None) -> DIA:
    return DIA(ZipWithIndexNode(dia.context, dia._link(), zip_fn))
