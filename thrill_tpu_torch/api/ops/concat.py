"""Concat and Rebalance: even redistribution that keeps the global
order (counterpart of the reference package's ``api/ops/concat.py``;
Thrill: api/concat.hpp:35, rebalance.hpp:30).

Device path: every row carries its global index; the exchange routes it
to the worker that owns that index under an even split, and a stable
argsort by the carried index restores the order (the reference's
CatStream rank-ordered concatenation). Host path: the item lists in
order, re-split by ``dense_range_bounds``. Mixed storage demotes the
device inputs to the host. Across processes the global offsets and the
capacities come from every worker's counts, and the host path
replicates the items and keeps its own workers' share.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...core.device_sort import argsort_words
from ...core.rowmove import take_rows
from ...data import exchange, multiplexer
from ...data.shards import DeviceShards, HostShards, round_up_pow2
from ..dia import DIA
from ..dia_base import DIABase


def rebalance_to_even(mex, parts: List[DeviceShards],
                      token=()) -> DeviceShards:
    """The parts concatenated in list order (each in its worker-major
    order), evenly re-split: one carrier exchange (B1, and B2 for its
    destinations) and one order-restoring argsort (B2). Rows past the
    counts are zeros."""
    W, dev = mex.num_workers, mex.device
    n_total = 0
    carriers = []
    for p in parts:
        offs = p.offsets() + n_total
        n_total += p.total
        g = (mex.put_small(offs.astype(np.int64))[:, None]
             + torch.arange(p.cap, device=dev)[None, :])
        carriers.append(DeviceShards(mex, {"g": g, "tree": p.tree},
                                     p.counts.copy()))
    merged = _local_concat(carriers) if len(carriers) > 1 else carriers[0]
    upper = mex.put_small(dense_range_bounds(n_total, W)[1:])

    def dest(tree, mask, widx):
        return torch.searchsorted(upper, tree["g"], right=True)

    merged = exchange.exchange(merged, dest, ("concat_dest", token, W))
    merged.validate_pending()       # optimistic-exchange heal point
    # the exchange keeps each sender's run in order, but a worker that
    # held rows of several parts sends them part by part: sort by the
    # carried index, the padding (index n_total) last
    g = torch.where(merged.valid_mask(), merged.tree["g"],
                    torch.full((), n_total, dtype=torch.int64, device=dev))
    order = argsort_words([g], [max(int(n_total).bit_length(), 1)],
                          passes=mex.radix_passes)
    tree = pt.tree_map(lambda l: take_rows(l, order), merged.tree["tree"])
    return DeviceShards(mex, tree, merged.counts.copy()).zero_beyond_count()


def _local_concat(parts: List[DeviceShards]) -> DeviceShards:
    """Each worker's valid rows of every part, part after part; rows
    past the counts are zeros. Only rows below each part's counts are
    read (the exchange leaves copies past them: ROADMAP.md fault C4)."""
    mex = parts[0].mesh_exec
    dev = mex.device
    tds = [pt.flatten(p.tree)[1] for p in parts]
    if any(td != tds[0] for td in tds):
        raise ValueError("Concat/Union requires matching schemas")
    pc = np.stack([p.counts for p in parts])               # [P, W]
    counts = pc.sum(axis=0)
    # one capacity on every process: every worker's largest count
    cap = round_up_pow2(int(mex.gather_host(counts).max()))
    cum = mex.put_small(np.cumsum(pc, axis=0).T.copy())     # [W, P]
    start = cum - mex.put_small(pc.T.copy())
    cap_off = mex.put_small(np.concatenate(
        [[0], np.cumsum([p.cap for p in parts])[:-1]]).astype(np.int64))
    r = torch.arange(cap, device=dev).expand(len(counts), cap).contiguous()
    part = torch.searchsorted(cum, r, right=True).clamp_(max=len(parts) - 1)
    src = cap_off[part] + r - torch.gather(start, 1, part)
    valid = r < mex.put_small(counts)[:, None]
    src = torch.where(valid, src, torch.zeros((), dtype=torch.int64,
                                              device=dev))
    leaves = [pt.flatten(p.tree)[0] for p in parts]
    out = [take_rows(torch.cat(ls, dim=1), src) for ls in zip(*leaves)]
    return DeviceShards(mex, pt.unflatten(tds[0], out),
                        counts.astype(np.int64)).zero_beyond_count()


def host_lists(pulls, reason: str) -> List[HostShards]:
    """Every input as host lists: device inputs demoted."""
    return [p.to_host_shards(reason) if isinstance(p, DeviceShards) else p
            for p in pulls]


class ConcatNode(DIABase):
    def __init__(self, ctx, links) -> None:
        super().__init__(ctx, "Concat", links)

    def compute(self):
        pulls = [l.pull() for l in self.parents]
        if any(isinstance(p, HostShards) for p in pulls):
            hosts = host_lists(pulls, "concat-mixed-storage")
            mex = self.context.mesh_exec
            return multiplexer.split_even(
                mex, [it for h in hosts
                      for it in multiplexer.all_items(mex, h)],
                self.context.num_workers)
        return rebalance_to_even(self.context.mesh_exec, pulls, (self.id,))


class RebalanceNode(DIABase):
    def __init__(self, ctx, link) -> None:
        super().__init__(ctx, "Rebalance", [link])

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards):
            mex = self.context.mesh_exec
            return multiplexer.split_even(
                mex, multiplexer.all_items(mex, shards), shards.num_workers)
        return rebalance_to_even(self.context.mesh_exec, [shards],
                                 (self.id,))


def Concat(a: DIA, b: DIA) -> DIA:
    return DIA(ConcatNode(a.context, [a._link(), b._link()]))


def ConcatMany(dias: List[DIA]) -> DIA:
    if not dias:
        raise ValueError("ConcatMany needs at least one DIA")
    return DIA(ConcatNode(dias[0].context, [d._link() for d in dias]))
