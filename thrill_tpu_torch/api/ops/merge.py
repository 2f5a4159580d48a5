"""Merge of sorted DIAs (counterpart of the reference package's
``api/ops/merge.py``; Thrill's ``api/merge.hpp``).

The inputs are already sorted, and the design uses that, on all W
workers at once:

 1. sample:   quantile positions of every worker's sorted rows are
              direct reads of its key words: no sort, no payload move.
              The host merges every input's samples in unsigned order and
              picks W-1 splitters over (key words, input index, global
              index).
 2. classify: each input's destination is its rank among the splitters,
              monotone along the sorted input, so its rows ship through
              ``exchange_presorted`` with no destination sort; the send
              counts come from the histogram kernel (B1).
 3. combine:  each worker holds k x W sorted runs; one argsort of
              (invalid, key words, input index, global index) (B2) and
              one payload gather merge them (Sort's ``merge_blocks``).
              Equal keys order by input index, then by original
              position: the reference's order. Unlike Sort, Merge
              compacts each input's shipped blocks first: sorted inputs
              send most rows of a worker to one receiver, so the W x
              M_pad blocks would be mostly padding (2^24 rows a receiver
              against 2^23 compacted at W = 4 in ``chip_smoke.py``).

W == 1 skips the first two. Host storage merges the inputs' items with
``multiway_merge``. Across processes the samples and the send matrices
are every process's (``MeshExec.fetch_global``), so every process picks
the same splitters and plans the same exchange.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...core import keys as keymod
from ...core.multiway_merge import multiway_merge
from ...core.rowmove import take_rows
from ...data import exchange, multiplexer
from ...data.shards import DeviceShards, HostShards, round_up_pow2
from ..dia import DIA
from ..dia_base import DIABase
from .sort import (_lex_greater, device_splitters, host_samples,
                   merge_blocks, quantile_positions)


class MergeNode(DIABase):
    def __init__(self, ctx, links, key_fn: Optional[Callable]) -> None:
        super().__init__(ctx, "Merge", links)
        self.key_fn = key_fn or (lambda x: x)

    def compute(self):
        pulls = [l.pull() for l in self.parents]
        if any(isinstance(p, HostShards) for p in pulls):
            mex = self.context.mesh_exec
            seqs = [multiplexer.all_items(
                mex, p.to_host_shards("merge-host-path")
                if isinstance(p, DeviceShards) else p) for p in pulls]
            merged = list(multiway_merge(seqs, key=self.key_fn))
            return multiplexer.split_even(mex, merged,
                                          self.context.num_workers)
        return _device_merge(pulls, self.key_fn)


def _carrier(shards: DeviceShards, key_fn: Callable):
    """(key words ``[W, cap, nw]``, global index ``[W, cap]``) of an
    input's rows."""
    mex = shards.mesh_exec
    gidx = (mex.put_small(shards.offsets())[:, None]
            + torch.arange(shards.cap, device=mex.device)[None, :])
    words = keymod.worker_key_words(key_fn, shards.tree)
    return torch.stack(words, dim=2), gidx


def _splitters(mex, carriers, counts, nwords: int) -> torch.Tensor:
    """W-1 splitters ``[max(W-1, 1), nwords + 2]`` (int64 bit patterns)
    from every input's quantile samples, sorted as unsigned tuples of
    (key words, input index, global index)."""
    samples = []
    for i, ((wm, gidx), cnt) in enumerate(zip(carriers, counts)):
        qpos = quantile_positions(cnt, wm.shape[1])            # [W, S]
        samples += host_samples(mex, take_rows(wm, qpos),
                                torch.gather(gidx, 1, qpos),
                                qpos < cnt[:, None], tag=(i,))
    return device_splitters(mex, samples, mex.num_workers, nwords + 2)


def _device_merge(inputs: List[DeviceShards],
                  key_fn: Callable) -> DeviceShards:
    mex = inputs[0].mesh_exec
    W, dev = mex.num_workers, mex.device
    if sum(s.total for s in inputs) == 0:
        return inputs[0]
    carriers = [_carrier(s, key_fn) for s in inputs]
    nwords = carriers[0][0].shape[2]
    if W > 1:
        counts = [s.counts_device() for s in inputs]
        spl = _splitters(mex, carriers, counts, nwords)
        shipped = []
        for i, (s, (wm, gidx)) in enumerate(zip(inputs, carriers)):
            iw = torch.full(gidx.shape + (1,), i, dtype=torch.int64,
                            device=dev)
            words = torch.cat([wm, iw], dim=2)
            d = torch.zeros(gidx.shape, dtype=torch.int32, device=dev)
            for j in range(W - 1):
                d += _lex_greater(words, gidx, spl[j]).to(torch.int32)
            dest = torch.where(s.valid_mask(), d, torch.full_like(d, W))
            S = mex.fetch_global(exchange.send_counts(dest, W)).astype(
                np.int64)
            leaves, td = pt.flatten((wm, gidx, s.tree))
            shipped.append(exchange.exchange_presorted(mex, td, dest,
                                                       leaves, S))
        inputs = [DeviceShards(mex, c.tree[2], c.counts) for c in shipped]
        carriers = [(c.tree[0], c.tree[1]) for c in shipped]
    new_counts = sum(s.counts for s in inputs)
    # one capacity on every process: every worker's largest count
    out = merge_blocks(mex.radix_passes,
                       [(s.valid_mask(), wm, gidx, pt.leaves(s.tree))
                        for s, (wm, gidx) in zip(inputs, carriers)],
                       round_up_pow2(int(mex.gather_host(new_counts).max())))
    return DeviceShards(mex, pt.unflatten(pt.flatten(inputs[0].tree)[1],
                                          out), new_counts)


def Merge(dias: List[DIA], key_fn=None) -> DIA:
    if not dias:
        raise ValueError("Merge needs at least one DIA")
    return DIA(MergeNode(dias[0].context, [d._link() for d in dias],
                         key_fn))
