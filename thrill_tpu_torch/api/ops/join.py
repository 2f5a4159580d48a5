"""InnerJoin, device paths (counterpart of the reference package's
``api/ops/join.py``).

Sort-merge join: an optional location filter (kernel ``presence_fill``)
drops items whose key hash has no presence on the other side; both sides
are hash-exchanged by key; each worker sorts both sides by key words and
counts, for every right item, its run of equal left keys (one combined
stable argsort per bound, validity a prepended sort word); one host sync
reads the per-worker pair totals, which size the output; the expansion
gathers the (left, right) pairs in sorted right order, each right item's
lefts in sorted left order, and applies ``join_fn`` batched.

Dense-index join (``dense_right_index=n``): the right side is a dense
table whose row at global position ``g`` has key ``g``; the join is a
gather of the table's ``[W * rcap]`` rows by the left keys, with no
sort and no exchange.

Not ported: the reference's hinted path (``out_size_hint`` with a
deferred overflow check), which needs lazily counted shards; the hint is
accepted and the output is sized from the exact totals.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ...common import hashing
from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...core import keys as keymod
from ...core import preshuffle
from ...core import segmented
from ...core.device_sort import argsort_words
from ...core.pallas_kernels import presence_fill
from ...core.rowmove import row_cumsum, scatter_slots, take_rows
from ...data import exchange
from ...data.shards import DeviceShards, compact_valid, round_up_pow2
from ..dia import DIA
from ..dia_base import DIABase
from ..stack import call_batched


def _flat(tree):
    """``[W, cap, ...]`` leaves as ``[W * cap, ...]``."""
    return pt.tree_map(lambda l: l.reshape((-1,) + tuple(l.shape[2:])),
                       tree)


class InnerJoinNode(DIABase):
    def __init__(self, ctx, llink, rlink, lkey, rkey, join_fn,
                 location_detection=None, out_size_hint=None,
                 dense_right_index=None) -> None:
        super().__init__(ctx, "InnerJoin", [llink, rlink])
        if dense_right_index is not None and rkey is not None:
            raise ValueError(
                "InnerJoin: dense_right_index defines the right key as "
                "the row's dense position; right_key_fn must be None")
        self.lkey = lkey
        self.rkey = rkey
        self.join_fn = join_fn
        self.location_detection = location_detection
        self.out_size_hint = out_size_hint
        self.dense_right_index = (None if dense_right_index is None
                                  else int(dense_right_index))

    def compute(self) -> DeviceShards:
        left = self.parents[0].pull()
        right = self.parents[1].pull()
        if self.dense_right_index is not None:
            return self._compute_dense(left, right)
        left, right = self._prep_device(left, right)
        return _sort_merge(left, right, self.lkey, self.rkey, self.join_fn)

    # -- sort-merge join -------------------------------------------------
    def _prep_device(self, left: DeviceShards, right: DeviceShards
                     ) -> Tuple[DeviceShards, DeviceShards]:
        """The location filter (by the cost model's verdict unless
        forced), then the hash exchange of both sides."""
        mex = left.mesh_exec
        W = mex.num_workers
        if W == 1:
            return left, right
        ld = self.location_detection
        if ld is None:
            rows, item_bytes = preshuffle.join_rows_estimate(left, right)
            ld = preshuffle.auto_location_detect(
                mex, rows, item_bytes,
                ("join_dev", (self.lkey, self.rkey, self.join_fn)))
        if ld:
            left, right = _location_filter(left, right, self.lkey,
                                           self.rkey)
        return (exchange.exchange(left, _hash_dest(self.lkey, W)),
                exchange.exchange(right, _hash_dest(self.rkey, W)))

    # -- dense-index join --------------------------------------------------
    def _dense_bounds(self) -> np.ndarray:
        return dense_range_bounds(self.dense_right_index,
                                  self.context.num_workers)

    def _check_dense(self, right: DeviceShards) -> None:
        expect = np.diff(self._dense_bounds())
        if not np.array_equal(right.counts, expect):
            raise ValueError(
                f"InnerJoin dense_right_index={self.dense_right_index}: "
                f"right side counts {right.counts.tolist()} do not form "
                f"the dense range split {expect.tolist()}")

    def _compute_dense(self, left: DeviceShards,
                       right: DeviceShards) -> DeviceShards:
        """Worker ``w``'s rows of the table lie at ``[w * rcap, w * rcap
        + count)`` of its ``[W * rcap]`` reshape (the reference's
        all_gather); a left key in range picks its row, a key out of
        range gives no pair."""
        self._check_dense(right)
        mex = left.mesh_exec
        W, lcap, rcap = mex.num_workers, left.cap, right.cap
        n = self.dense_right_index
        b = mex.put_small(self._dense_bounds())
        key = torch.as_tensor(self.lkey(_flat(left.tree)),
                              device=mex.device).to(torch.int64)
        w = torch.searchsorted(b[1:], key, right=True).clamp(0, W - 1)
        gidx = (w * rcap + key - b[w]).clamp(0, W * rcap - 1)
        rsel = pt.tree_map(lambda l: take_rows(l, gidx).reshape(
            (W, lcap) + tuple(l.shape[1:])), _flat(right.tree))
        out = call_batched(self.join_fn, [left.tree, rsel], W, lcap,
                           mex.device)
        keep = left.valid_mask() & ((key >= 0) & (key < n)).reshape(W, lcap)
        counts = mex.fetch(keep.sum(dim=1)).astype(np.int64)
        if np.array_equal(counts, left.counts):
            # every item joined: the rows are in place already
            return DeviceShards(mex, out, counts)
        tree, _ = compact_valid(out, keep)
        return DeviceShards(mex, tree, counts)


def _hash_dest(key_fn: Callable, W: int) -> Callable:
    def dest(tree, mask, widx):
        return hashing.umod(hashing.hash_key_words(
            keymod.worker_key_words(key_fn, tree)), W)
    return dest


def _location_filter(left: DeviceShards, right: DeviceShards, lkey, rkey
                     ) -> Tuple[DeviceShards, DeviceShards]:
    """Device LocationDetection (reference: LocationDetectionTag): each
    side's key hashes, ``umod M``, fill its presence registers (kernel
    ``presence_fill``), ORed over the workers (the reference's pmax); a
    row stays when its register is set on the other side. False
    positives cost exchange traffic, never a pair."""
    mex = left.mesh_exec
    M = preshuffle.register_width((left.cap + right.cap)
                                  * mex.num_workers)
    lvalid, rvalid = left.valid_mask(), right.valid_mask()
    # int64 register ids as umod makes them: the kernel reads them as is
    hl = hashing.umod(hashing.hash_key_words(
        keymod.worker_key_words(lkey, left.tree)), M)
    hr = hashing.umod(hashing.hash_key_words(
        keymod.worker_key_words(rkey, right.tree)), M)
    pres_l = presence_fill(hl, lvalid, M).amax(dim=0)
    pres_r = presence_fill(hr, rvalid, M).amax(dim=0)
    ltree, lcount = compact_valid(left.tree, lvalid & (pres_r[hl] > 0))
    rtree, rcount = compact_valid(right.tree, rvalid & (pres_l[hr] > 0))
    counts = mex.fetch(torch.stack([lcount, rcount])).astype(np.int64)
    return (DeviceShards(mex, ltree, counts[0]),
            DeviceShards(mex, rtree, counts[1]))


def _run_bounds(lw: List[torch.Tensor], lvalid: torch.Tensor,
                rw: List[torch.Tensor], rvalid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each right item of each worker: the ``[lo, hi)`` bounds of
    its run of equal keys among the sorted valid left items.

    Both sides' key words are sorted together with a side word. With the
    right items after equal left keys, the valid lefts before a right
    item are those with a key <= its own (``hi``); with the side word
    flipped, those with a smaller key (``lo``). Validity is a prepended
    sort word, never a sentinel key, so a key whose words are all ones
    still matches."""
    W, lcap = lvalid.shape
    rcap = rvalid.shape[1]
    dev = lvalid.device
    valid_all = torch.cat([lvalid, rvalid], dim=1)
    invalid_word = (~valid_all).to(torch.int64)
    words = [torch.cat([a, b], dim=1) for a, b in zip(lw, rw)]
    ridx = torch.cat([torch.full((W, lcap), rcap, dtype=torch.int64,
                                 device=dev),
                      torch.arange(rcap, device=dev).expand(W, rcap)], dim=1)
    bits = ([segmented.VALID_BITS] + [64] * len(words)
            + [segmented.VALID_BITS])

    def counts_below(right_after: bool) -> torch.Tensor:
        lside, rside = (0, 1) if right_after else (1, 0)
        side = torch.cat([torch.full((W, lcap), lside, dtype=torch.int64,
                                     device=dev),
                          torch.full((W, rcap), rside, dtype=torch.int64,
                                     device=dev)], dim=1)
        perm = argsort_words([invalid_word] + words + [side], bits)
        is_right = torch.gather(side, 1, perm) == rside
        lefts_before = row_cumsum(~is_right & torch.gather(valid_all, 1,
                                                           perm))
        # back to right-item order; every left row has a dump slot of its
        # own, so no slot is written twice
        slots = scatter_slots(torch.gather(ridx, 1, perm), is_right, rcap)
        out = torch.zeros(W * (rcap + lcap + rcap), dtype=torch.int64,
                          device=dev)
        out.index_put_((slots,), lefts_before.reshape(-1))
        return out.reshape(W, rcap + lcap + rcap)[:, :rcap]

    return counts_below(right_after=False), counts_below(right_after=True)


def _sort_merge(left: DeviceShards, right: DeviceShards, lkey, rkey,
                join_fn) -> DeviceShards:
    """Phase 1 (sort both sides, count pairs per right item), the host
    sync of the per-worker totals, phase 2 (expand the pairs)."""
    mex = left.mesh_exec
    W, lcap, rcap, dev = mex.num_workers, left.cap, right.cap, mex.device
    lw = keymod.worker_key_words(lkey, left.tree)
    rw = keymod.worker_key_words(rkey, right.tree)
    if len(lw) != len(rw):
        raise ValueError(f"InnerJoin: the left key has {len(lw)} key words, "
                         f"the right key {len(rw)}")
    lw, ltree, lvalid = segmented.sort_by_key_words(lw, left.tree,
                                                    left.valid_mask())
    rw, rtree, rvalid = segmented.sort_by_key_words(rw, right.tree,
                                                    right.valid_mask())
    lo, hi = _run_bounds(lw, lvalid, rw, rvalid)
    matches = torch.where(rvalid, hi - lo, torch.zeros_like(lo))
    totals = mex.fetch(matches.sum(dim=1)).astype(np.int64)
    out_cap = round_up_pow2(max(int(totals.max()), 1))
    ends = row_cumsum(matches)                                  # [W, rcap]
    p = torch.arange(out_cap, device=dev).expand(W, out_cap).contiguous()
    ridx = torch.searchsorted(ends, p, right=True).clamp(0, rcap - 1)
    starts = ends - matches
    lidx = (torch.gather(lo, 1, ridx) + p
            - torch.gather(starts, 1, ridx)).clamp(0, lcap - 1)
    lsel = pt.tree_map(lambda l: take_rows(l, lidx), ltree)
    rsel = pt.tree_map(lambda l: take_rows(l, ridx), rtree)
    return DeviceShards(mex, call_batched(join_fn, [lsel, rsel], W, out_cap,
                                          dev), totals)


def InnerJoin(left: DIA, right: DIA, left_key_fn, right_key_fn, join_fn,
              location_detection=None, out_size_hint=None,
              dense_right_index=None) -> DIA:
    return DIA(InnerJoinNode(left.context, left._link(), right._link(),
                             left_key_fn, right_key_fn, join_fn,
                             location_detection=location_detection,
                             out_size_hint=out_size_hint,
                             dense_right_index=dense_right_index))
