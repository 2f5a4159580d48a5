"""ReduceByKey / ReducePair / ReduceToIndex, device paths (counterpart
of the reference package's ``api/ops/reduce.py``).

ReduceByKey is two sort + segmented-reduce phases (``core/segmented.py``)
around a hash-partitioned exchange: the pre phase combines each worker's
equal keys, cutting the shuffle as the reference's pre-phase table does;
the post phase combines what arrived. With DuplicateDetection the
destination program fills presence registers (kernel ``presence_fill``)
and keeps rows whose key hash no other worker holds.

ReduceToIndex range-partitions items by a dense index and folds each
worker's range: declarative FieldReduce specs as pure scatters (the f32
"sum" through kernel ``segment_sum``), other reduce functions through
the sorted engine.

On host storage both run in Python, as the reference's do: ReduceByKey
combines each worker's items in a dict, hashes each entry once with
``stable_host_hash``, keeps globally unique keys on their worker when
duplicate detection is on, exchanges the rest by hash and folds what
arrives in ``core/em_table.py``'s external-memory table, which spills to
the spill store past the node's RAM grant. ReduceToIndex folds into one
dict a worker.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from ...common import hashing
from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...core import keys as keymod
from ...core import preshuffle
from ...core import duplicate_detection, segmented
from ...core.em_table import EMReduceTable
from ...core.ordered_fold import group_rows, ordered_segment_sum
from ...core.pallas_kernels import presence_fill, segment_sum
from ...core.rowmove import scatter_slots, take_rows
from ...data import exchange, multiplexer
from ...data.block_pool import spill_pool
from ...data.shards import (DeviceShards, HostShards, compact_valid,
                            round_up_pow2)
from ..dia import DIA
from ..dia_base import DIABase
from ..functors import FieldReduce


def _device_fold_specs(reduce_fn, treedef, leaves):
    """Flat FieldReduce specs when the segment-op engine applies, else
    None (the generic scan)."""
    if not isinstance(reduce_fn, FieldReduce):
        return None
    specs = reduce_fn.flat_spec(treedef)
    if specs is None or not segmented.fields_specializable(
            specs, [l.dtype for l in leaves]):
        return None
    return specs


def _local_reduce(shards: DeviceShards, key_fn: Callable,
                  reduce_fn: Callable) -> DeviceShards:
    """Encode keys, sort, segmented-reduce and compact every worker's
    rows. The capacity stays the input's."""
    mex = shards.mesh_exec
    leaves, td = pt.flatten(shards.tree)
    specs = _device_fold_specs(reduce_fn, td, leaves)
    words = keymod.worker_key_words(key_fn, shards.tree)
    words, tree, valid = segmented.sort_by_key_words(
        words, shards.tree, shards.valid_mask())
    _, tree, rep = segmented.reduce_runs(words, tree, valid, reduce_fn,
                                         specs)
    tree, counts = compact_valid(tree, rep)
    return DeviceShards(mex, tree, mex.fetch(counts))


class ReduceNode(DIABase):
    # the host post phase sizes its table from the grant (Thrill:
    # DIAMemUse::Max of ReduceByKey's tables)
    MEM_USE = "max"

    def __init__(self, ctx, link, key_fn: Callable, reduce_fn: Callable,
                 label: str = "ReduceByKey", dup_detection=None,
                 token=None) -> None:
        super().__init__(ctx, label, [link])
        self.key_fn = key_fn
        self.reduce_fn = reduce_fn
        # site of the sticky dup-detection verdict
        self.token = token if token is not None else (key_fn, reduce_fn)
        # reference: DuplicateDetectionTag; None = the cost model decides
        self.dup_detection = dup_detection

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards):
            return self._compute_host(shards)
        pre = _local_reduce(shards, self.key_fn, self.reduce_fn)
        if self.context.num_workers == 1:
            # the pre phase combined every key: nothing left to merge
            return pre
        return self._post_exchange(pre)

    def _post_exchange(self, pre: DeviceShards) -> DeviceShards:
        """Shuffle the pre-reduced rows by key hash and combine again."""
        key_fn = self.key_fn
        mex = self.context.mesh_exec
        W = mex.num_workers
        dup = self.dup_detection
        if dup is None:
            dup = preshuffle.auto_dup_detect(
                mex, pre.cap * W,
                exchange.leaf_item_bytes(pt.leaves(pre.tree)),
                ("reduce_dup", self.token))
        M = preshuffle.register_width(pre.cap * W) if dup else 0

        def dest(tree, mask, widx):
            h = hashing.hash_key_words(keymod.worker_key_words(key_fn, tree))
            hash_dest = hashing.umod(h, W)
            if not dup:
                return hash_dest
            reg = hashing.umod(h, M)
            if W < 256:
                # presence is 0/1 per worker, so the u8 holder count of
                # fewer than 256 workers cannot wrap
                local = presence_fill(reg, mask, M)
            else:
                local = torch.zeros((W, M), dtype=torch.int32,
                                    device=reg.device).scatter_reduce_(
                    1, reg, mask.to(torch.int32), "amax")
            holders = local.sum(dim=0)                   # the psum over W
            mine_only = (holders[reg] == 1) & (torch.gather(local, 1, reg)
                                               == 1)
            return torch.where(mine_only, widx, hash_dest)

        return _local_reduce(exchange.exchange(pre, dest), key_fn,
                             self.reduce_fn)

    def _compute_host(self, shards: HostShards) -> HostShards:
        """The reference's host path, item for item
        (``thrill_tpu/api/ops/reduce.py:554-669``)."""
        W = shards.num_workers
        mex = self.context.mesh_exec
        key_fn, reduce_fn = self.key_fn, self.reduce_fn
        owns_input = self.parents[0].node.state == "DISPOSED"
        t0 = time.perf_counter()
        # pre phase: each worker combines its equal keys (Thrill's
        # ReducePrePhase), bounded by its input, which is in RAM already
        pre_entries = []
        for lst in shards.lists:
            table: dict = {}
            for it in lst:
                k = key_fn(it)
                table[k] = reduce_fn(table[k], it) if k in table else it
            pre_entries.append(list(table.items()))
            if owns_input:
                lst.clear()
        # one hash an entry, carried through detection and the exchange
        pre_hashes = [[hashing.stable_host_hash(k) for k, _ in entries]
                      for entries in pre_entries]
        dup = self.dup_detection
        if dup is None:
            dup = preshuffle.auto_dup_detect(
                mex, sum(len(h) for h in pre_hashes), 32,
                ("reduce_dup_host", self.token), local_rows=True)
        non_unique = (duplicate_detection.find_non_unique_hashes(pre_hashes)
                      if dup and W > 1 else None)
        # items travel as (worker kept or None, hash, key, value): the
        # pre phase's key stays the key, whatever reduce_fn returns
        pre_lists = []
        for w, entries in enumerate(pre_entries):
            lst = []
            for (k, v), h in zip(entries, pre_hashes[w]):
                keep = w if (non_unique is not None and
                             duplicate_detection.is_unique(h, non_unique)
                             ) else None
                lst.append((keep, h, k, v))
            entries.clear()
            pre_lists.append(lst)
        del pre_entries, pre_hashes
        t1 = time.perf_counter()
        ex = multiplexer.host_exchange(
            mex, HostShards(W, pre_lists),
            lambda kv: kv[1] % W if kv[0] is None else kv[0],
            reason="reduce")
        t2 = time.perf_counter()
        # post phase: external-memory tables sized by the grant; a spilled
        # partition re-reduces recursively (Thrill:
        # core/reduce_by_hash_post_phase.hpp:44-120)
        pool = spill_pool(self.context.config.spill_dir, self.mem_limit)
        stats: dict = {}
        post_lists = []
        try:
            for items in ex.lists:
                t = EMReduceTable(reduce_fn, pool, self.mem_limit,
                                  stats=stats or None)
                stats = t.stats
                for _, h, k, v in items:
                    t.insert(k, v, h)
                items.clear()
                post_lists.append(list(t.emit()))
                t.close()
        finally:
            pool.close()
            disk_bytes = pool.bytes_spilled
        # the tables' spills, recursion and peak entries, the bytes the
        # spill store wrote to disk, and the phases' host seconds
        self._em_stats = dict(stats, disk_bytes=disk_bytes)
        self._host_seconds = {"pre": t1 - t0, "exchange": t2 - t1,
                              "post": time.perf_counter() - t2}
        return HostShards(W, post_lists)


def ReduceByKey(dia: DIA, key_fn: Callable, reduce_fn: Callable,
                dup_detection=None) -> DIA:
    return DIA(ReduceNode(dia.context, dia._link(), key_fn, reduce_fn,
                          dup_detection=dup_detection))


def ReducePair(dia: DIA, value_reduce_fn) -> DIA:
    """Items are (key, value) pairs; combine values of equal keys.
    ``value_reduce_fn`` is a callable or an op string ("sum", "min",
    "max"), which takes the FieldReduce engine."""
    def key_fn(kv):
        return kv[0]

    if isinstance(value_reduce_fn, str):
        red = FieldReduce(("first", value_reduce_fn))
        return DIA(ReduceNode(dia.context, dia._link(), key_fn, red,
                              label="ReducePair", token=("ReducePair", red)))

    def reduce_fn(a, b):
        return (a[0], value_reduce_fn(a[1], b[1]))

    return DIA(ReduceNode(dia.context, dia._link(), key_fn, reduce_fn,
                          label="ReducePair",
                          token=("ReducePair", value_reduce_fn)))


# -- ReduceToIndex -----------------------------------------------------------

def _type_max(dt: torch.dtype):
    return float("inf") if dt.is_floating_point else torch.iinfo(dt).max


def _type_min(dt: torch.dtype):
    return float("-inf") if dt.is_floating_point else torch.iinfo(dt).min


def _scatter_fold_specs(reduce_fn, treedef, leaves):
    """Flat FieldReduce specs when the sort-free scatter engine applies to
    every leaf: "sum"/"min"/"max" need non-bool leaves, "first" takes any
    dtype. None sends the node to the sorted engine."""
    if not isinstance(reduce_fn, FieldReduce):
        return None
    specs = reduce_fn.flat_spec(treedef)
    if specs is None:
        return None
    for s, l in zip(specs, leaves):
        if s != "first" and l.dtype == torch.bool:
            return None
    return specs


def _scatter_reduce_apply(tree: Any, pos: torch.Tensor, size: int, specs,
                          neutral) -> Any:
    """The dense ReduceToIndex phase as pure scatters, no sort.

    ``tree`` leaves ``[T, ...]`` hold the items of every worker,
    worker-major and in row order; ``pos`` ``[T]`` is each item's row of
    the ``[size]`` dense output (every worker's range side by side), or
    ``size`` for an item outside its worker's range, which is dropped
    into a slot of its own. "first" takes the item of least arrival (an
    ``amin`` scatter of positions), "sum" adds (f32 scalar leaves through
    the segment-sum kernel, other float leaves in operand order through
    the ordered fold, integers by ``index_add_``), "min"/"max"
    scatter-reduce. Untouched rows
    hold ``neutral`` (zero when None). Returns ``[size, ...]`` leaves.
    """
    leaves, td = pt.flatten(tree)
    T = pos.shape[0]
    dev = pos.device
    keep = pos < size
    flat = scatter_slots(pos[None], keep[None], size)       # [T]
    win = grouped = None

    def runs():
        nonlocal grouped
        if grouped is None:
            grouped = group_rows(pos, size)
        return grouped

    def winners():
        nonlocal win
        if win is None:
            win = torch.full((size + T,), T, dtype=torch.int64,
                             device=dev).scatter_reduce_(
                0, flat, torch.arange(T, device=dev), "amin")[:size]
        return win

    nleaves = (pt.leaves(neutral) if neutral is not None
               else [None] * len(leaves))
    outs = []
    for s, leaf, nv in zip(specs, leaves, nleaves):
        trail = tuple(leaf.shape[1:])
        if s == "first":
            w = winners()
            col = (take_rows(leaf, w.clamp(max=T - 1)) if T else
                   torch.zeros((size,) + trail, dtype=leaf.dtype, device=dev))
            present = w < T
        elif s == "sum":
            if leaf.dtype == torch.float32 and not trail:
                col = segment_sum(pos.to(torch.int32)[None],
                                  leaf.contiguous()[None], size)[0]
            elif leaf.dtype.is_floating_point:
                # in operand order, as the reference's scatter adds
                col = ordered_segment_sum(leaf, *runs())
            else:
                col = torch.zeros((size + T,) + trail, dtype=leaf.dtype,
                                  device=dev).index_add_(0, flat,
                                                         leaf)[:size]
            if nv is None or not np.any(np.asarray(nv)):
                # a zero neutral is the sum's base: no presence needed
                outs.append(col)
                continue
            present = winners() < T
        else:
            big = _type_max(leaf.dtype) if s == "min" else _type_min(
                leaf.dtype)
            idx = flat.reshape((T,) + (1,) * len(trail)).expand(leaf.shape)
            col = torch.full((size + T,) + trail, big, dtype=leaf.dtype,
                             device=dev).scatter_reduce_(
                0, idx, leaf, "amin" if s == "min" else "amax")[:size]
            present = winners() < T
        fill = torch.as_tensor(np.asarray(0 if nv is None else nv),
                               device=dev).to(leaf.dtype)
        outs.append(torch.where(present.reshape(present.shape
                                                + (1,) * len(trail)),
                                col, fill))
    return pt.unflatten(td, outs)


def _index_of(index_fn, tree) -> torch.Tensor:
    """``index_fn`` over every row of ``[W, cap, ...]`` leaves, as int64
    ``[W, cap]``."""
    W, cap = pt.leaves(tree)[0].shape[:2]
    flat = pt.tree_map(lambda l: l.reshape((W * cap,) + tuple(l.shape[2:])),
                       tree)
    return torch.as_tensor(index_fn(flat)).to(torch.int64).reshape(W, cap)


class ReduceToIndexNode(DIABase):
    """Key = dense index in [0, size); the output is the dense array with
    ``neutral`` at unused indices (reference: api/reduce_to_index.hpp)."""

    def __init__(self, ctx, link, index_fn, reduce_fn, size,
                 neutral) -> None:
        super().__init__(ctx, "ReduceToIndex", [link])
        self.index_fn = index_fn
        self.reduce_fn = reduce_fn
        self.size = int(size)
        self.neutral = neutral

    def _bounds(self) -> np.ndarray:
        return dense_range_bounds(self.size, self.context.num_workers)

    def _exchange_by_index(self, shards: DeviceShards,
                           bounds: np.ndarray) -> DeviceShards:
        upper = shards.mesh_exec.put_small(bounds[1:])

        def dest(tree, mask, widx):
            idx = _index_of(self.index_fn, tree)
            return torch.searchsorted(upper, idx, right=True)

        return exchange.exchange(shards, dest)

    def compute(self):
        shards = self.parents[0].pull()
        bounds = self._bounds()
        if isinstance(shards, HostShards):
            return self._compute_host(shards, bounds)
        mex = shards.mesh_exec
        W = mex.num_workers
        if W > 1:
            shards = self._exchange_by_index(shards, bounds)
        leaves, td = pt.flatten(shards.tree)
        local_sizes = (bounds[1:] - bounds[:-1]).astype(np.int64)
        # a power-of-two capacity, as every other producer of shards
        out_cap = max(1, round_up_pow2(int(local_sizes.max())))
        sc = _scatter_fold_specs(self.reduce_fn, td, leaves)
        if sc is None:
            out = self._sorted_reduce(shards, bounds, out_cap)
            return DeviceShards(mex, out, local_sizes)
        # the scatter engine takes the valid rows only, worker-major, so
        # no padding row of the [W, cap] shards is scattered
        cap = shards.cap
        cum = mex.put_small(np.concatenate([[0], np.cumsum(shards.counts)]))
        t = torch.arange(shards.total, device=mex.device)
        w_of = torch.searchsorted(cum[1:], t, right=True)
        sel = t + w_of * cap - cum[w_of]
        tree = pt.tree_map(lambda l: take_rows(
            l.reshape((W * cap,) + tuple(l.shape[2:])), sel), shards.tree)
        local = (torch.as_tensor(self.index_fn(tree), device=mex.device)
                 .to(torch.int64) - mex.put_small(bounds)[w_of])
        ok = (local >= 0) & (local < mex.put_small(local_sizes)[w_of])
        pos = torch.where(ok, w_of * out_cap + local,
                          torch.full_like(local, W * out_cap))
        out = _scatter_reduce_apply(tree, pos, W * out_cap, sc, self.neutral)
        return DeviceShards(mex, pt.tree_map(
            lambda l: l.reshape((W, out_cap) + tuple(l.shape[1:])), out),
            local_sizes)

    def _compute_host(self, shards: HostShards,
                      bounds: np.ndarray) -> HostShards:
        """One dict a worker range; ``neutral`` at indices no item
        reached (reference: ``thrill_tpu/api/ops/reduce.py:1166-1181``)."""
        W = shards.num_workers
        index_fn, reduce_fn = self.index_fn, self.reduce_fn
        tables = [dict() for _ in range(W)]
        for items in shards.lists:
            for it in items:
                i = int(index_fn(it))
                t = tables[int(np.searchsorted(bounds[1:], i, side="right"))]
                t[i] = reduce_fn(t[i], it) if i in t else it
        return HostShards(W, [
            [tables[w].get(i, self.neutral)
             for i in range(int(bounds[w]), int(bounds[w + 1]))]
            for w in range(W)])

    def _sorted_reduce(self, shards: DeviceShards, bounds: np.ndarray,
                       out_cap: int) -> Any:
        """Sort by index, fold each run, scatter the representatives into
        the dense ``[W, out_cap]`` rows."""
        leaves, td = pt.flatten(shards.tree)
        mex = shards.mesh_exec
        W, n = shards.num_workers, shards.cap
        dev = mex.device
        specs = _device_fold_specs(self.reduce_fn, td, leaves)
        words, tree, valid = segmented.sort_by_key_words(
            [_index_of(self.index_fn, shards.tree)], shards.tree,
            shards.valid_mask())
        words, tree, rep = segmented.reduce_runs(words, tree, valid,
                                                 self.reduce_fn, specs)
        local_idx = words[0] - mex.put_small(bounds[:W])[:, None]
        # a representative below its range clips to row 0, one past it
        # is dropped, as the reference's clip into [0, out_cap]
        flat = scatter_slots(local_idx.clamp(min=0),
                             rep & (local_idx < out_cap), out_cap)
        region = out_cap + n
        nleaves = (pt.leaves(self.neutral) if self.neutral is not None
                   else [0] * len(leaves))

        def scatter(leaf, nv):
            trail = tuple(leaf.shape[2:])
            base = torch.empty((W * region,) + trail, dtype=leaf.dtype,
                               device=dev)
            base[:] = torch.as_tensor(np.asarray(nv), device=dev).to(
                leaf.dtype)
            # representatives have distinct indices
            base.index_put_((flat,), leaf.reshape((-1,) + trail))
            return base.reshape((W, region) + trail)[:, :out_cap]

        return pt.unflatten(td, [scatter(l, nv) for l, nv in
                                 zip(pt.leaves(tree), nleaves)])


def ReduceToIndex(dia: DIA, index_fn, reduce_fn, size,
                  neutral=None) -> DIA:
    return DIA(ReduceToIndexNode(dia.context, dia._link(), index_fn,
                                 reduce_fn, size, neutral))
