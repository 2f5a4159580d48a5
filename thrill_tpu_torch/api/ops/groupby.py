"""GroupByKey and GroupToIndex (counterpart of the reference package's
``api/ops/groupby.py``; Thrill's ``api/group_by_key.hpp`` and
``api/group_to_index.hpp``).

GroupByKey on device storage: a hash exchange by the key words
(``umod(hash_key_words(words), W)``), a stable key sort per worker (B2),
run starts, then either

* ``device_fn``: the user's fold over segment ids on the card, or
* ``group_fn``: the sorted rows come to the host and Python runs once
  per group.

GroupByKey on host storage (``group_fn`` only): each item's key is
hashed once with ``stable_host_hash``, the items are exchanged by hash,
and each worker groups what arrives, in arrival order, in
``core/em_table.py``'s ``EMGroupBuffer``, which spills sorted runs to
the spill store past the node's RAM grant.

GroupToIndex on device storage: a range exchange to the workers owning
``dense_range_bounds(size, W)``, then ``device_fn`` folds each index's
items by their local index, and ``neutral`` fills indices that received
none. Its host path groups in dicts.

The port's ``device_fn`` contract is batched over the W workers, as the
Map stack is: ``device_fn(tree, segment_ids, num_segments)`` sees the
leaves of every worker's rows as one ``[W * cap, ...]`` item axis;
worker ``w``'s segment ``j`` has id ``w * per + j`` and
``num_segments = W * per`` (``per`` is the output capacity of a worker);
rows with an id ``>= num_segments`` must be dropped, as
``jax.ops.segment_*`` and ``core/segmented.py``'s ``segment_sum``,
``segment_max``, ``segment_min`` and ``segment_count`` do. The result's
leaves lead with ``num_segments`` rows, worker ``w``'s at ``[w * per,
(w + 1) * per)``. Across processes ``device_fn`` sees the local workers'
rows, ``w`` counting them from 0, and the host paths hold their own
workers' groups.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ...common import hashing
from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...core import keys as keymod
from ...core import segmented
from ...core.em_table import EMGroupBuffer
from ...core.rowmove import row_cumsum
from ...data import exchange, multiplexer
from ...data.block_pool import spill_pool
from ...data.shards import DeviceShards, HostShards
from ..dia import DIA
from ..dia_base import DIABase
from .reduce import _index_of


def _flat(tree: Any, W: int, cap: int) -> Any:
    return pt.tree_map(lambda l: l.reshape((W * cap,) + tuple(l.shape[2:])),
                       tree)


def _per_worker(tree: Any, W: int, per: int) -> Any:
    return pt.tree_map(lambda l: torch.as_tensor(l).reshape(
        (W, per) + tuple(l.shape[1:])), tree)


class GroupByKeyNode(DIABase):
    # the host path sizes its group buffer from the grant (Thrill:
    # DIAMemUse::Max of GroupByKey's sort-and-spill buffer)
    MEM_USE = "max"

    def __init__(self, ctx, link, key_fn: Callable,
                 group_fn: Optional[Callable],
                 device_fn: Optional[Callable] = None) -> None:
        super().__init__(ctx, "GroupByKey", [link])
        self.key_fn = key_fn
        self.group_fn = group_fn
        self.device_fn = device_fn

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards):
            if self.group_fn is None:
                raise ValueError(
                    "GroupByKey over host storage requires group_fn "
                    "(device_fn needs columnar device shards)")
            return self._group_host(shards)
        if self.group_fn is None and self.device_fn is None:
            raise ValueError("GroupByKey needs group_fn (host fold) or "
                             "device_fn (vectorized segment fold)")
        shards = self._exchange_by_key_hash(shards)
        if self.device_fn is not None:
            return self._group_device(shards)
        return self._group_sorted_host(shards)

    def _group_host(self, shards: HostShards) -> HostShards:
        """The reference's host path, item for item
        (``thrill_tpu/api/ops/groupby.py:64-123``)."""
        W = shards.num_workers
        key_fn = self.key_fn
        owns_input = self.parents[0].node.state in ("DISPOSED", "FUSED")
        t0 = time.perf_counter()
        # (hash, key, item), the hash and the hashable key made once
        pre_lists = []
        for lst in shards.lists:
            pre = []
            for it in lst:
                k = hashing.hashable(key_fn(it))
                pre.append((hashing.stable_host_hash(k), k, it))
            pre_lists.append(pre)
            if owns_input:
                lst.clear()
        t1 = time.perf_counter()
        ex = multiplexer.host_exchange(self.context.mesh_exec,
                                       HostShards(W, pre_lists),
                                       lambda t: t[0], reason="groupby")
        del pre_lists
        t2 = time.perf_counter()
        pool = spill_pool(self.context.config.spill_dir, self.mem_limit)
        stats: dict = {}
        out = []
        try:
            for items in ex.lists:
                buf = EMGroupBuffer(pool, self.mem_limit,
                                    stats=stats or None)
                stats = buf.stats
                for h, k, it in items:
                    buf.add(k, it, h=h)
                items.clear()
                out.append([self.group_fn(k, vs) for k, vs in buf.groups()])
                buf.close()
        finally:
            pool.close()
            disk_bytes = pool.bytes_spilled
        self._em_stats = dict(stats, disk_bytes=disk_bytes)
        self._host_seconds = {"hash": t1 - t0, "exchange": t2 - t1,
                              "group": time.perf_counter() - t2}
        return HostShards(W, out)

    def _exchange_by_key_hash(self, shards: DeviceShards) -> DeviceShards:
        W = shards.num_workers
        if W == 1:
            return shards
        key_fn = self.key_fn

        def dest(tree, mask, widx):
            h = hashing.hash_key_words(keymod.worker_key_words(key_fn, tree))
            return hashing.umod(h, W)

        return exchange.exchange(shards, dest, ("groupby_dest", key_fn, W))

    def _sorted_runs(self, shards: DeviceShards):
        """Every worker's rows sorted by key words (invalid last) and the
        run starts: (sorted tree, sorted valid, starts), all ``[W, cap,
        ...]``."""
        words = keymod.worker_key_words(self.key_fn, shards.tree)
        words_s, tree_s, valid_s = segmented.sort_by_key_words(
            words, shards.tree, shards.valid_mask())
        return tree_s, valid_s, segmented.segment_boundaries(words_s,
                                                             valid_s)

    def _group_device(self, shards: DeviceShards) -> DeviceShards:
        """Sort, segment ids, then ``device_fn`` (the batched contract of
        the module's docstring with ``per = cap``). Invalid rows carry
        ``num_segments``, dropped as GroupToIndex's are. The reference
        parks them in its worker's last slot ``cap - 1`` instead; batched,
        those W slots would take every padding row of the exchange's
        power-of-two capacity, the hottest addresses of the folds."""
        mex = shards.mesh_exec
        W, cap = mex.num_local, shards.cap
        tree_s, valid_s, starts = self._sorted_runs(shards)
        seg = row_cumsum(starts) - 1
        nseg = starts.sum(dim=1)
        seg = torch.where(
            valid_s, seg + torch.arange(W, device=mex.device)[:, None] * cap,
            torch.full_like(seg, W * cap)).reshape(-1)
        out = self.device_fn(_flat(tree_s, W, cap), seg, W * cap)
        return DeviceShards(mex, _per_worker(out, W, cap),
                            mex.fetch(nseg).astype(np.int64))

    def _group_sorted_host(self, shards: DeviceShards) -> HostShards:
        """Arbitrary ``group_fn``: the card sorts and marks run starts,
        the host calls ``group_fn(key, items)`` once per run."""
        mex = shards.mesh_exec
        tree_s, _, starts = self._sorted_runs(shards)
        starts = mex.fetch(starts)
        sorted_shards = DeviceShards(mex, tree_s, shards.counts.copy())
        lists = []
        for w, items in enumerate(
                sorted_shards.to_host_shards("groupbykey-group-fn").lists):
            n = len(items)
            if not n:
                lists.append([])
                continue
            # the run starts of the local workers only
            bounds = np.flatnonzero(
                starts[w - mex.worker_base, :n]).tolist() + [n]
            lists.append([
                self.group_fn(hashing.hashable(self.key_fn(items[lo])),
                              items[lo:hi])
                for lo, hi in zip(bounds[:-1], bounds[1:])])
        return HostShards(shards.num_workers, lists)


class GroupToIndexNode(DIABase):
    def __init__(self, ctx, link, index_fn: Callable,
                 group_fn: Optional[Callable], size: int, neutral: Any,
                 device_fn: Optional[Callable] = None) -> None:
        super().__init__(ctx, "GroupToIndex", [link])
        self.index_fn = index_fn
        self.group_fn = group_fn
        self.size = int(size)
        if self.size <= 0:
            raise ValueError("GroupToIndex requires a positive size")
        self.neutral = neutral
        self.device_fn = device_fn

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, DeviceShards) and self.device_fn is not None:
            return self._compute_device(shards)
        if self.group_fn is None:
            raise ValueError(
                "GroupToIndex over host storage requires group_fn "
                "(device_fn needs columnar device shards)")
        if isinstance(shards, DeviceShards):
            shards = shards.to_host_shards("grouptoindex")
        return self._compute_host(shards)

    def _compute_host(self, shards: HostShards) -> HostShards:
        """Items grouped by index in dicts, in global order (the
        reference's rank-ordered host exchange keeps it); indices outside
        ``[0, size)`` are dropped, and an index without items gives
        ``neutral``."""
        W, n = shards.num_workers, self.size
        mex = self.context.mesh_exec
        groups: dict = {}
        for items in multiplexer.ensure_replicated(mex, shards,
                                                   "grouptoindex").lists:
            for it in items:
                i = int(self.index_fn(it))
                if 0 <= i < n:
                    groups.setdefault(i, []).append(it)
        bounds = dense_range_bounds(n, W).tolist()
        local = multiplexer.local_worker_set(mex)
        return HostShards(W, [
            [self.group_fn(i, groups[i]) if i in groups else self.neutral
             for i in range(bounds[w], bounds[w + 1])] if w in local else []
            for w in range(W)])

    def _compute_device(self, shards: DeviceShards) -> DeviceShards:
        """Range exchange, then ``device_fn`` (the batched contract of
        the module's docstring with ``per`` the largest range): worker
        ``w``'s index ``i`` has id ``w * per + i - bounds[w]``, and
        invalid or out-of-range rows carry ``num_segments``. No sort:
        the segment folds take unsorted ids."""
        mex = shards.mesh_exec
        W, n, dev = shards.num_workers, self.size, mex.device
        bounds = dense_range_bounds(n, W)
        Wl = mex.num_local

        def index_of(tree):
            return _index_of(self.index_fn, tree)

        if W > 1:
            upper = mex.put_small(bounds[1:])

            def dest(tree, mask, widx):
                return torch.searchsorted(upper, index_of(tree), right=True)

            shards = exchange.exchange(shards, dest,
                                       ("g2i_dest", self.index_fn, n, W))
            shards.validate_pending()       # optimistic-exchange heal point
        cap = shards.cap
        sizes = np.diff(bounds).astype(np.int64)
        per = max(1, int(sizes.max()))
        # the local workers' ranges and segments
        local = (index_of(shards.tree)
                 - mex.put_small(mex.local(bounds[:-1]))[:, None])
        keep = shards.valid_mask() & (local >= 0) & (local < per)
        ids = torch.where(
            keep, local + torch.arange(Wl, device=dev)[:, None] * per,
            torch.full_like(local, Wl * per)).reshape(-1)
        out = self.device_fn(_flat(shards.tree, Wl, cap), ids, Wl * per)
        if self.neutral is not None:
            out = _fill_neutral(out, self.neutral,
                                segmented.segment_count(ids, Wl * per) > 0)
        return DeviceShards(mex, _per_worker(out, Wl, per),
                            mex.local(sizes))


def _fill_neutral(out: Any, neutral: Any, filled: torch.Tensor) -> Any:
    """Rows of ``out`` whose segment received no item become ``neutral``
    (a pytree matching ``out``, or one scalar for every leaf)."""
    def fill(leaf, nval):
        leaf = torch.as_tensor(leaf, device=filled.device)
        m = filled.reshape(filled.shape + (1,) * (leaf.dim() - 1))
        return torch.where(m, leaf, torch.as_tensor(
            nval, dtype=leaf.dtype, device=leaf.device))

    if pt.flatten(out)[1] == pt.flatten(neutral)[1]:
        return pt.tree_map(fill, out, neutral)
    return pt.tree_map(lambda l: fill(l, neutral), out)


def GroupByKey(dia: DIA, key_fn, group_fn=None, device_fn=None) -> DIA:
    return DIA(GroupByKeyNode(dia.context, dia._link(), key_fn, group_fn,
                              device_fn=device_fn))


def GroupToIndex(dia: DIA, index_fn, group_fn=None, size: int = 0,
                 neutral=None, device_fn=None) -> DIA:
    return DIA(GroupToIndexNode(dia.context, dia._link(), index_fn,
                                group_fn, size, neutral,
                                device_fn=device_fn))
