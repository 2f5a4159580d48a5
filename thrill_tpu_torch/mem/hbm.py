"""The HBM governor: a ledger of the cached device results and their
spill to the host block store (counterpart of the reference package's
``mem/hbm.py``, without the tenant ledger; Thrill: the BlockPool's soft
and hard limits, data/block_pool.hpp:42, and ``memory_exceeded``,
mem/malloc_tracker.hpp:36-43).

The governor keeps an LRU of the nodes that hold device results and
their bytes in a ``MemoryManager`` with a limit. Past the limit the
coldest nodes' leaves go to the native block store, one block per
worker slice of each ``[W, cap, ...]`` leaf, and the store spills to
disk past its own soft limit: HBM -> host DRAM -> disk. A spilled node's
next pull uploads it again. On a ``cuda`` mesh both directions stage
through the governor's :class:`StagingRing` of pinned buffers on a side
stream: a spill copies block k+1 off the card while the store takes
block k, and a restore reads block k+1 from the store while block k
uploads; the result's stream waits on the side stream before anyone
reads it.

A spill is best effort: a failure keeps the node resident (over budget
beats data loss). A restore is mandatory: it retries transient faults
and then raises.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import faults
from ..common import tree as pt
from ..common.retry import default_policy
from ..data.block_pool import BlockPool, resident_override
from ..data.shards import DeviceShards
from ..data.writeback import make_readahead, overlapped_fetch
from ..vfs.file_io import prefetch_depth
from .manager import MemoryConfig, MemoryManager

_F_SPILL = faults.declare("mem.hbm.spill")
_F_RESTORE = faults.declare("mem.hbm.restore")


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's memory as flat uint8 (no copy)."""
    return t.reshape(-1).view(torch.uint8)


def device_bytes(shards) -> int:
    """Bytes of a DeviceShards' leaves; 0 for anything else (host items
    are not on the card)."""
    if not isinstance(shards, DeviceShards):
        return 0
    return sum(l.numel() * l.element_size() for l in pt.leaves(shards.tree))


def storages(shards) -> set:
    """The storage addresses a DeviceShards' leaves live in (views
    share them)."""
    if not isinstance(shards, DeviceShards):
        return set()
    return {l.untyped_storage().data_ptr() for l in pt.leaves(shards.tree)}


class StagingRing:
    """The pinned host buffers a governor's spills and restores stage
    through: :data:`SLOTS` of them, each as large as the largest block so
    far, allocated once (and again only for a larger block). A block
    leaves its slot when the store has taken it (a spill's ``put``
    returns) or when its upload has read it (the event recorded after the
    copy); :meth:`take` waits for that before it hands the slot out."""

    SLOTS = 2

    def __init__(self) -> None:
        self.bufs: List[torch.Tensor] = []
        self.events: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self.nbytes = 0
        self._next = 0

    def reserve(self, nbytes: int) -> None:
        """Slots of at least ``nbytes``: the largest block of a spill or
        restore, before its first block."""
        if nbytes > self.nbytes:
            for ev in self.events:
                if ev is not None:
                    ev.synchronize()
            self.bufs = [torch.empty(nbytes, dtype=torch.uint8,
                                     pin_memory=True)
                         for _ in range(self.SLOTS)]
            self.events = [None] * self.SLOTS
            self.nbytes = nbytes

    def take(self, nbytes: int) -> Tuple[int, torch.Tensor]:
        """(slot, its first ``nbytes`` as a pinned uint8 tensor), once the
        slot's last upload has read it."""
        self.reserve(nbytes)
        i = self._next
        self._next = (i + 1) % self.SLOTS
        ev, self.events[i] = self.events[i], None
        if ev is not None:
            ev.synchronize()
        return i, self.bufs[i][:nbytes]

    def busy_until(self, slot: int, event: torch.cuda.Event) -> None:
        """The slot is read by work before ``event`` (an upload)."""
        self.events[slot] = event


class SpilledShards:
    """A DeviceShards parked in the block store: one block per worker
    slice of each leaf, plus what rebuilds the leaves. Counts stay on
    the host."""

    def __init__(self, mesh_exec, treedef, counts: np.ndarray, pool,
                 leaf_blocks: List[List[Tuple[int, int]]],
                 leaf_meta: List[Tuple[torch.dtype, Tuple[int, ...]]],
                 ring: Optional[StagingRing] = None) -> None:
        self.mesh_exec = mesh_exec
        self.treedef = treedef
        self.counts = counts
        self.pool = pool
        self.leaf_blocks = leaf_blocks      # per leaf: [(worker, block)]
        self.leaf_meta = leaf_meta          # per leaf: (dtype, shape)
        self.ring = ring

    @staticmethod
    def park(shards, pool, label: str,
             ring: Optional[StagingRing] = None) -> "SpilledShards":
        """Copy every worker slice of every leaf into ``pool``, on the
        card through ``ring`` (a ring of its own when None); on a failure
        the blocks written so far are dropped and it raises."""
        mex = shards.mesh_exec
        dev = mex.device
        leaves, treedef = pt.flatten(shards.tree)
        leaf_blocks: List[List[Tuple[int, int]]] = [[] for _ in leaves]
        work = [(li, w) for li, l in enumerate(leaves)
                for w in range(l.shape[0])]
        cuda = dev.type == "cuda"
        side = None
        if cuda:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            ring = ring or StagingRing()
            ring.reserve(max((l[0].numel() * l.element_size()
                              for l in leaves if l.shape[0]), default=0))

        def issue(li: int, w: int):
            """Start block (li, w) on its way to the host."""
            src = leaves[li][w]
            if not cuda:
                return _byte_view(src.contiguous()).numpy(), None
            # its slot's previous block is in the store: the loop puts
            # block k before it issues block k + 2
            _, host = ring.take(src.numel() * src.element_size())
            with torch.cuda.stream(side):
                host.copy_(_byte_view(src.contiguous()), non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            return host, ev

        try:
            nxt = issue(*work[0]) if work else None
            for k, (li, w) in enumerate(work):
                host, ev = nxt
                # block k+1 leaves the card while the store takes block k
                nxt = issue(*work[k + 1]) if k + 1 < len(work) else None
                faults.check(_F_SPILL, node=label)
                if ev is not None:
                    ev.synchronize()
                    host = host.numpy()
                leaf_blocks[li].append((w, pool.put(host)))
        except BaseException:
            if side is not None:
                side.synchronize()
            for blocks in leaf_blocks:
                for _, bid in blocks:
                    try:
                        pool.drop(bid)
                    except Exception:
                        pass
            raise
        meta = [(l.dtype, tuple(l.shape)) for l in leaves]
        return SpilledShards(mex, treedef, shards.counts.copy(), pool,
                             leaf_blocks, meta, ring)

    def restore(self):
        """The DeviceShards again. On the card block k+1 is read from the
        store into the ring while block k uploads; on the CPU the blocks
        go straight into the leaves, a disk block read ahead while the
        one before is copied (``THRILL_TPU_PREFETCH=0`` reads in
        turn)."""
        mex = self.mesh_exec
        dev = mex.device
        leaves = [torch.empty(shape, dtype=dt, device=dev)
                  for dt, shape in self.leaf_meta]
        flat = [(li, w, bid) for li, blocks in enumerate(self.leaf_blocks)
                for w, bid in blocks]

        def check(bid):
            if faults.REGISTRY.active():
                default_policy().run(
                    lambda: faults.check(_F_RESTORE, block=bid),
                    what="hbm.restore")

        if dev.type == "cuda":
            ring = self.ring or StagingRing()
            ring.reserve(max((self.pool.size(bid) for _, _, bid in flat),
                             default=0))
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            try:
                for li, w, bid in flat:
                    check(bid)
                    slot, buf = ring.take(self.pool.size(bid))
                    self.pool.get_into(bid, buf.numpy())
                    with torch.cuda.stream(side):
                        _byte_view(leaves[li][w]).copy_(buf,
                                                        non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(side)
                    ring.busy_until(slot, ev)
            except BaseException:
                side.synchronize()      # before the leaves are freed
                raise
            torch.cuda.current_stream(dev).wait_stream(side)
            return DeviceShards(mex, pt.unflatten(self.treedef, leaves),
                                self.counts.copy())

        def fetch(item):
            li, w, bid = item
            check(bid)
            self.pool.get_into(bid, _byte_view(leaves[li][w]).numpy())

        ra = make_readahead(prefetch_depth()) if len(flat) > 1 else None
        try:
            for _ in overlapped_fetch(flat, fetch, "hbm.restore", ra,
                                      skip_fn=lambda it: self.pool.resident(
                                          it[2])):
                pass
        finally:
            if ra is not None:
                ra.shutdown(wait=True, cancel_futures=True)
        return DeviceShards(mex, pt.unflatten(self.treedef, leaves),
                            self.counts.copy())

    def free(self) -> None:
        for blocks in self.leaf_blocks:
            for _, bid in blocks:
                self.pool.drop(bid)
        self.leaf_blocks = []


class HbmGovernor:
    """LRU of the nodes with cached device results, and their spill."""

    def __init__(self, context, limit: int = 0) -> None:
        self.context = context
        self.mem = MemoryManager(name="hbm", limit=limit)
        self._lru: Dict[int, Any] = {}   # node id -> node, coldest first
        self._pool = None
        self._ring = StagingRing()
        self.spill_count = 0
        self.restore_count = 0

    def _spill_pool(self):
        """The store, made at the first spill: the block pool's soft
        share of the host RAM stays resident, the rest goes to disk."""
        if self._pool is None:
            cfg = self.context.config
            host_ram = cfg.host_ram
            if not host_ram:
                try:
                    host_ram = (os.sysconf("SC_PAGE_SIZE")
                                * os.sysconf("SC_PHYS_PAGES"))
                except (ValueError, OSError):
                    host_ram = 8 << 30
            soft = resident_override()
            if soft is None:
                soft = MemoryConfig.split(host_ram).ram_block_pool_soft
            self._pool = BlockPool(spill_dir=cfg.spill_dir, soft_limit=soft)
        return self._pool

    # -- node lifecycle (DIABase.materialize and dispose) ---------------
    def on_cache(self, node) -> None:
        """A node just cached a freshly computed result."""
        nb = device_bytes(node._shards)
        if nb == 0:
            return
        node._hbm_bytes = nb
        self.mem.add(nb)
        self._lru[node.id] = node
        self.maybe_spill(exclude=node.id)

    def touch(self, node) -> None:
        """A cached node was pulled again: LRU bump, and its result
        uploaded again if it was spilled."""
        if isinstance(node._shards, SpilledShards):
            spilled = node._shards
            node._shards = spilled.restore()
            spilled.free()
            self.restore_count += 1
            nb = device_bytes(node._shards)
            node._hbm_bytes = nb
            self.mem.add(nb)
            log = self.context.logger
            if log.enabled:
                log.line(event="hbm_restore", node=node.label,
                         dia_id=node.id, bytes=nb)
        if node.id in self._lru:
            self._lru[node.id] = self._lru.pop(node.id)
        elif getattr(node, "_hbm_bytes", 0):
            self._lru[node.id] = node
        self.maybe_spill(exclude=node.id)

    def on_release(self, node, dropped) -> None:
        """A node's cached result (``dropped``) was disposed."""
        if isinstance(dropped, SpilledShards):
            dropped.free()
        nb = getattr(node, "_hbm_bytes", 0)
        if nb:
            self.mem.subtract(nb)
            node._hbm_bytes = 0
        self._lru.pop(node.id, None)

    # -- spilling -------------------------------------------------------
    def held_storages(self) -> set:
        """The storages of the inputs of the computes in flight: they
        stay alive through the compute, so spilling them frees nothing."""
        held: set = set()
        pressure = getattr(self.context, "pressure", None)
        if pressure is not None:
            for memo in pressure.memos:
                held |= memo.storages()
        return held

    def maybe_spill(self, exclude: Optional[int] = None) -> None:
        """While the ledger is over its limit, spill the coldest nodes."""
        if self.mem.exceeded:
            self.spill_coldest(need=self.mem.total - self.mem.limit,
                               exclude=exclude)

    def spill_coldest(self, need: Optional[int] = None,
                      exclude: Optional[int] = None,
                      exclude_storage: Optional[set] = None,
                      before: Optional[Callable[[Any], None]] = None
                      ) -> int:
        """Spill the coldest cached results until ``need`` bytes left the
        ledger (all of them when None); never node ``exclude``, nor a
        result whose storage is held (:meth:`held_storages`, or in
        ``exclude_storage``). ``before(node)`` runs ahead of each spill
        and may raise to stop the walk. Returns the bytes freed."""
        held = self.held_storages() | set(exclude_storage or ())
        freed = 0
        for nid in list(self._lru.keys()):
            if nid == exclude:
                continue
            node = self._lru.get(nid)
            if node is None:
                continue
            if held and storages(node._shards) & held:
                continue
            if before is not None:
                before(node)
            total = self.mem.total
            self.spill(node)
            freed += max(total - self.mem.total, 0)
            if need is not None and freed >= need:
                break
        return freed

    def spill(self, node) -> None:
        shards = node._shards
        if not isinstance(shards, DeviceShards):
            return
        try:
            parked = SpilledShards.park(shards, self._spill_pool(),
                                        node.label, ring=self._ring)
        except Exception as e:
            # the node stays resident and in the LRU for a later pass
            faults.note("recovery", what="hbm.spill_skipped",
                        node=node.label, dia_id=node.id, error=repr(e))
            return
        node._shards = parked
        nb = getattr(node, "_hbm_bytes", 0)
        if nb:
            self.mem.subtract(nb)
            node._hbm_bytes = 0
        self._lru.pop(node.id, None)
        self.spill_count += 1
        log = self.context.logger
        if log.enabled:
            log.line(event="hbm_spill", node=node.label, dia_id=node.id,
                     bytes=nb)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool = None
        self._ring = StagingRing()      # its pinned buffers go back
