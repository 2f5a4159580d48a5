"""ReduceByKey / ReducePair / ReduceToIndex, device paths (counterpart
of the reference package's ``api/ops/reduce.py``).

ReduceByKey is two sort + segmented-reduce phases (``core/segmented.py``)
around a hash-partitioned exchange: the pre phase combines each worker's
equal keys, cutting the shuffle as the reference's pre-phase table does;
the post phase combines what arrived. With DuplicateDetection the
destination program fills presence registers (kernel ``presence_fill``)
and keeps rows whose key hash no other worker holds.

With ``THRILL_TPU_REDUCE_STREAM=1`` the post phase is streamed (the
reference's MixStream post phase): the exchange yields its rounds
(``exchange.exchange_stream``) and each is folded into a binary counter
of partial results by one program a fold (``_fold_reduce_device``), the
counts staying on the device.

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

On a CPU mesh (``core/host_radix.py`` ``eligible``) the local combine
and ReduceToIndex's generic dense phase take the native engine instead,
as the reference's do: a hash grouping of the key words in
``native/hostsort.cpp``, then one accumulating pass for a FieldReduce or
a log-depth fold of any other ``reduce_fn`` (:func:`_host_reduce_shards`,
:func:`_host_reduce_to_index`). Such a combine is not stitched.

Stitched (api/fusion.py): ReduceByKey's local combine is a segment
(``ReduceLocal``), the pre phase's in the chain before the exchange (at
W = 1 the whole reduce, and the plan is handed on) and the post phase's
at the head of the chain after it. ReduceToIndex's dense phase is a
segment after its exchange: the scatter engine over the chain's mask,
invalid rows dropped into slots of their own, so B3 and the ordered
fold run exactly where the per-op path runs them.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, List, Optional

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


def _reduce_rows(tree, valid: torch.Tensor, key_fn: Callable,
                 reduce_fn: Callable):
    """Encode keys, sort and segmented-reduce every worker's valid rows:
    (tree, ``[W, cap]`` mask of the runs' representatives)."""
    leaves, td = pt.flatten(tree)
    specs = _device_fold_specs(reduce_fn, td, leaves)
    words = keymod.worker_key_words(key_fn, tree)
    words, tree, valid = segmented.sort_by_key_words(words, tree, valid)
    _, tree, rep = segmented.reduce_runs(words, tree, valid, reduce_fn,
                                         specs)
    return tree, rep


def _local_reduce_program(tree, valid, key_fn, reduce_fn):
    return compact_valid(*_reduce_rows(tree, valid, key_fn, reduce_fn))


def _local_reduce(shards: DeviceShards, key_fn: Callable,
                  reduce_fn: Callable, token) -> DeviceShards:
    """:func:`_reduce_rows`, then every worker's representatives
    compacted, as one program. The capacity stays the input's. On a CPU
    mesh the native engine reduces instead (:func:`_host_reduce_shards`)."""
    mex = shards.mesh_exec
    out = _host_reduce_shards(shards, key_fn, reduce_fn)
    if out is not None:
        return out
    prog = mex.program(("reduce_local", token), _local_reduce_program)
    tree, counts = prog(shards.tree, shards.valid_mask(), key_fn, reduce_fn)
    return DeviceShards(mex, tree, mex.fetch(counts))


# -- the native CPU engine ---------------------------------------------------

def _host_leaves(mex, tree) -> Optional[tuple]:
    """``(leaves, treedef)`` of a CPU mesh's tree as numpy views
    (:meth:`MeshExec.host_view`), or None for a leaf numpy cannot hold
    (bfloat16)."""
    leaves, td = pt.flatten(tree)
    try:
        return [mex.host_view(l) for l in leaves], td
    except TypeError:
        return None


def _tensors(td, arrays) -> Any:
    """numpy leaves as a tree of CPU tensors sharing their memory: what a
    user's function sees, as on the device engine."""
    return pt.unflatten(td, [torch.from_numpy(np.asarray(a))
                             for a in arrays])


def _host_reduce_shards(shards: DeviceShards, key_fn: Callable,
                        reduce_fn: Callable) -> Optional[DeviceShards]:
    """The local reduce on a CPU mesh (reference:
    ``thrill_tpu/api/ops/reduce.py:94-166``): native hash grouping
    (``core/host_radix.py``), one table probe a row, then a FieldReduce
    accumulates in the same pass (:func:`_fused_field_reduce`) or any
    other ``reduce_fn`` folds each group in log2(longest group) calls
    (:func:`_strided_run_fold`). ReduceByKey only needs equal keys
    adjacent, so groups come in first-appearance order; the output's
    capacity is the power of two above the most groups of a worker.

    Returns None where the engine does not apply (another device, the
    library missing, a key_fn or reduce_fn that fails on these columns),
    and the device engine runs. A :class:`host_radix.NativeEngineError`
    propagates: the engine is broken, not inapplicable."""
    from ...core import host_radix

    mex = shards.mesh_exec
    if not host_radix.eligible(mex):
        return None
    # an optimistic exchange's output may owe its capacity check: heal
    # before the columns are read
    shards.validate_pending()
    hl = _host_leaves(mex, shards.tree)
    if hl is None:
        return None
    leaves_np, td = hl
    W = mex.num_workers
    out_counts = np.zeros(W, dtype=np.int64)
    per_worker = []
    try:
        for w in range(W):
            cnt = int(shards.counts[w])
            cols = [l[w][:cnt] for l in leaves_np]
            if cnt == 0:
                per_worker.append(pt.unflatten(td, cols))
                continue
            words = keymod.encode_key_words(key_fn(_tensors(td, cols)))
            fused = _fused_field_reduce(cols, td, words, reduce_fn)
            if fused is not None:
                cols, ngroups = fused
            else:
                perm, lens = host_radix.hash_group(words)
                cols = [host_radix.gather_rows(np.ascontiguousarray(a), perm)
                        for a in cols]
                # the identity write-back skip is sound only for a
                # functor known pure; a black-box reduce_fn may change
                # its left argument in place and return it
                cols = _strided_run_fold(
                    cols, td, lens, reduce_fn,
                    allow_identity_skip=isinstance(reduce_fn, FieldReduce))
                ngroups = len(lens)
            per_worker.append(pt.unflatten(td, cols))
            out_counts[w] = ngroups
    except host_radix.NativeEngineError:
        raise
    except Exception:
        return None
    return DeviceShards.from_worker_arrays(mex, per_worker,
                                           counts=out_counts)


def _fused_field_reduce(cols, td, words, reduce_fn):
    """A FieldReduce whose accumulated leaves are all scalar columns of a
    supported type, as one native probe pass (``hash_group_acc_u64``):
    grouping and accumulation fused, no permutation, gather or fold
    after it (reference: ``thrill_tpu/api/ops/reduce.py:168-210``; the
    runtime analog of the reference framework's templates inlining the
    functor into its probing table). Returns ``(leaves, ngroups)`` or
    None for the generic fold."""
    from ...core import host_radix
    from ..functors import acc_plan

    if not isinstance(reduce_fn, FieldReduce):
        return None
    specs = reduce_fn.flat_spec(td)
    if specs is None:
        return None
    plans = []
    for spec, a in zip(specs, cols):
        p = acc_plan(spec, a.dtype, a.ndim)
        if p is None:
            return None
        plans.append(p)
    acc_cols, ops = [], []
    for (opcode, conv), a in zip(plans, cols):
        if opcode >= 0:              # "first" columns are gathered below
            ops.append(opcode)
            acc_cols.append(a.astype(conv, copy=False))
    heads, accs = host_radix.hash_group_acc(words, acc_cols, ops)
    out, ai = [], 0
    for (opcode, _), a in zip(plans, cols):
        if opcode < 0:
            out.append(host_radix.gather_rows(np.ascontiguousarray(a),
                                              heads))
        else:
            acc = accs[ai]
            ai += 1
            out.append(acc if acc.dtype == a.dtype else acc.astype(a.dtype))
    return out, len(heads)


def _strided_run_fold(leaves, td, lens: np.ndarray, reduce_fn: Callable,
                      allow_identity_skip: bool = False):
    """Fold each run of group-contiguous rows into its head row, in
    place, then gather the heads (reference:
    ``thrill_tpu/api/ops/reduce.py:212-273``).

    A power-of-two strided up-sweep over the rows: the row at in-run
    position p > 0 is absorbed once, at step s = p & -p, into the row s
    slots left of it, which by then holds the fold of positions
    [p-s, p); after every step each head holds the left-to-right
    grouping of its whole run. The native ``fold_plan`` emits every
    level's rows in one O(n) pass. ``reduce_fn`` sees (left rows, right
    rows) as trees of CPU tensors, the left rows earlier in their run,
    so an associative, non-commutative function is safe. Its float sums
    group in this log-depth order, not the ordered fold's.

    Changes ``leaves`` (numpy, freshly gathered) in place; returns the
    heads' leaves (``len(lens)`` rows)."""
    from ...core import host_radix

    leaves = [np.ascontiguousarray(a) for a in leaves]
    ri_all, level_counts = host_radix.fold_plan(lens)
    off = 0
    for lvl in range(32):
        lc = int(level_counts[lvl])
        if lc == 0:
            continue
        ri = ri_all[off:off + lc]
        off += lc
        li = (ri - np.uint32(1 << lvl)).astype(np.uint32, copy=False)
        left = _tensors(td, [host_radix.gather_rows(a, li) for a in leaves])
        right = _tensors(td, [host_radix.gather_rows(a, ri) for a in leaves])
        left_leaves = pt.leaves(left)
        merged = reduce_fn(left, right)
        m_leaves, m_td = pt.flatten(merged)
        if m_td != td:
            # a positional zip would scatter mispaired leaves: a malformed
            # reduce_fn is an error, as on the device engine
            raise ValueError(f"reduce_fn returned tree structure {m_td} "
                             f"!= item structure {td}")
        for a, m, ll in zip(leaves, m_leaves, left_leaves):
            if allow_identity_skip and m is ll:
                # a pure functor's "first" passed the left rows through:
                # writing them back is a no-op
                continue
            host_radix.scatter_rows(
                a, li, np.ascontiguousarray(_to_numpy(m), dtype=a.dtype))
    starts = np.zeros(len(lens), dtype=np.uint32)
    np.cumsum(lens[:-1], dtype=np.uint32, out=starts[1:])
    return [host_radix.gather_rows(a, starts) for a in leaves]


def _to_numpy(x) -> np.ndarray:
    """A user function's result leaf (a CPU tensor, numpy or a number)
    as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fold_program(ta, ca: torch.Tensor, tb, cb: torch.Tensor,
                  key_fn: Callable, reduce_fn: Callable, out_cap: int):
    """Program: the valid rows of two reduced shards concatenated, sorted
    by key words (the radix engine), their runs reduced and compacted,
    padded with zeros to ``out_cap`` rows; (tree, ``[W]`` counts)."""
    la, td = pt.flatten(ta)
    lb = pt.leaves(tb)
    capA, capB = la[0].shape[1], lb[0].shape[1]
    dev = ca.device
    valid = torch.cat([torch.arange(capA, device=dev)[None, :] < ca[:, None],
                       torch.arange(capB, device=dev)[None, :] < cb[:, None]],
                      dim=1)
    tree = pt.unflatten(td, [torch.cat([a, b], dim=1)
                             for a, b in zip(la, lb)])
    tree, counts = compact_valid(*_reduce_rows(tree, valid, key_fn,
                                               reduce_fn))
    pad = out_cap - (capA + capB)

    def padded(l):
        if not pad:
            return l
        return torch.cat([l, torch.zeros((l.shape[0], pad) + tuple(
            l.shape[2:]), dtype=l.dtype, device=l.device)], dim=1)

    return pt.tree_map(padded, tree), counts


def _fold_reduce_device(acc: DeviceShards, block: DeviceShards,
                        key_fn: Callable, reduce_fn: Callable,
                        token) -> DeviceShards:
    """Fold two reduced shards into one (:func:`_fold_program`), counts
    on the device. The output capacity is ``round_up_pow2(capA +
    capB)``: a caller folds a stream as a binary counter, never linearly
    through one accumulator, whose capacity would double every fold."""
    mex = acc.mesh_exec
    out_cap = round_up_pow2(acc.cap + block.cap)
    prog = mex.program(("reduce_fold", token), _fold_program)
    tree, counts = prog(acc.tree, acc.counts_device(), block.tree,
                        block.counts_device(), key_fn, reduce_fn, out_cap)
    return DeviceShards(mex, tree, counts)


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

    def _fuse_segment(self, phase: str):
        """The local combine as a segment (reference:
        ``thrill_tpu/api/ops/reduce.py:358-384``), or None on a CPU
        mesh, where the native engine reduces unstitched."""
        from .. import fusion
        from ...core import host_radix
        if host_radix.eligible(self.context.mesh_exec):
            return None
        key_fn, reduce_fn = self.key_fn, self.reduce_fn

        def trace(fctx, tree, mask, _bound):
            return _reduce_rows(tree, mask, key_fn, reduce_fn)

        return fusion.Segment(label="ReduceLocal",
                              token=("reduce_local", phase, self.token),
                              trace=trace, dia_id=self.id)

    def compute_plan(self):
        from .. import fusion
        plan = fusion.pull_plan(self.parents[0])
        seg = self._fuse_segment("pre") if plan.stitchable else None
        if seg is None:
            return fusion.wrap(self._compute_on(plan.finish()))
        plan.append(seg)
        if self.context.num_workers == 1:
            # the pre phase is the whole reduce: downstream ops stitch on
            return plan
        # the exchange is a barrier that reads the columns
        return self._post_exchange(plan.finish())

    def compute(self):
        return self.compute_plan().finish()

    def _compute_on(self, shards):
        """The per-op path over pulled shards (``THRILL_TPU_FUSE=0``,
        and host storage)."""
        if isinstance(shards, HostShards):
            return self._compute_host(shards)
        pre = _local_reduce(shards, self.key_fn, self.reduce_fn,
                            ("pre", self.token))
        if self.context.num_workers == 1:
            # the pre phase combined every key: nothing left to merge
            return pre
        return self._post_exchange(pre).finish()

    def _post_exchange(self, pre: DeviceShards):
        """Shuffle the pre-reduced rows by key hash and combine again;
        returns a plan whose post phase is pending when stitching is on,
        so downstream ops can stitch onto it."""
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
                local = torch.zeros((reg.shape[0], M), dtype=torch.int32,
                                    device=reg.device).scatter_reduce_(
                    1, reg, mask.to(torch.int32), "amax")
            # the psum over W (an all-reduce across processes)
            holders = mex.worker_sum(local, dtype=torch.int32)
            mine_only = (holders[reg] == 1) & (torch.gather(local, 1, reg)
                                               == 1)
            return torch.where(mine_only, widx, hash_dest)

        from .. import fusion
        if os.environ.get("THRILL_TPU_REDUCE_STREAM") == "1":
            # the streamed post phase (reference: use_post_thread_
            # overlap, api/reduce_by_key.hpp:142-168, over MixStream's
            # arbitrary-order delivery)
            return fusion.wrap(self._compute_device_stream(pre, dest, dup))
        shuffled = exchange.exchange(pre, dest,
                                     ("reduce_dest", self.token, W, dup))
        seg = self._fuse_segment("post") if fusion.enabled() else None
        if seg is not None:
            plan = fusion.FusionPlan(mex, [shuffled])
            plan.append(seg)
            return plan
        return fusion.wrap(_local_reduce(shuffled, key_fn, self.reduce_fn,
                                         ("post", self.token)))

    def _compute_device_stream(self, pre: DeviceShards, dest: Callable,
                               dup: bool) -> DeviceShards:
        """The streamed post phase: every round the exchange yields folds
        into a binary counter (``levels[i]`` holds the reduction of 2^i
        rounds; a new round folds up through the full levels), so every
        fold is between shards of one magnitude and the capacities walk
        a power-of-two ladder; the leftover levels fold last."""
        key_fn, reduce_fn, token = self.key_fn, self.reduce_fn, self.token
        W = self.context.num_workers
        levels: List[Optional[DeviceShards]] = []
        for block in exchange.exchange_stream(
                pre, dest, ("reduce_dest", token, W, dup)):
            # a round's rows are pre-reduced (unique keys): any round is
            # a partial result already
            cur, i = block, 0
            while i < len(levels) and levels[i] is not None:
                cur = _fold_reduce_device(levels[i], cur, key_fn,
                                          reduce_fn, token)
                levels[i] = None
                i += 1
            if i == len(levels):
                levels.append(cur)
            else:
                levels[i] = cur
        acc: Optional[DeviceShards] = None
        for lv in levels:
            if lv is not None:
                acc = lv if acc is None else _fold_reduce_device(
                    lv, acc, key_fn, reduce_fn, token)
        return acc

    def _compute_host(self, shards: HostShards) -> HostShards:
        """The reference's host path, item for item
        (``thrill_tpu/api/ops/reduce.py:554-669``)."""
        W = shards.num_workers
        mex = self.context.mesh_exec
        key_fn, reduce_fn = self.key_fn, self.reduce_fn
        owns_input = self.parents[0].node.state in ("DISPOSED", "FUSED")
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
        non_unique = None
        if dup and W > 1:
            # across processes the fingerprints (not the items) are
            # gathered, so every process finds the same non-unique set
            # (reference: thrill_tpu/api/ops/reduce.py:597-610)
            non_unique = duplicate_detection.find_non_unique_hashes(
                multiplexer.global_lists(mex, pre_hashes))
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
        # a hash partition: the post phase folds each key's entries, so
        # the receive order is free (THRILL_TPU_HOST_MIX may take frames
        # as they arrive; the reduce_fn's order contract is the user's)
        ex = multiplexer.host_exchange(
            mex, HostShards(W, pre_lists),
            lambda kv: kv[1] % W if kv[0] is None else kv[0],
            reason="reduce", rank_order=False)
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


def _fill_value(nv, dtype: torch.dtype, device) -> torch.Tensor:
    """A neutral (None for zero, a number or a numpy array) as a tensor
    on ``device``: a fill kernel when every element is one value, so no
    copy from the host runs inside the program (a CUDA graph holds no
    pageable copy)."""
    a = np.asarray(0 if nv is None else nv)
    if a.size and (a == a.flat[0]).all():
        return torch.full(a.shape, a.flat[0].item(), dtype=dtype,
                          device=device)
    return torch.as_tensor(a, device=device).to(dtype)


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
                # a copy of the kept rows: a view would pin the dump
                # slots' storage, which the HBM ledger does not charge
                col = torch.zeros((size + T,) + trail, dtype=leaf.dtype,
                                  device=dev).index_add_(0, flat,
                                                         leaf)[:size].clone()
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
        fill = _fill_value(nv, leaf.dtype, dev)
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
        W, n = shards.num_workers, self.size

        def dest(tree, mask, widx):
            # the worker w with bounds[w] <= idx < bounds[w + 1]
            # (dense_range_bounds: bounds[w] = w * n // W), 0 below the
            # range and W past it, as a search of bounds[1:] gives,
            # computed from the index alone: no bounds tensor to upload
            # (the reference bakes its bounds into the program)
            idx = _index_of(self.index_fn, tree)
            if n == 0:
                return (idx >= 0).to(torch.int64) * W
            return torch.div((idx + 1) * W - 1, n,
                             rounding_mode="floor").clamp(0, W)

        return exchange.exchange(
            shards, dest, ("r2i_dest", (self.index_fn, self.reduce_fn,
                                        self.size), W))

    def _fuse_segment(self, bounds: np.ndarray,
                      counts: Optional[np.ndarray] = None,
                      row_bound: Optional[int] = None):
        """The dense phase after the exchange as a segment (reference:
        ``thrill_tpu/api/ops/reduce.py:971-1039``): the scatter engine
        for FieldReduce specs, else the sorted engine; the output is
        every worker's dense ``[out_cap]`` range, its counts the ranges'
        sizes. With the input's ``counts`` known on the host (the
        exchange's output) the scatter engine takes the valid rows only,
        as the per-op path does; with them on the device (an optimistic
        exchange) and ``row_bound`` (the exchange input's rows, at least
        its total) the first ``row_bound`` rows of the valid prefixes;
        else every row, the invalid ones dropped by the chain's mask."""
        from .. import fusion
        mex = self.context.mesh_exec
        W = self.context.num_workers
        local_sizes = (bounds[1:] - bounds[:-1]).astype(np.int64)
        out_cap = max(1, round_up_pow2(int(local_sizes.max())))
        # across processes the local workers' ranges
        starts_l, local_sizes = (mex.local(bounds[:W].astype(np.int64)),
                                 mex.local(local_sizes))
        index_fn, reduce_fn, neutral = self.index_fn, self.reduce_fn, \
            self.neutral
        ntok = None
        if neutral is not None:
            ntok = (str(pt.flatten(neutral)[1]),
                    tuple(np.asarray(l).tobytes()
                          for l in pt.leaves(neutral)))

        total = None if counts is None else int(counts.sum())
        bound = (starts_l, local_sizes)
        if total is not None:
            bound += (np.concatenate([[0], np.cumsum(counts)]),)

        if total is not None:
            row_bound = None

        def trace(fctx, tree, mask, bound_t):
            starts, sizes = bound_t[:2]
            rows = None if total is None else (total, bound_t[2])
            out = _dense_rows(tree, mask, index_fn, reduce_fn, neutral,
                              starts, sizes, out_cap, rows, row_bound)
            return out, (torch.arange(out_cap, device=mask.device)[None, :]
                         < sizes[:, None])

        return fusion.Segment(
            label="ReduceToIndex",
            token=("r2i_post_fused", (index_fn, reduce_fn, self.size),
                   out_cap, ntok, total, row_bound),
            trace=trace, bound=bound,
            already_compact=True, sets_counts=local_sizes, dia_id=self.id)

    def compute_plan(self):
        from .. import fusion
        from ...core import host_radix
        plan = fusion.pull_plan(self.parents[0])
        bounds = self._bounds()
        # a FieldReduce keeps the scatter engine, on a CPU mesh too; any
        # other reduce_fn takes the native engine there, unstitched
        # (reference: thrill_tpu/api/ops/reduce.py:1041-1060)
        if not plan.stitchable or (
                host_radix.eligible(self.context.mesh_exec)
                and not isinstance(self.reduce_fn, FieldReduce)):
            return fusion.wrap(self._compute_on(plan.finish(), bounds))
        row_bound = None
        if self.context.num_workers > 1:
            # the exchange is a barrier: the chain after it starts here,
            # its rows the valid prefixes of the exchange's output, at
            # most as many as the exchange's input rows
            src = plan.finish()
            row_bound = src.num_workers * src.cap
            shards = self._exchange_by_index(src, bounds)
            del src
            plan = fusion.FusionPlan(shards.mesh_exec, [shards])
        plan.append(self._fuse_segment(bounds, plan.known_counts, row_bound))
        return plan

    def compute(self):
        return self.compute_plan().finish()

    def _compute_on(self, shards, bounds: np.ndarray):
        """The per-op path (``THRILL_TPU_FUSE=0``, and host storage)."""
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
        # across processes the local workers' ranges
        starts, local_sizes = mex.local(bounds[:W]), mex.local(local_sizes)
        sc = _scatter_fold_specs(self.reduce_fn, td, leaves)
        if sc is None:
            # what the scatter engine does not take goes to the native
            # engine on a CPU mesh
            host = _host_reduce_to_index(shards, self.index_fn,
                                         self.reduce_fn, bounds,
                                         self.neutral)
            if host is not None:
                return host
        prog = mex.program(("r2i", self.index_fn, self.reduce_fn,
                            self.size), _dense_program)
        if sc is None:
            out = prog(None, shards.tree, shards.valid_mask(),
                       self.index_fn, self.reduce_fn, self.neutral,
                       mex.put_small(starts), None, out_cap)
            return DeviceShards(mex, out, local_sizes)
        # the scatter engine takes the valid rows only, worker-major, so
        # no padding row of the [W, cap] shards is scattered
        cum = mex.put_small(np.concatenate([[0], np.cumsum(shards.counts)]))
        out = prog(sc, shards.tree,
                   _valid_rows(int(shards.counts.sum()), cum, shards.cap),
                   self.index_fn, self.reduce_fn, self.neutral,
                   mex.put_small(starts), mex.put_small(local_sizes),
                   out_cap)
        return DeviceShards(mex, out, local_sizes)

    def _compute_host(self, shards: HostShards,
                      bounds: np.ndarray) -> HostShards:
        """One dict a worker range; ``neutral`` at indices no item
        reached (reference: ``thrill_tpu/api/ops/reduce.py:1166-1181``)."""
        W = shards.num_workers
        index_fn, reduce_fn = self.index_fn, self.reduce_fn
        mex = self.context.mesh_exec
        tables = [dict() for _ in range(W)]
        # every item, in global order, on every process: each folds the
        # ranges of its own workers
        for items in multiplexer.ensure_replicated(mex, shards,
                                                   "reducetoindex").lists:
            for it in items:
                i = int(index_fn(it))
                t = tables[int(np.searchsorted(bounds[1:], i, side="right"))]
                t[i] = reduce_fn(t[i], it) if i in t else it
        local = multiplexer.local_worker_set(mex)
        return HostShards(W, [
            [tables[w].get(i, self.neutral)
             for i in range(int(bounds[w]), int(bounds[w + 1]))]
            if w in local else [] for w in range(W)])

def _host_reduce_to_index(shards: DeviceShards, index_fn, reduce_fn,
                          bounds: np.ndarray,
                          neutral) -> Optional[DeviceShards]:
    """ReduceToIndex's dense phase on a CPU mesh (reference:
    ``thrill_tpu/api/ops/reduce.py:706-811``): FieldReduce columns as
    numpy scatter-accumulations (:func:`_scatter_field`), any other
    ``reduce_fn`` through the native hash grouping by index and
    :func:`_strided_run_fold`, the groups' heads scattered by index.
    Indices no item reached hold ``neutral`` (zero when None). Returns
    None where the engine does not apply (another device, an index out of
    its worker's range, a function that fails on these columns); a
    :class:`host_radix.NativeEngineError` propagates."""
    from ...core import host_radix
    from ..functors import acc_plan

    mex = shards.mesh_exec
    if not host_radix.eligible(mex):
        return None
    shards.validate_pending()
    hl = _host_leaves(mex, shards.tree)
    if hl is None:
        return None
    leaves_np, td = hl
    W = mex.num_workers
    local_sizes = (bounds[1:] - bounds[:-1]).astype(np.int64)
    neutral_leaves = None
    if neutral is not None:
        if pt.flatten(neutral)[1] != td:
            # the device engine raises on the mismatch
            return None
        neutral_leaves = pt.leaves(neutral)
    specs = None
    if isinstance(reduce_fn, FieldReduce):
        specs = reduce_fn.flat_spec(td)
        if specs is not None and any(
                sp != "first" and acc_plan(sp, a.dtype, a.ndim - 1) is None
                for sp, a in zip(specs, leaves_np)):
            specs = None
    per_worker = []
    try:
        for w in range(W):
            cnt = int(shards.counts[w])
            lo, size = int(bounds[w]), int(local_sizes[w])
            cols = [l[w][:cnt] for l in leaves_np]
            idx = (torch.as_tensor(index_fn(_tensors(td, cols))).to(
                torch.int64).numpy() - lo if cnt
                else np.zeros(0, np.int64))
            if cnt and (idx.min() < 0 or idx.max() >= size):
                return None          # the device engine's clip applies
            present = np.zeros(size, dtype=bool)
            present[idx] = True
            if specs is not None:
                out = [_scatter_field(sp, c, idx, size)
                       for sp, c in zip(specs, cols)]
            elif cnt:
                perm, lens = host_radix.hash_group([idx.astype(np.uint64)])
                folded = _strided_run_fold(
                    [host_radix.gather_rows(np.ascontiguousarray(a), perm)
                     for a in cols], td, lens, reduce_fn,
                    allow_identity_skip=isinstance(reduce_fn, FieldReduce))
                starts = np.zeros(len(lens), dtype=np.uint32)
                np.cumsum(lens[:-1], dtype=np.uint32, out=starts[1:])
                gidx = idx[perm[starts]]
                out = []
                for c in folded:
                    base = np.zeros((size,) + c.shape[1:], c.dtype)
                    base[gidx] = c
                    out.append(base)
            else:
                out = [np.zeros((size,) + a.shape[2:], a.dtype)
                       for a in leaves_np]
            # indices no item reached: the neutral, or 0 (the device
            # engine's zero base), so no min/max sentinel leaks out
            for i, o in enumerate(out):
                o[~present] = (neutral_leaves[i] if neutral_leaves
                               is not None else 0)
            per_worker.append(pt.unflatten(td, out))
    except host_radix.NativeEngineError:
        raise
    except Exception:
        return None
    return DeviceShards.from_worker_arrays(mex, per_worker,
                                           counts=local_sizes)


def _scatter_field(op: str, col: np.ndarray, idx: np.ndarray,
                   size: int) -> np.ndarray:
    """One FieldReduce column as a dense numpy scatter-accumulation."""
    if op == "first":
        out = np.zeros((size,) + col.shape[1:], col.dtype)
        # assigned in reverse: the first occurrence wins
        out[idx[::-1]] = col[::-1]
        return out
    out = np.zeros(size, col.dtype)
    if op == "sum":
        np.add.at(out, idx, col)
        return out
    if op == "min":
        out.fill(np.inf if np.issubdtype(col.dtype, np.floating)
                 else np.iinfo(col.dtype).max)
        np.minimum.at(out, idx, col)
    else:
        out.fill(-np.inf if np.issubdtype(col.dtype, np.floating)
                 else np.iinfo(col.dtype).min)
        np.maximum.at(out, idx, col)
    # untouched slots hold the sentinels; the caller's fill replaces them
    return out


def _sorted_dense(tree, valid: torch.Tensor, index_fn, reduce_fn, neutral,
                  starts: torch.Tensor, out_cap: int):
    """Sort by index, fold each run, scatter the representatives into
    the dense ``[W, out_cap]`` rows (``starts`` ``[W]``: each worker's
    first index)."""
    leaves, td = pt.flatten(tree)
    W, n = valid.shape
    dev = valid.device
    specs = _device_fold_specs(reduce_fn, td, leaves)
    words, tree, valid = segmented.sort_by_key_words(
        [_index_of(index_fn, tree)], tree, valid)
    words, tree, rep = segmented.reduce_runs(words, tree, valid, reduce_fn,
                                             specs)
    local_idx = words[0] - starts[:, None]
    # a representative below its range clips to row 0, one past it is
    # dropped, as the reference's clip into [0, out_cap]
    flat = scatter_slots(local_idx.clamp(min=0),
                         rep & (local_idx < out_cap), out_cap)
    region = out_cap + n
    nleaves = (pt.leaves(neutral) if neutral is not None
               else [0] * len(leaves))

    def scatter(leaf, nv):
        trail = tuple(leaf.shape[2:])
        base = torch.empty((W * region,) + trail, dtype=leaf.dtype,
                           device=dev)
        base[:] = _fill_value(nv, leaf.dtype, dev)
        # representatives have distinct indices
        base.index_put_((flat,), leaf.reshape((-1,) + trail))
        return base.reshape((W, region) + trail)[:, :out_cap]

    return pt.unflatten(td, [scatter(l, nv) for l, nv in
                             zip(pt.leaves(tree), nleaves)])


def _scatter_dense(tree, index_fn, sc, neutral, w_of: torch.Tensor,
                   keep: torch.Tensor, starts: torch.Tensor,
                   sizes: torch.Tensor, W: int, out_cap: int):
    """The scatter engine over rows ``tree`` (leaves ``[T, ...]``,
    worker-major) of workers ``w_of`` ``[T]``; a row outside its
    worker's range, or not in ``keep``, is dropped."""
    dev = w_of.device
    local = (torch.as_tensor(index_fn(tree), device=dev).to(torch.int64)
             - starts[w_of])
    ok = keep & (local >= 0) & (local < sizes[w_of])
    pos = torch.where(ok, w_of * out_cap + local,
                      torch.full_like(local, W * out_cap))
    out = _scatter_reduce_apply(tree, pos, W * out_cap, sc, neutral)
    return pt.tree_map(
        lambda l: l.reshape((W, out_cap) + tuple(l.shape[1:])), out)


def _dense_program(sc, tree, rows, index_fn, reduce_fn, neutral, starts,
                   sizes, out_cap: int):
    """ReduceToIndex's per-op dense phase: the sorted engine (``sc`` None,
    ``rows`` the valid mask) or the scatter engine over the valid rows
    (``rows`` = (their flat index, their worker))."""
    if sc is None:
        return _sorted_dense(tree, rows, index_fn, reduce_fn, neutral,
                             starts, out_cap)
    sel, w_of = rows
    W, cap = pt.leaves(tree)[0].shape[:2]
    flat = pt.tree_map(lambda l: take_rows(
        l.reshape((W * cap,) + tuple(l.shape[2:])), sel), tree)
    return _scatter_dense(flat, index_fn, sc, neutral, w_of,
                          torch.ones_like(w_of, dtype=torch.bool), starts,
                          sizes, W, out_cap)


def _valid_rows(total: int, cum: torch.Tensor, cap: int):
    """(flat row index, worker) of every valid row, worker-major, from
    host-known counts (``cum`` their ``[W + 1]`` running sum on the
    device)."""
    t = torch.arange(total, device=cum.device)
    w_of = torch.searchsorted(cum[1:], t, right=True)
    return t + w_of * cap - cum[w_of], w_of


def _bounded_rows(mask: torch.Tensor, bound: int):
    """(flat row index, worker, kept) of the first ``bound`` rows of the
    valid prefixes of ``mask``, worker-major: the valid rows in
    :func:`_valid_rows`' order when their total is only bounded on the
    host (counts on the device), the rows past the total not kept."""
    W, cap = mask.shape
    cum = torch.zeros(W + 1, dtype=torch.int64, device=mask.device)
    cum[1:] = torch.cumsum(mask.sum(dim=1), 0)
    t = torch.arange(bound, device=mask.device)
    w_of = torch.searchsorted(cum[1:], t, right=True).clamp(max=W - 1)
    sel = (t + w_of * cap - cum[w_of]).clamp(0, W * cap - 1)
    return sel, w_of, t < cum[W]


def _dense_rows(tree, mask: torch.Tensor, index_fn, reduce_fn, neutral,
                starts: torch.Tensor, sizes: torch.Tensor, out_cap: int,
                rows=None, row_bound=None):
    """The segment's form of :func:`_dense_program`: with ``rows`` =
    (total, counts' running sum) the scatter engine takes the valid rows
    as the per-op path does; with ``row_bound`` (counts on the device,
    their total at most that, ``mask`` valid prefixes) the first
    ``row_bound`` rows of the valid prefixes, in the same order; else
    every row of the chain, the invalid ones dropped into slots of their
    own."""
    W, cap = mask.shape
    leaves, td = pt.flatten(tree)
    sc = _scatter_fold_specs(reduce_fn, td, leaves)
    if sc is None:
        return _sorted_dense(tree, mask, index_fn, reduce_fn, neutral,
                             starts, out_cap)
    if rows is not None:
        return _dense_program(sc, tree, _valid_rows(rows[0], rows[1], cap),
                              index_fn, reduce_fn, neutral, starts, sizes,
                              out_cap)
    if row_bound is not None and row_bound < W * cap:
        sel, w_of, keep = _bounded_rows(mask, row_bound)
        flat = pt.tree_map(lambda l: take_rows(
            l.reshape((W * cap,) + tuple(l.shape[2:])), sel), tree)
        return _scatter_dense(flat, index_fn, sc, neutral, w_of, keep,
                              starts, sizes, W, out_cap)
    flat = pt.tree_map(lambda l: l.reshape((W * cap,) + tuple(l.shape[2:])),
                       tree)
    w_of = torch.arange(W, device=mask.device).repeat_interleave(cap)
    return _scatter_dense(flat, index_fn, sc, neutral, w_of,
                          mask.reshape(-1), starts, sizes, W, out_cap)


def ReduceToIndex(dia: DIA, index_fn, reduce_fn, size,
                  neutral=None) -> DIA:
    return DIA(ReduceToIndexNode(dia.context, dia._link(), index_fn,
                                 reduce_fn, size, neutral))
