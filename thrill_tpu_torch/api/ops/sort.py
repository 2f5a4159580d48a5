"""Distributed sample sort (counterpart of the reference package's
``api/ops/sort.py``). Host storage, and a ``compare_fn`` on any storage,
sort the items on the host: in memory up to a run's size, else by the
external-memory sort (``SortNode._em_sort``: sorted runs spilled to the
block store and merged); device storage takes the sample sort below.

All W workers run each phase as one batched program over ``[W, cap]``
tensors; only (validity, key words, global index) go through the sort
engine and the payload is gathered once per phase:

 1. keys:     per-worker argsort of (key words, global index) and
              OVERSAMPLE quantile samples. W == 1 ends here with one
              payload gather.
 2. classify: the host picks W-1 splitters from the samples; each item's
              destination is its rank among them under the (words,
              global index) order, so equal keys spread across workers
              and destinations are monotone in the sorted order. The
              send matrix comes from the histogram kernel.
 3. merge:    ship the blocks (scatter plus a worker-dim transpose),
              then one argsort of the received (invalid, words, global
              index) and one payload gather.

The order (words, global index) is total, so the result is globally
sorted across worker ranks and stable, row for row the reference's.

On a CPU mesh the W == 1 sort is the native stable radix sort of
``core/host_radix.py`` (:func:`_host_radix_w1`), unstitched, as in the
reference.

Stitched (api/fusion.py), the W == 1 sort is a segment: an argsort of
(invalid, key words, row) over the chain's mask through the radix engine
and one payload gather, its valid rows a prefix. The W > 1 sample sort
needs its splitters on the host and an exchange, so it is a barrier.
"""

from __future__ import annotations

import functools
import os
import pickle
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...common.trace import span_of
from ...core import keys as keymod
from ...core.device_sort import argsort_words
from ...core.rowmove import take_rows, take_rows_multi
from ...data import exchange
from ...data import multiplexer
from ...data.shards import DeviceShards, HostShards
from ...parallel.mesh import current_mex
from ..dia import DIA
from ..dia_base import DIABase

OVERSAMPLE = 32  # samples per worker; splitter error ~ 1/OVERSAMPLE
VALID_BITS = 8   # the validity word is 0 or 1: one radix digit


def quantile_positions(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """``[W, OVERSAMPLE]`` quantile positions over each worker's valid
    prefix ``[0, count)`` of a sorted column, clipped to ``[0, cap)``."""
    count = counts.to(torch.int64).clamp(min=1)[:, None]
    k = torch.arange(OVERSAMPLE, device=counts.device)[None, :]
    return ((k * 2 + 1) * count // (2 * OVERSAMPLE)).clamp(0, cap - 1)


def choose_splitters(samples, W: int, ncols: int) -> np.ndarray:
    """W-1 equidistant splitters from SORTED sample tuples (each a flat
    tuple of ints, ncols wide) -> uint64 ``[max(W-1, 1), ncols]``."""
    splitters = np.zeros((max(W - 1, 1), ncols), dtype=np.uint64)
    if samples and W > 1:
        for j in range(1, W):
            s = samples[min(len(samples) - 1, (j * len(samples)) // W)]
            splitters[j - 1] = np.array(s, dtype=np.uint64)
    return splitters


def _lex_greater(words: torch.Tensor, gidx: torch.Tensor,
                 splitter: torch.Tensor) -> torch.Tensor:
    """(words, gidx) > splitter lexicographically in unsigned order.
    ``words`` ``[W, cap, nw]``, ``gidx`` ``[W, cap]``, ``splitter``
    ``[nw + 1]`` int64 -> ``[W, cap]`` bool."""
    nw = words.shape[2]
    spl = keymod.order_view(splitter)
    gt = torch.zeros(gidx.shape, dtype=torch.bool, device=gidx.device)
    eq = torch.ones_like(gt)
    for i in range(nw):
        w = keymod.order_view(words[:, :, i])
        gt |= eq & (w > spl[i])
        eq &= w == spl[i]
    return gt | (eq & (keymod.order_view(gidx) > spl[nw]))


class SortNode(DIABase):
    # an external-memory operator: it asks for all the RAM it can get
    # (Thrill: DIAMemUse::Max, api/sort.hpp)
    MEM_USE = "max"

    def __init__(self, ctx, link, key_fn: Optional[Callable],
                 compare_fn: Optional[Callable] = None) -> None:
        super().__init__(ctx, "Sort", [link])
        self.key_fn = key_fn or (lambda x: x)
        self.compare_fn = compare_fn

    def _fuse_segment(self):
        """The W == 1 sort as a segment (reference:
        ``thrill_tpu/api/ops/sort.py:90-120``), or None."""
        from .. import fusion
        from ...core import host_radix
        # on a CPU mesh the native engine sorts, unstitched
        if self.context.num_workers != 1 or self.compare_fn is not None \
                or host_radix.eligible(self.context.mesh_exec):
            return None
        key_fn = self.key_fn
        mex = self.context.mesh_exec

        def trace(fctx, tree, mask, _bound):
            out, count = _sort_w1(tree, mask, key_fn, mex.radix_passes,
                                  validity=True)
            cap = mask.shape[1]
            return out, (torch.arange(cap, device=mask.device)[None, :]
                         < count[:, None])

        return fusion.Segment(label="Sort",
                              token=("sort_w1_fused", key_fn),
                              trace=trace, preserves_counts=True,
                              already_compact=True, dia_id=self.id)

    def compute_plan(self):
        from .. import fusion
        seg = self._fuse_segment()
        if seg is None:
            return None
        plan = fusion.pull_plan(self.parents[0])
        if not plan.stitchable:
            return fusion.wrap(self._compute_on(plan.finish()))
        plan.append(seg)
        return plan

    def compute(self):
        plan = self.compute_plan()
        if plan is not None:
            return plan.finish()
        return self._compute_on(self.parents[0].pull())

    def _compute_on(self, shards):
        if isinstance(shards, HostShards):
            return self._compute_host_global(shards)
        if self.compare_fn is not None:
            # a comparator sees items, not columns: the items move to the
            # host, as in the reference
            return self._compute_host_global(
                shards.to_host_shards("sort-compare-fn"))
        return _device_sample_sort(shards, self.key_fn)

    def _compute_host_global(self, shards: HostShards) -> HostShards:
        """:meth:`_compute_host` of every worker's items: across
        processes the items are replicated, every process sorts them
        alike and keeps its own workers' lists (reference:
        ``thrill_tpu/api/ops/sort.py:153-161``)."""
        mex = self.context.mesh_exec
        if multiplexer.multiprocess(mex):
            rep = multiplexer.ensure_replicated(mex, shards, "sort-host")
            return multiplexer.localize(mex, self._compute_host(rep))
        return self._compute_host(shards)

    # above this many items the host path sorts external-memory style:
    # sorted runs spilled to Files and k-way merged (Thrill:
    # SortAndWriteToFile and PartialMultiwayMerge, api/sort.hpp:216-271,
    # 665-699); THRILL_TPU_HOST_SORT_RUN sets it
    HOST_RUN_SIZE = 1 << 20

    def _compute_host(self, shards: HostShards) -> HostShards:
        """Sort host items by ``key_fn`` per item, or by the less-than
        predicate ``compare_fn``, stably, and split them evenly: in
        memory up to the run size, else by :meth:`_em_sort`. Items that
        cannot be spilled (a ``pickle`` error) sort in memory, as in the
        reference, when the input is still whole; when the sort had
        already emptied lists of a consumed input the error is raised,
        where the reference would sort what was left."""
        W = shards.num_workers
        if self.compare_fn is not None:
            less = self.compare_fn
            sort_key = functools.cmp_to_key(
                lambda a, b: -1 if less(a, b) else (1 if less(b, a) else 0))
        else:
            sort_key = self.key_fn
        run_size = int(os.environ.get("THRILL_TPU_HOST_SORT_RUN") or
                       self._granted_run_size(shards))
        run_size = max(run_size, 16)
        n = shards.total
        if n > run_size:
            try:
                return HostShards(W, self._em_sort(shards, sort_key,
                                                   run_size, W))
            except (TypeError, ValueError, AttributeError):
                if shards.total != n:
                    raise
        items = [it for l in shards.lists for it in l]
        items.sort(key=sort_key)
        bounds = dense_range_bounds(n, W).tolist()
        return HostShards(W, [items[bounds[w]:bounds[w + 1]]
                              for w in range(W)])

    def _granted_run_size(self, shards: HostShards) -> int:
        """Items a run holds under the RAM grant: the grant over the
        first item's pickled size plus 64 bytes of interpreter overhead
        (Thrill sizes its ReceiveItems from the grant over the item size,
        api/sort.hpp:665-699); :data:`HOST_RUN_SIZE` without a grant."""
        if not self.mem_limit:
            return self.HOST_RUN_SIZE
        first = next((it for l in shards.lists for it in l), None)
        if first is None:
            return self.HOST_RUN_SIZE
        try:
            est = len(pickle.dumps(first,
                                   protocol=pickle.HIGHEST_PROTOCOL)) + 64
        except Exception:
            est = 256
        return max(16, min(self.mem_limit // est, 1 << 26))

    def _em_sort(self, shards: HostShards, sort_key, run_size: int,
                 W: int) -> List[list]:
        """External-memory sort: spill sorted runs, k-way merge them into
        the W output lists (the reference's ``_em_sort``).

        Items carry their stream position; the order is (key, position),
        so the sort is stable and the splitters, W-1 draws of a growing
        reservoir (``np.random.default_rng(17)``, Thrill: the Sort
        PreOp's ReservoirSamplingGrow, api/sort.hpp:303), cut inside runs
        of equal keys. A run of ``run_size`` items, or fewer when the
        process's RSS outgrows the grant, is sorted, serialized and
        written by one job on the write-behind writer while the next run
        forms. Keys whose schema byte-encodes (``core/order_key.py``)
        sort as bytes and merge in C++ (``core/native_merge.py``); a key
        that deviates from the first key's schema demotes the rest to
        Python comparisons (``engine`` "py"), and the runs spilled before
        still merge. Items whose schema vectorizes (``data/records.py``)
        spill as columnar blocks built natively in the job; a run the
        records cannot represent takes the per-item path in the job. The
        merge reads one block ahead a run (``THRILL_TPU_PREFETCH``) and
        appends straight into the partitioned output. When the input was
        consumed by this pull, its lists are emptied as they spill.
        With a checkpoint manager each spilled run is also committed to
        a run store (``core/em_runs.py``), and a resumed run loads a
        committed run that matches instead of forming it.
        ``self._em_stats`` reports runs, engine, records blocks, runs
        reused, seconds, overlap and bytes."""
        from ...common import faults
        from ...common.iostats import IO as _IOSTATS, hit_rate, \
            overlap_frac
        from ...common.sampling import ReservoirSamplingGrow
        from ...core import em_runs, native_merge, order_key
        from ...core.multiway_merge import multiway_merge_files
        from ...data import records as native_records
        from ...data.block_pool import spill_pool
        from ...data.file import DEFAULT_BLOCK_ITEMS, File
        from ...data.writeback import AsyncWriter, make_readahead
        from ...mem.manager import RssBudget
        from ...vfs.file_io import prefetch_depth

        owns_input = self.parents[0].node.state in ("DISPOSED", "FUSED")
        io_base = _IOSTATS.snapshot()
        pool = spill_pool(self.context.config.spill_dir, self.mem_limit)
        # None without a checkpoint manager or with THRILL_TPU_EM_RESUME=0
        run_store = em_runs.store_for(
            self.context, node_id=self.id, label=self.label, W=W,
            run_size=run_size, total=shards.total)
        sampler = ReservoirSamplingGrow(np.random.default_rng(17))
        pair_key = lambda t: (sort_key(t[1]), t[0])  # noqa: E731
        # the key engine: probed from the first item, demoted to None on
        # any schema deviation; item files always hold (pos, item)
        # records in key order, so runs spilled before a demotion merge
        enc = None
        enc_state = "probe" if native_merge.available() else "off"
        enc_arr = None      # the array encoder (int and str keys)
        files: list = []    # item Files, (pos, item) records
        key_files: list = []  # their key Files (native engine)
        run: list = []      # native: (kb, pos, item); generic: (pos, item)
        # a fully columnar run: key rows in S-w arrays, items in a list,
        # positions col_pos0 + index; a batch the array encoder cannot
        # take folds it into `run` tuples
        col_arrs: list = []
        col_items: list = []
        col_pos0 = 0
        # the items' records encoder, probed from the first item
        rec_probe = "probe"
        rec_enc = None
        pos = 0
        budget = RssBudget(self.mem_limit or 0)

        def run_len():
            return len(run) + len(col_items)

        def decolumnize():
            """Fold the columnar batches into (kb, pos, item) tuples."""
            nonlocal col_arrs, col_items, col_pos0
            p = col_pos0
            for arr in col_arrs:
                w_ = arr.dtype.itemsize
                raw = arr.tobytes()     # the memory: no NUL stripping
                n_ = len(arr)
                run.extend(zip(
                    (raw[i * w_:(i + 1) * w_] for i in range(n_)),
                    range(p, p + n_), col_items[p - col_pos0:
                                                p - col_pos0 + n_]))
                p += n_
            col_arrs, col_items, col_pos0 = [], [], 0

        writer = AsyncWriter(
            "em_sort.spill",
            tracer=getattr(self.context.mesh_exec, "tracer", None))

        def _widen_concat(arrs):
            """One S-w key array of batches of several widths (str
            batches pad to their own longest): zero pads keep the order
            (``order_key.make_array_batch_encoder``)."""
            W_ = max(a.dtype.itemsize for a in arrs)
            for j, a in enumerate(arrs):
                w_ = a.dtype.itemsize
                if w_ != W_:
                    buf = np.zeros((len(a), W_), np.uint8)
                    buf[:, :w_] = a.view(np.uint8).reshape(len(a), w_)
                    arrs[j] = buf.reshape(-1).view(f"S{W_}")
            return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)

        def _columnar_job(arrs, items_, p0, slot, meta=None):
            def job():
                b0 = pool.bytes_put
                arr = _widen_concat(arrs)
                order = np.argsort(arr)
                f = File(pool=pool)
                with f.writer() as w:
                    for i in order.tolist():
                        w.put((p0 + i, items_[i]))
                kf = File(pool=pool)
                native_merge.write_key_chunks_fixed(kf, arr[order])
                files[slot] = f
                key_files[slot] = kf
                if meta is not None:
                    run_store.submit_commit(slot, *meta, f, kf)
                return pool.bytes_put - b0
            return job

        def _records_job(arrs, items_, p0, slot, meta=None):
            """The whole encode in the job: payload columns, the memcmp
            argsort, the gather of positions and payload into blocks (the
            native calls release the GIL). A failed encode (a schema
            deviation inside the run, an injected
            ``data.records.encode``) takes the per-item pickle path on
            the same data: slower, never wrong."""
            def job():
                b0 = pool.bytes_put
                arr = _widen_concat(arrs)
                order = native_records.argsort_rows(arr)
                f = File(pool=pool)
                enc_ = None
                try:
                    enc_ = rec_enc(items_)
                    if enc_ is not None:
                        native_records.write_run_blocks(
                            f, order, p0, enc_[1], enc_[0], f.block_items)
                except Exception as e:
                    faults.note("recovery",
                                what="records.encode_degraded",
                                error=repr(e)[:200])
                    f.clear()
                    f = File(pool=pool)
                    enc_ = None
                if enc_ is None:
                    with f.writer() as w:
                        for i in order.tolist():
                            w.put((p0 + i, items_[i]))
                kf = File(pool=pool)
                native_merge.write_key_chunks_fixed(
                    kf, native_records.gather_rows(arr, order))
                files[slot] = f
                key_files[slot] = kf
                if meta is not None:
                    run_store.submit_commit(slot, *meta, f, kf)
                return pool.bytes_put - b0
            return job

        def _encoded_job(this_run, slot, meta=None):
            def job():
                b0 = pool.bytes_put
                this_run.sort()          # kb unique (pos suffix)
                f = File(pool=pool)
                with f.writer() as w:
                    for kb, p, it in this_run:
                        w.put((p, it))
                kf = File(pool=pool)
                native_merge.write_key_chunks(kf, [t[0] for t in this_run])
                files[slot] = f
                key_files[slot] = kf
                if meta is not None:
                    run_store.submit_commit(slot, *meta, f, kf)
                return pool.bytes_put - b0
            return job

        def _generic_job(this_run, slot, meta=None):
            def job():
                b0 = pool.bytes_put
                f = _spill_run(pool, this_run, pair_key)
                files[slot] = f
                if meta is not None:
                    run_store.submit_commit(slot, *meta, f, None)
                return pool.bytes_put - b0
            return job

        def spill():
            nonlocal run
            if col_items and run:
                decolumnize()           # a mixed run: one representation
            slot = len(files)
            files.append(None)
            key_files.append(None)
            meta = None
            if run_store is not None:
                # the run's identity in arrival order, before its job
                # sorts anything: (pos0, n, first item's fingerprint)
                if col_items:
                    p0, n_, first = col_pos0, len(col_items), col_items[0]
                elif enc is not None:
                    p0, n_, first = run[0][1], len(run), run[0][2]
                else:
                    p0, n_, first = run[0][0], len(run), run[0][1]
                meta = (p0, n_, em_runs.fingerprint(first))
                got = run_store.try_load(slot, *meta, pool,
                                         DEFAULT_BLOCK_ITEMS)
                if got is not None:
                    # a run the previous launch committed: its blocks
                    # stand in for the sort, serialize and write
                    files[slot], key_files[slot] = got
                    _IOSTATS.add(runs_reused=1)
                    col_arrs.clear()
                    col_items.clear()
                    run = []
                    return
            _IOSTATS.add(spill_runs=1)
            if col_items:
                job = (_records_job if rec_enc is not None
                       else _columnar_job)
                writer.submit(job(list(col_arrs), list(col_items),
                                  col_pos0, slot, meta), tag=slot)
                col_arrs.clear()
                col_items.clear()
            elif enc is not None:
                writer.submit(_encoded_job(run, slot, meta), tag=slot)
            else:
                writer.submit(_generic_job(run, slot, meta), tag=slot)
            run = []

        def demote():
            """A schema deviation: strip the key bytes from the live run
            and stop encoding; the spilled runs stay as they are."""
            nonlocal enc, enc_state, enc_arr, run
            enc, enc_state, enc_arr = None, "off", None
            if col_items:
                run.extend(zip(range(col_pos0, col_pos0 + len(col_items)),
                               col_items))
                col_arrs.clear()
                col_items.clear()
            else:
                run = [(p, it) for _kb, p, it in run]

        def append_batch(batch):
            """One vectorized encode (or one listcomp) and one reservoir
            call a batch."""
            nonlocal enc, enc_state, enc_arr, pos, col_pos0
            nonlocal rec_probe, rec_enc
            if enc_state == "probe" and batch:
                enc = order_key.make_batch_encoder(sort_key(batch[0]))
                enc_state = "on" if enc is not None else "off"
                if enc is not None:
                    enc_arr = order_key.make_array_batch_encoder(
                        sort_key(batch[0]))
            if rec_probe == "probe" and batch:
                rec_probe = "done"
                rec_enc = native_records.make_run_encoder(batch[0])
            if enc is not None:
                keys = list(map(sort_key, batch))
                try:
                    arr = None
                    if enc_arr is not None and not run:
                        arr = enc_arr(keys, pos)
                    if arr is not None:
                        if not col_items:
                            col_pos0 = pos
                        col_arrs.append(arr)
                        col_items.extend(batch)
                    else:
                        if col_items:
                            decolumnize()
                        # every key encoded before `run` is touched: a
                        # deviation mid-batch leaves nothing half done
                        kbs = enc(keys, range(pos, pos + len(batch)))
                        run.extend(zip(kbs, range(pos, pos + len(batch)),
                                       batch))
                except order_key.BATCH_ENCODE_ERRORS:
                    demote()
                    run.extend(zip(range(pos, pos + len(batch)), batch))
            else:
                run.extend(zip(range(pos, pos + len(batch)), batch))
            sampler.add_batch_indexed(pos, batch)
            pos += len(batch)

        # one RSS check a batch keeps the grant's feedback prompt however
        # large the run
        MAX_BATCH = 1 << 16
        t_phase0 = time.perf_counter()
        ra = None
        try:
            for lst in shards.lists:
                idx = 0
                while idx < len(lst):
                    take = min(run_size - run_len(), len(lst) - idx,
                               MAX_BATCH)
                    append_batch(lst[idx:idx + take])
                    idx += take
                    if run_len() >= run_size or \
                            (budget.exceeded_now() and run_len() >= 16):
                        spill()
                        budget.reset()
                if owns_input:
                    lst.clear()
            if run_len():
                spill()
            # every run written (a writer error raises here, before the
            # merge reads a run), every run's commit joined, then the
            # store's own spills settled
            writer.flush()
            if run_store is not None:
                run_store.drain()
            pool.flush()
            t_phase1 = time.perf_counter()

            # the merge's readahead: the planner's learned depth of the
            # site, an io_prefetch decision audited by the hit rate
            from ...common.decisions import record_of, resolve_io_prefetch
            from ..planner import planner_of
            mex = self.context.mesh_exec
            depth = prefetch_depth()
            pl = planner_of(mex)
            if pl is not None:
                depth = pl.io_prefetch_depth("em_sort.merge", depth)
            rec = record_of(mex, "io_prefetch", "em_sort.merge",
                            f"depth={depth}", predicted=1.0,
                            reason="readahead hit-rate target",
                            runs=len(files), depth=depth)
            ra = make_readahead(depth)
            submit = ra.submit if ra is not None else None
            io_merge0 = _IOSTATS.snapshot()
            samples = sorted(sampler.samples, key=pair_key)
            sample_at = [min(len(samples) - 1, (j * len(samples)) // W)
                         for j in range(1, W)] if samples else []
            out: List[list] = [[] for _ in range(W)]
            w = 0
            if enc is not None and all(kf is not None for kf in key_files):
                # the splitters' key bytes ride as one more merge run: the
                # partition advances when one pops
                split_kb = [enc([sort_key(samples[i][1])],
                                [samples[i][0]])[0] for i in sample_at]
                native_merge.merge_partitioned(files, key_files, split_kb,
                                               out, consume=True,
                                               submit=submit)
            else:
                split_keys = [pair_key(samples[i]) for i in sample_at]
                for t in multiway_merge_files(files, key=pair_key,
                                              consume=True, submit=submit):
                    k = pair_key(t)
                    while w < len(split_keys) and k > split_keys[w]:
                        w += 1
                    out[w].append(t[1])

            io_all = _IOSTATS.delta(_IOSTATS.snapshot(), io_base)
            io_merge = _IOSTATS.delta(_IOSTATS.snapshot(), io_merge0)
            resolve_io_prefetch(mex, rec, io_merge)
            self._em_stats = {
                "runs": len(files),
                "engine": "native" if enc is not None else "py",
                "records_blocks": io_all.get("records_blocks", 0),
                "runs_reused": io_all.get("runs_reused", 0),
                "spill_s": round(t_phase1 - t_phase0, 3),
                "merge_s": round(time.perf_counter() - t_phase1, 3),
                "overlap_frac": round(overlap_frac(io_all), 3),
                "io_wait_s": io_all["io_wait_s"],
                "io_busy_s": io_all["io_busy_s"],
                "prefetch_hit_rate": round(hit_rate(io_merge), 3),
                "writeback_bytes": writer.bytes_written,
                "writeback_sync": writer.sync}
            log = self.context.logger
            if log.enabled:
                log.line(event="writeback", what="em_sort.spill",
                         bytes=writer.bytes_written,
                         jobs=writer.jobs_run, sync=writer.sync)
                log.line(event="prefetch", what="em_sort.merge",
                         hits=io_merge["prefetch_hits"],
                         misses=io_merge["prefetch_misses"],
                         wait_s=io_merge["io_wait_s"], depth=depth)
        finally:
            writer.close(drain=False)
            if run_store is not None:
                run_store.close()
            if ra is not None:
                ra.shutdown(wait=True, cancel_futures=True)
            for f in files + key_files:
                if f is not None:
                    f.clear()
            pool.close()
        return out


def _device_sample_sort(shards: DeviceShards,
                        key_fn: Callable) -> DeviceShards:
    mex = shards.mesh_exec
    W, cap = mex.num_workers, shards.cap
    leaves, treedef = pt.flatten(shards.tree)
    if shards.total == 0:
        return shards
    if W == 1:
        # a CPU mesh: the native stable radix sort (the reference's
        # in-RAM run sort engine class, Thrill's api/sort.hpp)
        full = bool(np.all(shards.counts == cap))
        out = _host_radix_w1(mex, shards, key_fn, leaves, treedef, full)
        if out is not None:
            return out
    counts = shards.counts_device()
    # across processes: every worker's counts, the local workers' offsets
    gcounts = shards.global_counts
    lo, Wl = mex.worker_base, mex.num_local
    offsets = np.concatenate([[0], np.cumsum(gcounts)])[lo:lo + Wl]
    # every shard full: the validity word is dropped (the common case
    # after Distribute/Generate)
    full = bool(np.all(gcounts == cap))
    if W == 1:
        # one worker: key argsort and one payload gather, no exchange
        prog = mex.program(("sort_w1", key_fn), _sort_w1)
        out, _ = prog(shards.tree, shards.valid_mask(), key_fn,
                      mex.radix_passes, validity=not full)
        return DeviceShards(mex, out, shards.counts.copy())

    passes = mex.radix_passes
    # ---- phase 1: key argsort + quantile samples (no payload) ---------
    keys = mex.program(("sort_keys", key_fn, full), _sort_keys_prog)
    words_s, gidx_s, perm, s_words, s_idx, s_valid = keys(
        shards.tree, counts, mex.put_small(offsets.astype(np.int64)),
        key_fn, full, passes)
    nwords = words_s.shape[2]

    # ---- host: choose splitters (the "worker 0" step) -----------------
    splitters = device_splitters(
        mex, host_samples(mex, s_words, s_idx, s_valid), W, nwords + 1)

    # ---- phase 2: classify sorted keys + the one payload gather -------
    # the narrowing's range analysis of the generic path's carrier rides
    # this program (the rows are here already)
    carrier_sig = [words_s, gidx_s] + list(leaves)
    nidx = exchange.presorted_range_leaves(mex, cap, carrier_sig)
    classify = mex.program(("sort_classify", key_fn, nidx),
                           _sort_classify_prog)
    out2 = classify(splitters, words_s, gidx_s, perm, counts, leaves, nidx)
    dest, send_mat, payload = out2[0], out2[1], list(out2[2])
    S = mex.fetch_global(send_mat).astype(np.int64)
    row_bytes = exchange.leaf_item_bytes(payload) + 8 * (nwords + 1)
    # the fused ship-and-merge runs exactly when the generic exchange
    # would take the dense plan; THRILL_TPU_SORT_FUSED=0 forces the
    # generic path
    if os.environ.get("THRILL_TPU_SORT_FUSED", "1") != "0" and \
            exchange.dense_all_to_all_applies(mex, S, row_bytes):
        cap_ident = ("sort_fused_caps", key_fn, cap, nwords, treedef,
                     exchange._leaf_sig(payload))
        out = _fused_exchange_merge(mex, dest, words_s, gidx_s, payload,
                                    S, cap_ident, key_fn)
        return DeviceShards(mex, pt.unflatten(treedef, out),
                            S.sum(axis=0)[lo:lo + Wl])
    # the planned exchange of (words, global index, payload) rows, then
    # one merge of each receiver's runs
    carrier = [words_s, gidx_s] + payload
    ranges = exchange.fetch_ranges(mex, out2[3]) if nidx else None
    got = exchange.exchange_presorted(
        mex, pt.flatten(carrier)[1], dest, carrier, S,
        ident=("sort_x", key_fn), ranges=ranges)
    final = mex.program(("sort_final", key_fn), _sort_final_prog)
    out = final(got.tree, got.counts_device(), passes)
    return DeviceShards(mex, pt.unflatten(treedef, out), got.counts_like())


def _host_radix_w1(mex, shards: DeviceShards, key_fn: Callable, leaves,
                   treedef, full: bool) -> Optional[DeviceShards]:
    """The W == 1 sort on a CPU mesh through the native stable LSD radix
    engine (``core/host_radix.py``; reference:
    ``thrill_tpu/api/ops/sort.py:952-985``), or None where it does not
    apply (another device, the library missing, a key_fn that fails on
    these columns). Stability keeps equal keys in input order, so no
    index word breaks ties; the validity word leads when the shard is
    not full, so its padding rows sort last."""
    from ...core import host_radix

    if not host_radix.eligible(mex):
        return None
    cap = shards.cap
    count = int(shards.counts[0])
    cols = [l[0] for l in leaves]                        # [cap, ...]
    try:
        words = keymod.encode_key_words(key_fn(pt.unflatten(treedef,
                                                            cols)))
    except Exception:
        return None
    if not full:
        words = [(np.arange(cap) >= count).astype(np.uint64)] + words
    perm = host_radix.radix_argsort(words)
    out = [mex.bless(torch.from_numpy(host_radix.gather_rows(
        np.ascontiguousarray(mex.host_view(c)), perm))[None]) for c in cols]
    return DeviceShards(mex, pt.unflatten(treedef, out),
                        shards.counts.copy())


def _sort_keys_prog(tree, counts: torch.Tensor, offsets: torch.Tensor,
                    key_fn: Callable, full: bool, passes: list):
    """Program ``sort_keys``: each worker's argsort of ((invalid,) key
    words, global index) and its OVERSAMPLE quantile samples. Returns
    (sorted words ``[W, cap, nw]``, sorted global index, the permutation,
    sample words ``[W, S, nw]``, sample index, sample validity)."""
    W, cap = pt.leaves(tree)[0].shape[:2]
    dev = counts.device
    ar = torch.arange(cap, device=dev)
    words = keymod.worker_key_words(key_fn, tree)
    nwords = len(words)
    lead, lead_bits = [], []
    if not full:
        lead = [(ar[None, :] >= counts[:, None]).to(torch.int64)]
        lead_bits = [VALID_BITS]
    gidx = offsets[:, None] + ar[None, :]
    perm = argsort_words(lead + words + [gidx],
                         lead_bits + [64] * (nwords + 1), passes=passes)
    words_s = torch.stack([torch.gather(w, 1, perm) for w in words], dim=2)
    gidx_s = torch.gather(gidx, 1, perm)
    qpos = quantile_positions(counts, cap)                    # [W, S]
    return (words_s, gidx_s, perm, take_rows(words_s, qpos),
            torch.gather(gidx_s, 1, qpos), qpos < counts[:, None])


def _sort_classify_prog(splitters: torch.Tensor, words_s: torch.Tensor,
                        gidx_s: torch.Tensor, perm: torch.Tensor,
                        counts: torch.Tensor, leaves: list, nidx: tuple):
    """Program ``sort_classify``: each sorted item's destination (its
    rank among the splitters; ``W`` for the padding), the send matrix
    (the histogram kernel), the one payload gather and, for leaves
    ``nidx`` of the carrier (words, global index, payload), their
    ranges."""
    Wl, cap = gidx_s.shape
    W = splitters.shape[0] + 1               # every worker, W > 1
    valid = (torch.arange(cap, device=gidx_s.device)[None, :]
             < counts[:, None])              # sorted: the valid rows first
    d = torch.zeros((Wl, cap), dtype=torch.int32, device=gidx_s.device)
    for j in range(W - 1):
        d += _lex_greater(words_s, gidx_s, splitters[j]).to(torch.int32)
    dest = torch.where(valid, d, torch.full_like(d, W))
    payload = take_rows_multi(leaves, perm)
    out = (dest, exchange.send_counts(dest, W), payload)
    if nidx:
        carrier = [words_s, gidx_s] + list(payload)
        out = out + (exchange.leaf_ranges_traced(
            [carrier[i] for i in nidx], valid),)
    return out


def _sort_final_prog(tree, counts: torch.Tensor, passes: list):
    """Program ``sort_final`` (the generic path): merge each receiver's
    runs of (words, global index, payload) rows."""
    rl = pt.leaves(tree)
    cap = rl[1].shape[1]
    valid = (torch.arange(cap, device=counts.device)[None, :]
             < counts[:, None])
    return merge_blocks(passes, [(valid, rl[0], rl[1], rl[2:])], cap)


def _sort_w1(tree, valid: torch.Tensor, key_fn: Callable, passes: list,
             validity: bool):
    """One worker's sort: an argsort of ((invalid,) key words, row) and
    one payload gather; returns (tree, ``[1]`` valid count). The
    validity word is left out when every row is valid."""
    cap = valid.shape[1]
    words = keymod.worker_key_words(key_fn, tree)
    lead = [(~valid).to(torch.int64)] if validity else []
    lead_bits = [VALID_BITS] if validity else []
    iota = torch.arange(cap, device=valid.device)[None, :].clone()
    perm = argsort_words(lead + words + [iota],
                         lead_bits + [64] * (len(words) + 1), passes=passes)
    leaves, treedef = pt.flatten(tree)
    return (pt.unflatten(treedef, take_rows_multi(leaves, perm)),
            valid.sum(dim=1))


def host_samples(mex, s_words: torch.Tensor, s_idx: torch.Tensor,
                 s_valid: torch.Tensor, tag: tuple = ()) -> list:
    """The valid quantile samples on the host: tuples of (key words as
    unsigned ints, ``*tag``, global index), so that Python's tuple order
    is the unsigned order of the words (C1). ``s_words`` ``[W, S, nw]``,
    ``s_idx`` and ``s_valid`` ``[W, S]``."""
    _, S, nwords = s_words.shape
    # every worker's samples, every process's across processes
    sw = mex.fetch_global(s_words).view(np.uint64).reshape(-1, nwords)
    si = mex.fetch_global(s_idx).reshape(-1)
    sv = mex.fetch_global(s_valid).reshape(-1)
    return [tuple(int(x) for x in sw[i]) + tag + (int(si[i]),)
            for i in range(len(sv)) if sv[i]]


def device_splitters(mex, samples: list, W: int,
                     ncols: int) -> torch.Tensor:
    """W-1 splitters of the sample tuples, on the device as int64 bit
    patterns ``[max(W-1, 1), ncols]``."""
    return mex.put_small(choose_splitters(sorted(samples), W, ncols).view(
        np.int64))


def merge_blocks(passes: list, blocks, out_cap: int) -> List[torch.Tensor]:
    """Merge each worker's sorted runs with one argsort and one payload
    gather. ``blocks`` holds per input (valid ``[W, n]``, key words ``[W,
    n, nw]``, global index ``[W, n]``, payload leaves ``[W, n, ...]``);
    the argsort is of (invalid, key words, input index where there are
    several inputs, global index), so equal keys order by input, then by
    original position. ``passes`` collects the radix engine's passes.
    Returns the payload leaves ``[W, out_cap, ...]``; rows past the
    counts are invalid rows, repeated where ``out_cap`` passes the
    blocks' width."""

    def cat(xs):
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)

    valid, words, gidx = (cat([b[i] for b in blocks]) for i in range(3))
    W = valid.shape[0]
    payload = [cat(list(ls)) for ls in zip(*(b[3] for b in blocks))]
    nwords = words.shape[2]
    sort_words = ([(~valid).to(torch.int64)]
                  + [words[:, :, k].contiguous() for k in range(nwords)])
    bits = [VALID_BITS] + [64] * nwords
    if len(blocks) > 1:
        sort_words.append(cat([torch.full(b[2].shape, i, dtype=torch.int64,
                                          device=gidx.device)
                               for i, b in enumerate(blocks)]))
        bits.append(len(blocks).bit_length())
    perm = argsort_words(sort_words + [gidx], bits + [64], passes=passes,
                         record=False)
    if out_cap > perm.shape[1]:
        perm = torch.cat([perm, perm[:, -1:].expand(
            W, out_cap - perm.shape[1])], dim=1)
    return take_rows_multi(payload, perm[:, :out_cap])


def _sort_fused_prog(dest: torch.Tensor, S_dev: torch.Tensor,
                     S_col: torch.Tensor, words_s: torch.Tensor,
                     gidx_s: torch.Tensor, payload: list, M_pad: int,
                     out_cap: int, passes: list) -> List[torch.Tensor]:
    """Program ``sort_fused``: ship every leaf of the classified rows
    into ``[W, W * M_pad]`` receive blocks (one slot index for all) and
    merge each receiver's W runs straight from them (``S_col`` is the
    send matrix's transpose: each receiver's row of run lengths)."""
    Wl, cap = dest.shape
    W = S_dev.shape[0]
    send_idx = exchange.send_slot_index(dest, S_dev, W, M_pad, cap)

    def ship(x):
        return exchange.ship_blocks(x, send_idx, W, M_pad)

    j = torch.arange(M_pad, device=dest.device)
    # receiver w's run from sender s holds S[s, w] rows (the local
    # receivers' across processes)
    mex = current_mex()
    b = mex.worker_base if mex is not None else 0
    valid = (j[None, None, :] < S_col[b:b + Wl, :, None]).reshape(
        Wl, W * M_pad)
    return merge_blocks(passes, [(valid, ship(words_s), ship(gidx_s),
                                  [ship(p) for p in payload])], out_cap)


def _fused_exchange_merge(mex, dest, words_s, gidx_s, payload,
                          S: np.ndarray, cap_ident,
                          token=None) -> List[torch.Tensor]:
    """Ship the classified rows and merge each receiver's W runs straight
    from the shipped blocks, with no compaction gather: the plan from
    the host send matrix, then one program (:func:`_sort_fused_prog`).
    Returns the payload leaves ``[W, out_cap, ...]``, the site's sticky
    output capacity."""
    (S_dev, S_col), M_pad, out_cap = exchange.plan_presorted(
        mex, S, exchange.leaf_item_bytes(payload)
        + 8 * (words_s.shape[2] + 1), cap_ident)
    prog = mex.program(("sort_fused", token, M_pad, out_cap),
                       _sort_fused_prog)
    with span_of(mex.tracer, "exchange", "sort_fused", m_pad=M_pad,
                 out_cap=out_cap):
        return prog(dest, S_dev, S_col, words_s, gidx_s, payload, M_pad,
                    out_cap, mex.radix_passes)


def Sort(dia: DIA, key_fn=None, compare_fn=None) -> DIA:
    return DIA(SortNode(dia.context, dia._link(), key_fn, compare_fn))


def _spill_run(pool, run, sort_key):
    """One run of (pos, item) pairs sorted by ``sort_key`` into a File."""
    from ...data.file import File
    run.sort(key=sort_key)
    f = File(pool=pool)
    with f.writer() as w:
        for it in run:
            w.put(it)
    return f
