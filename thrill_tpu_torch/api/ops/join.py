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

On host storage (either side; device items of a mixed pair are demoted)
each item's key is hashed once with ``stable_host_hash``; the location
filter keeps the items whose truncated hash the other side holds; both
sides go to worker ``hash % W``, and each worker joins in a dict of its
left items by key. A dense right table is enumerated by its dense
positions.

Hinted join (``out_size_hint``, reference:
``thrill_tpu/api/ops/join.py:263-495, 626-743``): the output is sized
from the hint instead of the host sync of the totals, and the true
totals stay on the device. Stitched (api/fusion.py), both phases are the
head of a plan, so downstream ops run in the same program, and the
totals ride out as an aux output; per op (``THRILL_TPU_FUSE=0``) the
output's counts are the device totals. Either way a deferred check
attaches to the output: it runs when the counts first reach the host,
when a consumer pulls the shards, or at the next fetch, whichever comes
first, and before anything reads the columns. On an overflow (a worker
made more pairs than the hint's power of two) the join runs again at the
true capacity, from its lineage (the plan's sources, or the sorted sides
of phase 1), and heals the shards in place (``join_overflow_retries``;
the governor re-accounts a cached result that grew);
``THRILL_TPU_JOIN_RECOVER=0`` raises instead, and every later check
raises again. A dense-index join stitches as a plan head too.

Across processes (a mesh of several processes) the location filter's
u8 registers are max-folded over every process (``mesh.worker_max``),
the output capacity and the healed capacity are the largest of every
worker's totals, the cost model's verdict is process 0's, and the dense
join gathers every process's rows of the table.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ...common import faults, hashing
from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...core import keys as keymod
from ...core import preshuffle
from ...core import segmented
from ...core.location_detection import _MASK, LocationDetection
from ...core.device_sort import argsort_words
from ...core.pallas_kernels import presence_fill
from ...core.rowmove import row_cumsum, scatter_slots, take_rows
from ...data import exchange, multiplexer
from ...data.shards import (DeviceShards, HostShards, compact_valid,
                            round_up_pow2)
from ...mem.hbm import device_bytes
from ...parallel.mesh import current_mex, worker_max
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

    def compute_plan(self):
        """Hinted and dense-index joins stitch: their head traces into
        the consumer's program. An unhinted join needs the host totals,
        a barrier, and stays on the per-op path."""
        from .. import fusion
        if not fusion.enabled() or (self.out_size_hint is None
                                    and self.dense_right_index is None):
            return None
        left = self.parents[0].pull()
        right = self.parents[1].pull()
        if isinstance(left, HostShards) or isinstance(right, HostShards):
            return fusion.wrap(self._compute_host(left, right))
        if self.dense_right_index is not None:
            self._check_dense(right, fetch=False)
            head = self._dense_head(right.cap)
            if right._counts_host is None:
                # device counts: checked when the output's counts reach
                # the host or a consumer pulls it, not mid-chain
                head.finalize = lambda plan, out, rc=right._counts_dev: \
                    self._attach_dense_check(out, rc)
            return fusion.FusionPlan(left.mesh_exec, [left, right],
                                     head=head)
        left, right = self._prep_device(left, right)
        return self._fused_plan(left, right)

    def compute(self):
        plan = self.compute_plan()
        if plan is not None:
            return plan.finish()
        left = self.parents[0].pull()
        right = self.parents[1].pull()
        if isinstance(left, HostShards) or isinstance(right, HostShards):
            return self._compute_host(left, right)
        if self.dense_right_index is not None:
            return self._compute_dense(left, right)
        left, right = self._prep_device(left, right)
        if self.out_size_hint is not None:
            return self._hinted(left, right)
        return _sort_merge(left, right, self.lkey, self.rkey, self.join_fn)

    # -- hinted join ---------------------------------------------------------
    def _fused_plan(self, left: DeviceShards,
                    right: DeviceShards) -> "FusionPlan":
        """Both phases as one head segment at the hint's capacity; the
        true per-worker totals are an aux output for the deferred check
        (reference: ``thrill_tpu/api/ops/join.py:378-426``)."""
        from .. import fusion
        mex = left.mesh_exec
        lkey, rkey, jfn = self.lkey, self.rkey, self.join_fn
        node = self

        def make_head(cap_: int) -> fusion.Segment:
            def trace(fctx, states, _bound):
                (ltree, lmask), (rtree, rmask) = states
                ltree_s, rtree_s, lo, matches = _join_phase1(
                    ltree, lmask, rtree, rmask, lkey, rkey)
                totals = matches.sum(dim=1)
                fctx.emit_aux("join_totals", totals)
                out = _join_expand(ltree_s, rtree_s, lo, matches, cap_, jfn)
                return out, (torch.arange(cap_, device=lmask.device)[None, :]
                             < totals[:, None])

            def finalize(plan, out):
                node._attach_check(mex, out, cap_,
                                   lambda c: plan.reexecute(c),
                                   plan.aux["join_totals"], fused=True)

            return fusion.Segment(label="InnerJoin",
                                  token=("join_fused",
                                         (lkey, rkey, jfn), cap_),
                                  trace=trace, already_compact=True,
                                  refit=make_head, finalize=finalize,
                                  dia_id=node.id)

        cap = round_up_pow2(max(int(self.out_size_hint), 1))
        return fusion.FusionPlan(mex, [left, right], head=make_head(cap))

    def _hinted(self, left: DeviceShards,
                right: DeviceShards) -> DeviceShards:
        """The per-op hinted join: phase 1, phase 2 at the hint's
        capacity, counts the device totals, the check deferred; its
        recovery runs phase 2 again from phase 1's sorted sides."""
        mex = left.mesh_exec
        p1 = mex.program(("join_count", (self.lkey, self.rkey)),
                         _join_phase1)
        ltree_s, rtree_s, lo, matches = p1(
            left.tree, left.valid_mask(), right.tree, right.valid_mask(),
            self.lkey, self.rkey)
        totals = matches.sum(dim=1)
        jfn = self.join_fn

        def expand(cap_: int):
            p2 = mex.program(("join_expand", jfn), _join_expand)
            return p2(ltree_s, rtree_s, lo, matches, cap_, jfn)

        cap = round_up_pow2(max(int(self.out_size_hint), 1))
        out = DeviceShards(mex, expand(cap), totals)

        def heal(true_cap: int) -> DeviceShards:
            return DeviceShards(mex, expand(true_cap), totals)

        self._attach_check(mex, out, cap, heal, totals, fused=False)
        return out

    def _attach_check(self, mex, out: DeviceShards, cap: int, heal,
                      totals_dev: torch.Tensor, fused: bool) -> None:
        """The deferred overflow check on ``out`` (reference:
        ``thrill_tpu/api/ops/join.py:428-518, 626-743``). It is sticky:
        once it raised, every later check raises again. Each device
        reference it holds is dropped as soon as it is resolved, so a
        check left in the mesh's queue pins nothing."""
        hint = self.out_size_hint
        label, dia_id = self.label, self.id
        hbm = self.context.hbm
        state = {"ok": False, "err": None, "heal": heal, "out": out,
                 "totals": totals_dev}

        def resolve() -> None:
            state["ok"] = state["err"] is None
            state["heal"] = state["out"] = state["totals"] = None

        def validate(_counts):
            if state["err"] is not None:
                raise state["err"]
            if state["ok"]:
                return None
            totals = mex._fetch_raw(state["totals"]).reshape(-1).astype(
                np.int64)
            # every process's worst: the healed capacity is one capacity
            worst = int(mex.gather_host(totals).max(initial=0))
            if worst <= cap:
                resolve()
                return None
            if os.environ.get("THRILL_TPU_JOIN_RECOVER", "1") == "0":
                state["err"] = ValueError(
                    f"InnerJoin out_size_hint={hint} (cap {cap}) "
                    f"overflowed: a worker produced {worst} pairs; "
                    f"results were truncated; raise the hint or drop it")
                resolve()
                raise state["err"]
            true_cap = round_up_pow2(max(worst, 1))
            o, heal_ = state["out"], state["heal"]
            # resolved first: a drain started inside the re-run must see
            # no pending recovery
            resolve()
            healed = heal_(true_cap)
            o.tree = healed.tree
            o._counts_dev = healed._counts_dev
            new_counts = mex._fetch_raw(healed._counts_dev).reshape(
                -1).astype(np.int64)
            mex.stats_join_overflow_retries += 1
            # a node that cached these shards had them accounted at the
            # hint's size: re-account the healed bytes (no spill from in
            # here: the check runs inside arbitrary frames)
            for n in list(hbm._lru.values()):
                if n._shards is o and getattr(n, "_hbm_bytes", 0):
                    nb = device_bytes(o)
                    hbm.mem.subtract(n._hbm_bytes)
                    n._hbm_bytes = nb
                    hbm.mem.add(nb)
                    break
            faults.note("recovery", what="join_out_size_hint", node=label,
                        dia_id=dia_id, hint=int(hint), true_max=worst,
                        new_cap=true_cap, fused=fused)
            return new_counts

        out._counts_check = validate

        def pending_check() -> None:
            if state["err"] is not None:
                raise state["err"]
            if state["ok"]:
                return
            o = state["out"]
            fixed = validate(None)
            if fixed is not None and o._counts_host is None:
                o._counts_host = fixed
            o._counts_check = None

        mex._pending_checks.append(pending_check)

    # -- host path ---------------------------------------------------------
    def _compute_host(self, left, right) -> HostShards:
        """Reference: ``thrill_tpu/api/ops/join.py:89-206``."""
        if isinstance(left, DeviceShards):
            left = left.to_host_shards("join-host-path")
        if isinstance(right, DeviceShards):
            right = right.to_host_shards("join-host-path")
        W = left.num_workers
        mex = self.context.mesh_exec
        lkey, rkey, jfn = self.lkey, self.rkey, self.join_fn
        if self.dense_right_index is not None:
            # the right key is the row's dense position: worker w's first
            # row sits at dense_range_bounds[w] by the contract
            bounds = dense_range_bounds(self.dense_right_index, W).tolist()
            right = HostShards(W, [[(bounds[w] + i, it)
                                    for i, it in enumerate(items)]
                                   for w, items in enumerate(right.lists)])
            rkey = _enum_key
            inner = jfn
            jfn = lambda l, r: inner(l, r[1])  # noqa: E731
        lh = [[hashing.stable_host_hash(_h(lkey(it))) for it in l]
              for l in left.lists]
        rh = [[hashing.stable_host_hash(_h(rkey(it))) for it in l]
              for l in right.lists]
        ld = self.location_detection
        if ld is None:
            ld = preshuffle.auto_location_detect(
                mex, left.total + right.total, 32,
                ("join_host", self.lkey, self.rkey), local_rows=True)
        if ld and W > 1:
            # every worker's fingerprint through the Golomb codec, as the
            # reference's location exchange
            # across processes the fingerprints are gathered, so every
            # process finds the same common set (reference:
            # thrill_tpu/api/ops/join.py:143-158)
            lh_all = multiplexer.global_lists(mex, lh)
            rh_all = multiplexer.global_lists(mex, rh)
            ld_l, ld_r = LocationDetection(W), LocationDetection(W)
            for w in range(W):
                ld_l.add_worker(w, lh_all[w])
                ld_r.add_worker(w, rh_all[w])
            common = ld_l.common_hashes(ld_r)
            left, lh = _prune(left, lh, common)
            right, rh = _prune(right, rh, common)

        def shuffle(shards, hs):
            # items travel with their hash
            tagged = HostShards(W, [list(zip(hl, items)) for items, hl
                                    in zip(shards.lists, hs)])
            # matched by key: the arrival order only permutes the
            # output's rows under THRILL_TPU_HOST_MIX=1
            ex = multiplexer.host_exchange(mex, tagged, lambda p: p[0] % W,
                                           reason="join", rank_order=False)
            return [[it for _, it in l] for l in ex.lists]

        out = []
        for litems, ritems in zip(shuffle(left, lh), shuffle(right, rh)):
            table: dict = {}
            for it in litems:
                table.setdefault(_h(lkey(it)), []).append(it)
            out.append([jfn(lt, rt) for rt in ritems
                        for lt in table.get(_h(rkey(rt)), ())])
        return HostShards(W, out)

    # -- sort-merge join -------------------------------------------------
    def _prep_device(self, left: DeviceShards, right: DeviceShards
                     ) -> Tuple[DeviceShards, DeviceShards]:
        """The location filter (by the cost model's verdict unless
        forced), then the hash exchange of both sides."""
        mex = left.mesh_exec
        W = mex.num_workers
        if W == 1:
            return left, right
        token = (self.lkey, self.rkey, self.join_fn)
        ld = self.location_detection
        if ld is None:
            rows, item_bytes = preshuffle.join_rows_estimate(
                left, right, ("join_l", token, W), ("join_r", token, W))
            ld = preshuffle.auto_location_detect(mex, rows, item_bytes,
                                                 ("join_dev", token))
        pre_rows = None
        if ld:
            pre_rows = _host_rows(left), _host_rows(right)
            left, right = _location_filter(left, right, self.lkey,
                                           self.rkey, token)
        left = exchange.exchange(left, _hash_dest(self.lkey, W),
                                 ("join_l", token, W))
        right = exchange.exchange(right, _hash_dest(self.rkey, W),
                                  ("join_r", token, W))
        # the join phases read the columns: heal an optimistic miss here
        left.validate_pending()
        right.validate_pending()
        if pre_rows is not None:
            # teach the site its prune fraction where both counts are
            # already on the host (never adds a sync)
            post = _host_rows(left), _host_rows(right)
            if None not in pre_rows and None not in post:
                preshuffle.record_prune(mex, ("join_dev", token),
                                        pre_rows[0] + pre_rows[1],
                                        post[0] + post[1])
        return left, right

    # -- dense-index join --------------------------------------------------
    def _dense_bounds(self) -> np.ndarray:
        return dense_range_bounds(self.dense_right_index,
                                  self.context.num_workers)

    def _check_dense(self, right: DeviceShards, fetch: bool = True) -> None:
        """The right side must be the dense range split; checked on host
        counts, which ``fetch=False`` (a stitched head) does not fetch
        for."""
        if not fetch and right._counts_host is None:
            return
        expect = np.diff(self._dense_bounds())
        got = right.global_counts
        if not np.array_equal(got, expect):
            raise ValueError(
                f"InnerJoin dense_right_index={self.dense_right_index}: "
                f"right side counts {got.tolist()} do not form "
                f"the dense range split {expect.tolist()}")

    def _attach_dense_check(self, out: DeviceShards,
                            rcounts: torch.Tensor) -> None:
        """The dense-split check of a right side whose counts stayed on
        the device, deferred onto the stitched output (sticky)."""
        mex = out.mesh_exec
        # the local workers' share of the split: each process checks its
        # own counts
        expect = mex.local(np.diff(self._dense_bounds()))
        n = self.dense_right_index
        state = {"err": None, "rc": rcounts, "out": out}

        def validate(_counts):
            if state["err"] is not None:
                raise state["err"]
            if state["rc"] is None:
                return None
            got = mex._fetch_raw(state["rc"]).reshape(-1).astype(np.int64)
            state["rc"] = None
            if not np.array_equal(got, expect):
                state["err"] = ValueError(
                    f"InnerJoin dense_right_index={n}: right side counts "
                    f"{got.tolist()} do not form the dense range split "
                    f"{expect.tolist()}")
                raise state["err"]
            state["out"] = None
            return None

        out._counts_check = validate

        def pending_check() -> None:
            o = state["out"]
            validate(None)
            if o is not None:
                o._counts_check = None

        mex._pending_checks.append(pending_check)

    def _dense_head(self, rcap: int):
        """The gather join as a plan head (reference:
        ``thrill_tpu/api/ops/join.py:306-340``)."""
        from .. import fusion
        n, lkey, jfn = self.dense_right_index, self.lkey, self.join_fn

        def trace(fctx, states, bound_t):
            (ltree, lmask), (rtree, _rmask) = states
            return _dense_rows(ltree, lmask, rtree, bound_t[0], n, lkey, jfn)

        # the bounds reach the program as a bound operand, uploaded before
        # the dispatch: an upload inside it could not go into a CUDA graph
        return fusion.Segment(label="InnerJoin",
                              token=("join_dense",
                                     (self.lkey, self.rkey, jfn), n),
                              trace=trace,
                              bound=(self._dense_bounds().astype(np.int64),),
                              dia_id=self.id)

    def _compute_dense(self, left: DeviceShards,
                       right: DeviceShards) -> DeviceShards:
        """Worker ``w``'s rows of the table lie at ``[w * rcap, w * rcap
        + count)`` of its ``[W * rcap]`` reshape (the reference's
        all_gather); a left key in range picks its row, a key out of
        range gives no pair."""
        self._check_dense(right)
        mex = left.mesh_exec
        prog = mex.program(("join_dense", self.lkey, self.join_fn),
                           _dense_join)
        out, keep, kept = prog(left.tree, left.valid_mask(), right.tree,
                               mex.put_small(self._dense_bounds()),
                               self.dense_right_index, self.lkey,
                               self.join_fn)
        counts = mex.fetch(kept).astype(np.int64)
        # one choice on every process: every worker's counts
        if np.array_equal(mex.gather_host(counts), left.global_counts):
            # every item joined: the rows are in place already
            return DeviceShards(mex, out, counts)
        tree, _ = mex.program(("compact_valid",), compact_valid)(out, keep)
        return DeviceShards(mex, tree, counts)


def _h(k):
    return hashing.hashable(k, nested=False)


def _enum_key(t):
    """Key of a position-enumerated (g, item) pair (dense host path)."""
    return t[0]


def _prune(shards: HostShards, hashes, common):
    """The items (and their hashes) whose truncated hash is in
    ``common``."""
    items, kept = [], []
    for lst, hl in zip(shards.lists, hashes):
        pairs = [(it, h) for it, h in zip(lst, hl) if h & _MASK in common]
        items.append([it for it, _ in pairs])
        kept.append([h for _, h in pairs])
    return HostShards(shards.num_workers, items), kept


def _hash_dest(key_fn: Callable, W: int) -> Callable:
    def dest(tree, mask, widx):
        return hashing.umod(hashing.hash_key_words(
            keymod.worker_key_words(key_fn, tree)), W)
    return dest


def _location_filter_prog(ltree, lcounts: torch.Tensor, rtree,
                          rcounts: torch.Tensor, lkey, rkey, M: int):
    """Program: each side's key hashes, ``umod M``, fill its presence
    registers (kernel ``presence_fill``), ORed over the workers (the
    reference's pmax); a row stays when its register is set on the
    other side. Returns both sides compacted, with ``[W]`` device
    counts."""
    lcap = pt.leaves(ltree)[0].shape[1]
    rcap = pt.leaves(rtree)[0].shape[1]
    dev = lcounts.device
    lvalid = torch.arange(lcap, device=dev)[None, :] < lcounts[:, None]
    rvalid = torch.arange(rcap, device=dev)[None, :] < rcounts[:, None]
    # int64 register ids as umod makes them: the kernel reads them as is
    hl = hashing.umod(hashing.hash_key_words(
        keymod.worker_key_words(lkey, ltree)), M)
    hr = hashing.umod(hashing.hash_key_words(
        keymod.worker_key_words(rkey, rtree)), M)
    pres_l = presence_fill(hl, lvalid, M)
    pres_r = presence_fill(hr, rvalid, M)
    # the u8 registers ORed over every worker, every process's across
    # processes (an all-reduce MAX of a quarter of an i32 sum's bytes)
    mex = current_mex()
    pres_l, pres_r = worker_max(pres_l, mex), worker_max(pres_r, mex)
    ltree, lcount = compact_valid(ltree, lvalid & (pres_r[hl] > 0))
    rtree, rcount = compact_valid(rtree, rvalid & (pres_l[hr] > 0))
    return ltree, lcount, rtree, rcount


def _location_filter(left: DeviceShards, right: DeviceShards, lkey, rkey,
                     token) -> Tuple[DeviceShards, DeviceShards]:
    """Device LocationDetection (reference: LocationDetectionTag) as one
    program (:func:`_location_filter_prog`). The compacted counts stay
    on the device, as the reference's, so the filter adds no host sync;
    the exchanges after it read them with their send matrices. False
    positives cost exchange traffic, never a pair."""
    mex = left.mesh_exec
    M = preshuffle.register_width((left.cap + right.cap)
                                  * mex.num_workers)
    prog = mex.program(("join_ld", token, M), _location_filter_prog)
    ltree, lcount, rtree, rcount = prog(
        left.tree, left.counts_device(), right.tree, right.counts_device(),
        lkey, rkey, M)
    return DeviceShards(mex, ltree, lcount), DeviceShards(mex, rtree,
                                                          rcount)


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


def _dense_rows(ltree, lmask: torch.Tensor, rtree, b: torch.Tensor,
               n: int, lkey, join_fn):
    """The gather join: worker ``w``'s table rows lie at ``[w * rcap, w *
    rcap + count)`` of the right side's ``[W * rcap]`` reshape (the
    reference's all_gather); a left key in ``[0, n)`` picks its row.
    Returns (join_fn's output ``[W, lcap, ...]``, ``[W, lcap]`` mask of
    the valid lefts with a key in range)."""
    Wl, lcap = lmask.shape
    W = b.shape[0] - 1
    mex = current_mex()
    if mex is not None and mex.multiprocess:
        # every process's rows of the table
        rtree = pt.tree_map(mex.gather_workers, rtree)
    rcap = pt.leaves(rtree)[0].shape[1]
    key = torch.as_tensor(lkey(_flat(ltree)),
                          device=lmask.device).to(torch.int64)
    w = torch.searchsorted(b[1:], key, right=True).clamp(0, W - 1)
    gidx = (w * rcap + key - b[w]).clamp(0, W * rcap - 1)
    rsel = pt.tree_map(lambda l: take_rows(l, gidx).reshape(
        (Wl, lcap) + tuple(l.shape[1:])), _flat(rtree))
    out = call_batched(join_fn, [ltree, rsel], Wl, lcap, lmask.device)
    return out, lmask & ((key >= 0) & (key < n)).reshape(Wl, lcap)


def _dense_join(ltree, lmask: torch.Tensor, rtree, b: torch.Tensor, n: int,
                lkey, join_fn):
    """Program: :func:`_dense_rows` plus each worker's joined rows."""
    out, keep = _dense_rows(ltree, lmask, rtree, b, n, lkey, join_fn)
    return out, keep, keep.sum(dim=1)


def _join_phase1(ltree, lmask: torch.Tensor, rtree, rmask: torch.Tensor,
                 lkey, rkey):
    """Sort both sides by key words and count, for each right item, its
    run of equal valid left keys: (sorted left tree, sorted right tree,
    ``[W, rcap]`` run starts, ``[W, rcap]`` pair counts)."""
    lw = keymod.worker_key_words(lkey, ltree)
    rw = keymod.worker_key_words(rkey, rtree)
    if len(lw) != len(rw):
        raise ValueError(f"InnerJoin: the left key has {len(lw)} key words, "
                         f"the right key {len(rw)}")
    lw, ltree, lvalid = segmented.sort_by_key_words(lw, ltree, lmask)
    rw, rtree, rvalid = segmented.sort_by_key_words(rw, rtree, rmask)
    lo, hi = _run_bounds(lw, lvalid, rw, rvalid)
    matches = torch.where(rvalid, hi - lo, torch.zeros_like(lo))
    return ltree, rtree, lo, matches


def _join_expand(ltree, rtree, lo: torch.Tensor, matches: torch.Tensor,
                 out_cap: int, join_fn):
    """Gather the first ``out_cap`` (left, right) pairs of every worker in
    sorted right order, each right item's lefts in sorted left order, and
    apply ``join_fn`` batched."""
    W, rcap = matches.shape
    lcap = pt.leaves(ltree)[0].shape[1]
    dev = matches.device
    ends = row_cumsum(matches)                                  # [W, rcap]
    p = torch.arange(out_cap, device=dev).expand(W, out_cap).contiguous()
    ridx = torch.searchsorted(ends, p, right=True).clamp(0, rcap - 1)
    starts = ends - matches
    lidx = (torch.gather(lo, 1, ridx) + p
            - torch.gather(starts, 1, ridx)).clamp(0, lcap - 1)
    lsel = pt.tree_map(lambda l: take_rows(l, lidx), ltree)
    rsel = pt.tree_map(lambda l: take_rows(l, ridx), rtree)
    return call_batched(join_fn, [lsel, rsel], W, out_cap, dev)


def _sort_merge(left: DeviceShards, right: DeviceShards, lkey, rkey,
                join_fn) -> DeviceShards:
    """Phase 1 (sort both sides, count pairs per right item), the host
    sync of the per-worker totals, phase 2 (expand the pairs), each
    phase a program."""
    mex = left.mesh_exec
    p1 = mex.program(("join_count", (lkey, rkey)), _join_phase1)
    ltree, rtree, lo, matches = p1(left.tree, left.valid_mask(), right.tree,
                                   right.valid_mask(), lkey, rkey)
    totals = mex.fetch(matches.sum(dim=1)).astype(np.int64)
    # one capacity on every process: every worker's largest total
    out_cap = round_up_pow2(max(int(mex.gather_host(totals).max()), 1))
    p2 = mex.program(("join_expand", join_fn), _join_expand)
    return DeviceShards(mex, p2(ltree, rtree, lo, matches, out_cap, join_fn),
                        totals)


def InnerJoin(left: DIA, right: DIA, left_key_fn, right_key_fn, join_fn,
              location_detection=None, out_size_hint=None,
              dense_right_index=None) -> DIA:
    return DIA(InnerJoinNode(left.context, left._link(), right._link(),
                             left_key_fn, right_key_fn, join_fn,
                             location_detection=location_detection,
                             out_size_hint=out_size_hint,
                             dense_right_index=dense_right_index))


def _host_rows(shards) -> Optional[int]:
    """Global row count when already on the host (no sync), else None."""
    counts = getattr(shards, "_counts_host", None)
    return None if counts is None else int(np.asarray(counts).sum())
