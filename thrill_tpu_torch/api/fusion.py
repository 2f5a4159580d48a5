"""Cross-op program stitching: a chain of device ops runs as one program
(counterpart of the reference package's ``api/fusion.py``).

The Map/Filter/FlatMap stack already runs as one batched program on a
DIA edge; without stitching every device op after it still ran as a
program of its own, and most of them read their counts back to the host
before the next could be queued. A :class:`FusionPlan` is the cross-op
version of the stack: while the pull recursion builds a stage, a chain
of :class:`Segment` functions over one (or, for Zip and InnerJoin heads,
several) source ``DeviceShards`` collects, and the whole chain runs as
ONE call through the mesh's dispatch choke point
(``MeshExec.program``/``dispatch``). Its counts come out as a device
tensor, so no count reaches the host between the ops.

* A fusible op implements ``compute_plan()`` (api/dia_base.py): it
  pulls its parent as a plan, appends its own segment and hands the plan
  on. A parent in state NEW with this pull as its only consumer
  *defers*: its segments run inside the consumer's program
  (``materialize_plan``); anything else materializes and becomes a plan
  source.
* Barriers end a chain: exchanges, host storage, spills, actions, a
  result with several consumers (``Keep``), and every op without a
  segment. The plan runs and its output seeds the next chain.
* Inside a program the state is ``(tree, mask)``: leaves ``[W, n, ...]``
  and a ``[W, n]`` mask of the valid rows, every worker at once as the
  port's batched ops hold them. The valid rows are compacted once, at
  the end (``compact_valid``). Values that the per-op programs took from
  host counts (ZipWithIndex offsets, Window halos) come from the mask
  instead: :meth:`TraceCtx.exclusive_offset` is a cumulative sum over
  the worker dimension, the batched form of the reference's
  ``lax.all_gather``.
* Failures: every segment keeps a fault site of its own
  (``api.fuse.<Op>``), checked before the dispatch under the shared
  retry policy; the dispatch itself carries ``api.mesh.dispatch`` and
  rung 2 of the memory ladder; an OOM that rung 2 cannot cure re-plans
  a row-local chain as :func:`mem.pressure.split_k` row-range
  sub-dispatches (rung 3) or runs it on the host (rung 4). Deferred
  checks (the hinted join's overflow) attach to the program's output
  and drain at the fused boundary (:meth:`FusionPlan.finish`); recovery
  runs the plan again at the true capacity (:meth:`reexecute`).

``THRILL_TPU_FUSE=0`` gives the per-op path exactly. ``stats_fused_
dispatches``/``stats_fused_ops``/``fused_stage_counts`` on the mesh and
``event=fused_dispatch``/``node_fused`` log lines say what was stitched.
The planner's proactive split runs at the stitched dispatch
(``_proactive_split``) and records its decision. Tracing
(common/trace.py): one ``fusion`` span a stitched dispatch, named by its
segments' labels joined with ``+`` (cut to 120 characters) with ``ops``,
holding the dispatch spans; the rung-3/4 degradations are ``mem``
instants ``segment_split`` and ``host_fallback``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..common import decisions as _decisions
from ..common import faults
from ..common import tree as pt
from ..common.retry import default_policy
from ..common.trace import instant_of
from ..data.shards import DeviceShards, HostShards, compact_valid
from .stack import (Stack, apply_stack_device, apply_stack_host_list,
                    apply_stack_traced, stack_bound_operands,
                    stack_cache_token)


def enabled() -> bool:
    """``THRILL_TPU_FUSE=0`` gives the per-op path exactly."""
    return os.environ.get("THRILL_TPU_FUSE", "1") not in ("0", "off",
                                                          "false")


class TraceCtx:
    """What a segment function gets besides its state."""

    def __init__(self, W: int) -> None:
        self.W = W
        self.aux: dict = {}          # name -> [W] extra program output

    @staticmethod
    def count(mask: torch.Tensor) -> torch.Tensor:
        """``[W]`` valid rows of each worker."""
        return mask.sum(dim=1)

    @staticmethod
    def exclusive_offset(mask: torch.Tensor) -> torch.Tensor:
        """``[W]`` int64: the valid rows of the workers before each one,
        the global index of its first valid row (every process's
        workers counted, across processes)."""
        from ..parallel.mesh import current_mex, worker_exscan
        return worker_exscan(mask.sum(dim=1, dtype=torch.int64),
                             current_mex())

    def emit_aux(self, name: str, value: torch.Tensor) -> None:
        """A ``[W]`` value as an extra output of the program (the hinted
        join's true pair totals, for its deferred check)."""
        self.aux[name] = value


@dataclasses.dataclass
class Segment:
    """One op's device work as a function of the chain's state.

    ``trace(fctx, tree, mask, bound)`` returns the new ``(tree, mask)``;
    a head segment (several sources) gets the list of source states
    instead. ``bound`` is :attr:`bound` with its leaves on the device
    (values that change between runs, such as ReduceToIndex's ranges).
    """

    label: str
    token: Tuple
    trace: Callable
    bound: Any = ()
    # output counts equal input counts (map-only stacks, ZipWithIndex,
    # PrefixSum, the W = 1 Sort): host-known counts pass through
    preserves_counts: bool = False
    # the valid rows are a prefix already (sorts, heads): no compaction
    already_compact: bool = False
    # host-known output counts the segment imposes (ReduceToIndex)
    sets_counts: Optional[np.ndarray] = None
    # a head rebuilt at another output capacity (hinted-join recovery)
    refit: Optional[Callable[[int], "Segment"]] = None
    # called by execute() with (plan, out shards): attaches a deferred
    # check to the program's output
    finalize: Optional[Callable[["FusionPlan", DeviceShards], None]] = None
    dia_id: Optional[int] = None
    # every output row comes from one input row (stacks): rung 3 may run
    # the chain over row ranges without changing the result
    row_local: bool = False
    # may emit more rows than it takes (FlatMap): no output bound
    expands: bool = False
    # the per-item form of the segment, for rung 4
    host_apply: Optional[Callable] = None


def _src_sig(shards: DeviceShards, flat) -> Tuple:
    leaves, treedef = flat
    return (shards.cap, treedef,
            tuple((l.dtype, tuple(l.shape[2:])) for l in leaves))


def _run_stitched(head: Optional[Segment], tail: List[Segment],
                  W: int, device: torch.device, counts: List[torch.Tensor],
                  src_flat: List[Tuple[list, Any]],
                  bounds: List[Tuple[list, Any]]):
    """The stitched program: the sources' states, every segment in
    order, one compaction. Returns (tree, ``[W]`` counts, aux)."""
    states = []
    for cnt, (leaves, td) in zip(counts, src_flat):
        cap = leaves[0].shape[1]
        mask = torch.arange(cap, device=device)[None, :] < cnt[:, None]
        states.append((pt.unflatten(td, list(leaves)), mask))
    bounds_t = [pt.unflatten(bt, list(bl)) for bl, bt in bounds]
    fctx = TraceCtx(W)
    si = 0
    if head is not None:
        tree, mask = head.trace(fctx, states, bounds_t[0])
        si = 1
    else:
        tree, mask = states[0]
    for seg, bound_t in zip(tail, bounds_t[si:]):
        tree, mask = seg.trace(fctx, tree, mask, bound_t)
    if _prefix_mask(([head] if head is not None else []) + tail):
        out_count = mask.sum(dim=1)
    else:
        tree, out_count = compact_valid(tree, mask)
    return tree, out_count.to(torch.int64), fctx.aux


def _prefix_mask(segs: List[Segment]) -> bool:
    """Are the valid rows after ``segs`` a prefix already: a segment that
    leaves them so, followed only by segments that keep every row's
    validity? Then the final compaction would move nothing."""
    for seg in reversed(segs):
        if seg.already_compact:
            return True
        if not seg.preserves_counts:
            return False
    return False


class FusionPlan:
    """A pending chain of segments over source DeviceShards.

    ``head`` (optional) takes all sources (Zip, InnerJoin); the tail is
    linear. ``stitchable=False`` wraps shards already computed (host
    storage, or stitching off): :meth:`finish` just hands them out.
    """

    def __init__(self, mesh_exec, sources: List[Any],
                 head: Optional[Segment] = None,
                 stitchable: bool = True,
                 known_counts: Optional[np.ndarray] = None) -> None:
        self.mex = mesh_exec
        self.sources = sources
        self.head = head
        self.segments: List[Segment] = []
        self.stitchable = stitchable and enabled() and all(
            isinstance(s, DeviceShards) for s in sources)
        if head is not None:
            known_counts = head.sets_counts if head.sets_counts is not None \
                else known_counts
        elif known_counts is None and self.stitchable \
                and len(sources) == 1:
            known_counts = sources[0]._counts_host
        self.known_counts = known_counts
        self.aux: dict = {}          # the last execute()'s aux outputs
        self._no_finalize = False    # recovery runs attach no checks
        self._no_split = False       # rung-3 chunks split no further

    # -- building -------------------------------------------------------
    def append(self, seg: Segment) -> None:
        assert self.stitchable, "cannot extend a plan that is not stitchable"
        self.segments.append(seg)
        if seg.sets_counts is not None:
            self.known_counts = seg.sets_counts
        elif not seg.preserves_counts:
            self.known_counts = None

    @property
    def all_segments(self) -> List[Segment]:
        return ([self.head] if self.head is not None else []) \
            + self.segments

    def counts_preserved(self) -> bool:
        """Every pending segment keeps each worker's count."""
        return self.head is None and all(s.preserves_counts
                                         for s in self.segments)

    def copy(self) -> "FusionPlan":
        """The same lineage as a plan of its own (a retried compute gets
        the plan its failed attempt pulled)."""
        out = FusionPlan.__new__(FusionPlan)
        out.__dict__.update(self.__dict__)
        out.segments = list(self.segments)
        out.aux = {}
        return out

    # -- execution ------------------------------------------------------
    def finish(self):
        """The plan's shards for a consumer that reads the columns: the
        fused boundary, where deferred checks drain before anything
        (an exchange, an action, a host fallback) reads the rows."""
        if not self.stitchable:
            return self.sources[0]
        shards = self.execute()
        if isinstance(shards, DeviceShards):
            shards.validate_pending()
        return shards

    def execute(self):
        """Run the chain as one dispatch; DeviceShards, or HostShards
        when rung 4 ran it on the host."""
        segs = self.all_segments
        if not segs:
            return self.sources[0]
        tr = self.mex.tracer
        if tr is None or not tr.enabled:
            return self._execute_inner()
        with tr.span("fusion", "+".join(s.label for s in segs)[:120],
                     ops=len(segs)):
            return self._execute_inner()

    def _execute_inner(self):
        mex = self.mex
        srcs = self.sources
        segs = self.all_segments
        for s in srcs:
            s.validate_pending()
        src_flat = [pt.flatten(s.tree) for s in srcs]
        sigs = tuple(_src_sig(s, f) for s, f in zip(srcs, src_flat))
        bound_flat, bound_sig = [], []
        for seg in segs:
            bl, bt = pt.flatten(seg.bound)
            # values at this run, copied (a bound array may be read-only);
            # a tensor on the device passes as it is, so a loop capture
            # knows it, and an upload is a blessed plan constant
            bl = [l if isinstance(l, torch.Tensor)
                  and l.device.type == mex.device.type
                  else mex.bless(l.to(mex.device)
                                 if isinstance(l, torch.Tensor) else
                                 torch.tensor(np.asarray(l),
                                              device=mex.device))
                  for l in bl]
            bound_flat.append((bl, bt))
            bound_sig.append((bt, tuple((l.dtype, tuple(l.shape))
                                        for l in bl)))
        key = ("fused", sigs, tuple(s.token for s in segs),
               tuple(bound_sig))
        prog = mex.program(key, _run_stitched)
        split = self._proactive_split(prog, srcs, segs)
        if split is not None:
            return split
        if faults.REGISTRY.active():
            # every stitched op keeps a site; a transient fire retries
            # the (pure) program under the shared policy. The dispatch's
            # own site retries inside dispatch(), outside this policy,
            # so the two budgets do not multiply
            def site_checks():
                for seg in segs:
                    faults.check(faults.fuse_site(seg.label),
                                 dia_id=seg.dia_id, fused_ops=len(segs))

            default_policy().run(site_checks, what="fuse.dispatch")
        pres = mex.pressure
        if pres is not None and pres.enabled and prog.out_bytes is None \
                and not any(s.expands for s in segs):
            # a chain that does not expand makes at most its sources'
            # rows: their bytes bound its output
            pres.hint_output_bytes(sum(
                l.numel() * l.element_size()
                for f in src_flat for l in f[0]))
        # the ledger's record of the split point: the ops this dispatch
        # carries and its predicted output bytes (audited below)
        led = _decisions.ledger_of(mex)
        dec = None
        if led is not None:
            ops_label = "+".join(s.label for s in segs)[:80]
            pred = prog.out_bytes
            why = "learned output size"
            if pred is None and not any(s.expands for s in segs):
                pred = sum(l.numel() * l.element_size()
                           for f in src_flat for l in f[0])
                why = "non-expanding chain: bounded by source bytes"
            elif pred is None:
                why = "expanding chain: no bound"
            dec = led.record("fusion", "fuse:" + ops_label, "fuse",
                             predicted=pred, reason=why, ops=ops_label,
                             n_ops=len(segs),
                             dia_ids=[s.dia_id for s in segs])
        try:
            tree, out_count, aux = prog(
                self.head, list(self.segments), mex.num_local,
                mex.device, [s.counts_device() for s in srcs], src_flat,
                bound_flat)
        except Exception as e:
            from ..mem import pressure as _pressure
            if self._no_split or not (_pressure.retry_enabled()
                                      and _pressure.is_oom_error(e)):
                raise
            return self._execute_degraded(e)
        mex.stats_fused_dispatches += 1
        mex.stats_fused_ops += len(segs)
        ops = tuple(s.label for s in segs)
        mex.fused_stage_counts[ops] = mex.fused_stage_counts.get(ops, 0) + 1
        log = mex.logger
        if log is not None and log.enabled:
            log.line(event="fused_dispatch", ops=list(ops),
                     dia_ids=[s.dia_id for s in segs])
        if dec is not None:
            led.resolve(dec, sum(l.numel() * l.element_size()
                                 for l in pt.leaves(tree)))
        self.aux = aux
        if self.known_counts is not None:
            shards = DeviceShards(mex, tree, self.known_counts.copy())
            # the program's counts, on the device already: the next
            # program reads them with no upload
            shards._counts_dev = out_count.reshape(-1).to(torch.int64)
        else:
            shards = DeviceShards(mex, tree, out_count)
        if not self._no_finalize:
            for seg in segs:
                if seg.finalize is not None:
                    seg.finalize(self, shards)
        return shards

    def reexecute(self, new_cap: int) -> DeviceShards:
        """The plan again with its head refit to ``new_cap`` (hinted-join
        recovery): same sources, same tail, no checks attached."""
        assert self.head is not None and self.head.refit is not None
        plan = FusionPlan(self.mex, self.sources,
                          head=self.head.refit(new_cap))
        plan.segments = list(self.segments)
        plan.known_counts = None
        plan._no_finalize = True
        return plan.execute()

    def _proactive_split(self, prog, srcs, segs):
        """The planner's split point under the HBM admission estimate
        (api/planner.py): a row-local single-source chain whose inputs
        and estimated output cannot fit under the watermark at any
        spill level runs as rung 3's row-range sub-dispatches before its
        dispatch, not after a retry budget of failed allocations.
        Returns the result, or None (dispatch whole). The eligibility is
        rung 3's."""
        from .planner import planner_of
        mex = self.mex
        pl = planner_of(mex)
        pres = mex.pressure
        if pl is None or pres is None or not pres.enabled \
                or self._no_split or self.head is not None \
                or len(srcs) != 1 \
                or not all(s.row_local and s.finalize is None
                           for s in segs):
            return None
        from ..mem import pressure as _pressure
        if not _pressure.retry_enabled():
            return None
        src = srcs[0]
        src_bytes = sum(l.numel() * l.element_size()
                        for l in pt.leaves(src.tree))
        out_est = prog.out_bytes
        if out_est is None:
            out_est = (src_bytes if not any(s.expands for s in segs)
                       else int(src_bytes * pres.est_factor))
        est = src_bytes + int(out_est)
        k = pl.fusion_split_k(est, src.cap)
        if k is None:
            return None
        try:
            out = self._execute_split(src, k)
        except Exception as e:
            if not _pressure.is_oom_error(e):
                raise
            # the parts did not fit either: dispatch whole and leave the
            # escalation to the reactive ladder
            faults.note("recovery", what="mem.split_oom",
                        ops=[s.label for s in segs], error=repr(e)[:200])
            return None
        ops_label = "+".join(s.label for s in segs)[:80]
        led = _decisions.ledger_of(mex)
        if led is not None:
            led.record("fusion_split", "fuse:" + ops_label, f"split:{k}",
                       predicted=est // k, rejected=[("whole", est)],
                       reason="admission estimate exceeds the HBM "
                              "watermark at any spill level",
                       ops=ops_label, k=k, dia_ids=[s.dia_id for s in segs])
        pres.segment_splits += 1
        faults.note("segment_split", k=k, ops=[s.label for s in segs],
                    cap=src.cap, proactive=True)
        faults.note("recovery", what="mem.segment_split_proactive",
                    _quiet=True)
        instant_of(mex.tracer, "mem", "segment_split", k=k, proactive=True)
        return out

    # -- the memory ladder's rungs 3-4 (mem/pressure.py) ----------------
    def _execute_degraded(self, exc: BaseException):
        """Rung 2 gave up on this dispatch. Rung 3 runs a row-local
        single-source chain as ``split_k`` row-range sub-dispatches;
        rung 4 runs the chain's per-item form on the host. Anything else
        re-raises the OOM."""
        from ..mem import pressure as _pressure
        segs = self.all_segments
        labels = [s.label for s in segs]
        if self.head is not None or len(self.sources) != 1:
            raise exc
        # the failed program's frames hold its intermediates
        _pressure._drop_frames(exc)
        pres = _pressure.monitor_for(self.mex)
        src = self.sources[0]
        if all(s.row_local and s.finalize is None for s in segs) \
                and src.cap > 1:
            k = _pressure.split_k(src.cap)
            try:
                out = self._execute_split(src, k)
            except Exception as e2:
                if not _pressure.is_oom_error(e2):
                    raise
                faults.note("recovery", what="mem.split_oom",
                            ops=labels, error=repr(e2)[:200])
            else:
                pres.segment_splits += 1
                faults.note("segment_split", k=k, ops=labels, cap=src.cap)
                faults.note("recovery", what="mem.segment_split",
                            _quiet=True)
                instant_of(self.mex.tracer, "mem", "segment_split", k=k)
                return out
        if all(s.host_apply is not None for s in segs):
            pres.host_fallbacks += 1
            faults.note("recovery", what="mem.host_fallback", ops=labels)
            instant_of(self.mex.tracer, "mem", "host_fallback",
                       ops=len(labels))
            shards = src.to_host_shards(reason="memory_pressure")
            lists = shards.lists
            for seg in segs:
                lists = [seg.host_apply(items) for items in lists]
            return HostShards(shards.num_workers, lists)
        raise exc

    def _execute_split(self, src: DeviceShards, k: int) -> DeviceShards:
        """The row-local chain over ``k`` row ranges of the source, one
        sub-dispatch each, the parts put back together per worker in
        range order: the same rows as one dispatch, since every output
        row comes from one input row and compaction keeps order."""
        from ..common.partition import dense_range_bounds
        mex = self.mex
        bounds = dense_range_bounds(src.cap, k)
        counts = src.counts                 # a host sync: degraded path
        parts: List[List[Any]] = [[] for _ in range(mex.num_workers)]
        for i in range(k):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if hi <= lo:
                continue
            chunk = DeviceShards(
                mex, pt.tree_map(lambda l: l[:, lo:hi], src.tree),
                np.clip(counts - lo, 0, hi - lo).astype(np.int64))
            sub = FusionPlan(mex, [chunk])
            sub.segments = list(self.segments)
            sub.known_counts = None
            sub._no_finalize = True
            sub._no_split = True
            for w, t in enumerate(sub.execute().to_worker_arrays()):
                parts[w].append(t)
            del sub, chunk
        per_worker = [pt.tree_map(lambda *ls: np.concatenate(ls, axis=0),
                                  *p) for p in parts]
        return DeviceShards.from_worker_arrays(mex, per_worker)


def wrap(shards) -> FusionPlan:
    """A plan around shards already computed (host or device)."""
    mex = getattr(shards, "mesh_exec", None)
    return FusionPlan(mex, [shards],
                      stitchable=isinstance(shards, DeviceShards))


def stack_segment(stack: Stack, dia_id: Optional[int] = None) -> Segment:
    """The Map/Filter/FlatMap stack of an edge as a segment (the math of
    ``apply_stack_device`` without its own dispatch)."""
    bound = tuple(stack_bound_operands(stack))

    def trace(fctx, tree, mask, bound_t):
        return apply_stack_traced(tree, mask, stack,
                                  bound=list(bound_t) if bound_t else None)

    return Segment(label="Stack",
                   token=("stack", stack_cache_token(stack)),
                   trace=trace, bound=bound,
                   preserves_counts=all(op.kind == "map" for op in stack),
                   dia_id=dia_id, row_local=True,
                   expands=any(op.kind == "flat_map" for op in stack),
                   host_apply=lambda items, _s=stack:
                       apply_stack_host_list(items, _s))


def pull_plan(link, consume: bool = True, memo: bool = True) -> FusionPlan:
    """Pull a parent edge as a plan: the parent defers (its segments
    arrive pending) or materializes (its shards become the source, their
    deferred checks drained here); the edge's stack joins as a segment.
    With stitching off this is ``wrap(link.pull())``. Inside a compute
    that rung 2 may retry, the pull is memoised like ``ParentLink.pull``
    (which memoises its own, finished, pulls and passes ``memo=False``):
    a retry gets the same lineage back."""
    if not enabled():
        return wrap(link.pull(consume))
    pres = link.node.context.pressure
    memo = pres.memos[-1] if memo and pres.memos else None
    if memo is not None:
        got = memo.replay(link, consume, plan=True)
        if got is not None:
            return got.copy()
    res = link.node.materialize_plan(consume=consume)
    if isinstance(res, FusionPlan):
        plan = res
    elif isinstance(res, DeviceShards):
        res.validate_pending()
        plan = FusionPlan(res.mesh_exec, [res])
    else:
        plan = wrap(res)
    if link.stack:
        if plan.stitchable:
            plan.append(stack_segment(link.stack, dia_id=link.node.id))
        else:
            shards = plan.finish()
            if isinstance(shards, HostShards):
                shards = HostShards(shards.num_workers,
                                    [apply_stack_host_list(l, link.stack)
                                     for l in shards.lists])
            else:
                shards = apply_stack_device(shards, link.stack)
            plan = wrap(shards)
    if memo is not None:
        memo.record(link, consume, plan.copy(), plan=True)
    return plan
