"""DIA graph nodes (counterpart of the reference package's
``api/dia_base.py``).

An action materializes its parent, which recursively computes its own
parents. A result stays cached on its node until its consume budget is
spent; ``Keep()`` raises the budget, as the reference's consume counters
do. A node that declares a ``MEM_USE`` gets a RAM grant,
``mem_limit``, for the length of its compute.

Every materialization goes through the memory ladder at the reference's
points: stage admission before a compute, the compute under the OOM
retry (``mem/pressure.py``), the HBM governor's ledger after it
(``hbm.on_cache``), an LRU bump that uploads a spilled result again on a
cached pull (``hbm.touch``), and ``hbm.on_release`` when a result is
consumed or disposed (``mem/hbm.py``). Each pull inside a compute is
memoised for the retry and admitted against the budget.

With a checkpoint manager (api/checkpoint.py) a node the resume epoch
holds is rebuilt from it instead of computed, so its upstream graph is
never pulled; with ``THRILL_TPU_CKPT_AUTO=1`` a freshly computed result
is sealed into an epoch.

Stitching (api/fusion.py, on unless ``THRILL_TPU_FUSE=0``): a pull goes
through ``fusion.pull_plan``, and a fusible node (one with a
``compute_plan``) that is NEW, has this pull as its only consumer and
no restorable or auto-sealed epoch, defers: its segments run inside the
consumer's stitched program and the node ends in state FUSED, never
materialized. Its memory grant is taken around ``compute_plan``. A
node that cannot defer materializes as above (its own compute stitches
what its parents deferred into it).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from ..core import unsigned
from ..data.shards import DeviceShards, HostShards
from .stack import Stack, apply_stack_device, apply_stack_host

Shards = Union[DeviceShards, HostShards]

NEW = "NEW"
EXECUTED = "EXECUTED"
DISPOSED = "DISPOSED"
# the node's work ran inside its sole consumer's stitched program
# (api/fusion.py): consumed without ever materializing
FUSED = "FUSED"


@dataclasses.dataclass
class ParentLink:
    """A node's link to a parent node plus the LOp stack on the edge."""
    node: "DIABase"
    stack: Stack

    def pull(self, consume: bool = True) -> Shards:
        shards = self._pull(consume)
        # a compute that reads a wide unsigned column runs as the
        # reference's unsigned arrays from here on (fault C22)
        unsigned.on_pull(shards)
        return shards

    def _pull(self, consume: bool) -> Shards:
        pres = self.node.context.pressure
        memo = pres.memos[-1] if pres.memos else None
        if memo is not None:
            # a retried compute gets what its failed attempt pulled
            shards = memo.replay(self, consume)
            if shards is not None:
                return shards
        from . import fusion
        if fusion.enabled():
            # upstream segments deferred into one stitched program run
            # here, the edge's stack with them
            shards = fusion.pull_plan(self, consume=consume,
                                      memo=False).finish()
        else:
            shards = self._pull_unfused(consume)
        if memo is not None:
            memo.record(self, consume, shards)
        if pres.enabled:
            pres.admit(shards)
        return shards

    def _pull_unfused(self, consume: bool = True) -> Shards:
        shards = self.node.materialize(consume=consume)
        if isinstance(shards, DeviceShards):
            # a deferred check (the hinted join's overflow) runs before
            # any consumer reads the columns
            shards.validate_pending()
        if self.stack:
            if isinstance(shards, HostShards):
                shards = apply_stack_host(shards, self.stack)
            else:
                shards = apply_stack_device(shards, self.stack)
        return shards


class DIABase:
    """A node of the DIA dataflow graph."""

    # memory appetite of compute() (reference: DIAMemUse): None =
    # negligible, "max" = as much as there is (the host reduce and group
    # tables), an int = fixed bytes
    MEM_USE = None

    def __init__(self, ctx, label: str,
                 parents: Sequence[ParentLink] = ()) -> None:
        self.context = ctx
        self.label = label
        self.parents: List[ParentLink] = list(parents)
        self.id = ctx._register_node(self)
        # the failure domain: a heal disposes the nodes of the failed
        # generation only, and earlier pipelines' cached results stay
        self._generation = getattr(ctx, "generation", 0)
        # the tenant: its device bytes count in that tenant's HBM ledger
        self._tenant = getattr(ctx, "current_tenant", None)
        self.state = NEW
        self._shards: Optional[Shards] = None
        # every node's result may be used once; Keep(n) allows n more
        self.consume_budget = 1
        self.mem_limit: Optional[int] = None
        self._mem_grant = 0

    def mem_use(self):
        return self.MEM_USE

    def _barrier_decision(self, reason: str) -> None:
        """The ledger's record of a declined fusion deferral: why this
        node ends the stitched chain (explain() shows it on the node)."""
        from ..common import decisions as _decisions
        led = _decisions.ledger_of(self.context.mesh_exec)
        if led is not None:
            led.record("fusion_barrier", f"node:{self.label}#{self.id}",
                       "materialize", rejected=[("defer", None)],
                       reason=reason, dia=self.id, node=self.label)

    def _bind_ledger_node(self):
        """Make this node the current one while it computes: decisions
        recorded inside land on it in explain(), and the device sort
        finds the mesh. Returns what :meth:`_unbind_ledger_node` needs."""
        from ..parallel.mesh import bind_current
        mex = self.context.mesh_exec
        prev = bind_current(mex)
        led = getattr(mex, "decisions", None)
        if led is not None and led.enabled:
            led.push_node(self.id, self.label)
            return led, prev
        return None, prev

    @staticmethod
    def _unbind_ledger_node(led, prev_mex) -> None:
        from ..parallel.mesh import bind_current
        if led is not None:
            led.pop_node()
        bind_current(prev_mex)

    def compute(self) -> Shards:
        raise NotImplementedError

    def compute_plan(self):
        """A fusible op overrides this: a :class:`fusion.FusionPlan`
        whose tail carries this node's segment, or None when the op
        cannot stitch at all. Once it has pulled a parent it must return
        a plan (wrapping a result it computed when the input turned out
        host-resident): the pull consumed the parent."""
        return None

    def materialize_plan(self, consume: bool = False):
        """The fused pull: defer this node into its sole consumer's
        program when it can (stitching on, consuming pull, nothing
        cached, budget 1, a ``compute_plan``), else materialize. Returns
        a FusionPlan (deferred) or shards. A node that the resume epoch
        holds, and every node with parents under auto-epochs, must
        materialize: restoring beats recomputing its upstream graph, and
        an epoch seals only materialized results."""
        from . import fusion
        mgr = getattr(self.context, "checkpoint", None)
        if mgr is not None and self.state == NEW and (
                mgr.restorable(self) or (mgr.auto and self.parents)):
            self._barrier_decision("checkpoint restore/auto-epoch "
                                   "needs materialized shards")
            return self.materialize(consume=consume)
        if (fusion.enabled() and consume and self._shards is None
                and self.state == NEW and self.consume_budget <= 1
                and type(self).compute_plan is not DIABase.compute_plan):
            from ..mem.pressure import PullMemo
            negotiated = self.context.negotiate_mem(self)
            # the pulls of a deferred node are those of a compute in
            # flight: the governor spills none of them meanwhile
            pres = self.context.pressure
            memo = PullMemo()
            pres.memos.append(memo)
            led, prev_mex = self._bind_ledger_node()
            try:
                plan = self.compute_plan()
            finally:
                self._unbind_ledger_node(led, prev_mex)
                pres.memos.remove(memo)
                if negotiated:
                    self.context.release_mem(self)
            if plan is not None:
                self.consume_budget = 0
                self.state = FUSED
                log = self.context.logger
                if log.enabled:
                    log.line(event="node_fused", node=self.label,
                             dia_id=self.id,
                             parents=[p.node.id for p in self.parents])
                return plan
            self._barrier_decision("plan ineligible (host storage or "
                                   "untraceable input)")
        elif fusion.enabled() and consume \
                and type(self).compute_plan is not DIABase.compute_plan:
            # a stitchable op that cannot defer this pull: name why
            self._barrier_decision(
                "cached result" if self._shards is not None
                or self.state != NEW else "multi-consumer (Keep)")
        return self.materialize(consume=consume)

    def materialize(self, consume: bool = False) -> Shards:
        if self.state in (DISPOSED, FUSED):
            raise RuntimeError(
                f"DIA node {self.label}#{self.id} was consumed/disposed "
                f"(consume budget exhausted); call .Keep() before reusing "
                f"a DIA in more than one operation")
        ctx = self.context
        hbm = ctx.hbm
        if self._shards is None:
            log = ctx.logger
            if log.enabled:
                log.line(event="node_execute_start", node=self.label,
                         dia_id=self.id,
                         parents=[p.node.id for p in self.parents])
            mgr = getattr(ctx, "checkpoint", None)
            restored = mgr.try_restore(self) if mgr is not None else None
            if restored is not None:
                self._shards = restored
            else:
                pres = ctx.pressure
                if pres.enabled:
                    pres.admit_stage(self)
                negotiated = ctx.negotiate_mem(self)
                led, prev_mex = self._bind_ledger_node()
                try:
                    with unsigned.node_scope():
                        self._shards = pres.compute(self)
                finally:
                    self._unbind_ledger_node(led, prev_mex)
                    if negotiated:
                        ctx.release_mem(self)
                if mgr is not None:
                    mgr.maybe_autosave(self, self._shards)
            self.state = EXECUTED
            if not (consume and self.consume_budget <= 1):
                # a result this very pull releases is never worth
                # spilling a kept one for
                hbm.on_cache(self)
            if log.enabled:
                # host counts only: the log line never forces a fetch
                sh = self._shards
                host_counts = (sh.counts if isinstance(sh, HostShards)
                               else getattr(sh, "_counts_host", None))
                log.line(event="node_execute_done", node=self.label,
                         dia_id=self.id,
                         items=(int(host_counts.sum())
                                if host_counts is not None else None),
                         per_worker=(host_counts.tolist()
                                     if host_counts is not None
                                     else None))
        else:
            hbm.touch(self)
        result = self._shards
        if consume:
            self.consume_budget -= 1
            if self.consume_budget <= 0:
                self._shards = None
                self.state = DISPOSED
                hbm.on_release(self, None)   # the caller owns `result`
        return result

    def keep(self, n: int = 1) -> None:
        self.consume_budget += n

    def dispose(self) -> None:
        dropped = self._shards
        self._shards = None
        self.state = DISPOSED
        self.context.hbm.on_release(self, dropped)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.label}#{self.id} {self.state}>"
