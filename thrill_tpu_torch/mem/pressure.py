"""Memory pressure: admission, the OOM classifier and the four rungs of
the escalation ladder (counterpart of the reference package's
``mem/pressure.py``; Thrill's operators degrade to external memory
instead of dying, data/block_pool.hpp:42, api/sort.hpp:679).

1. **Admission.** Before a node computes (:meth:`PressureMonitor.
   admit_stage`), after each pull of its inputs (:meth:`admit`, the
   inputs' bytes times ``est_factor`` standing in for what the compute
   will make), and before each call through the mesh's dispatch choke
   point (:meth:`admit_call`: the arguments' bytes plus the plan's
   output-bytes hint, :meth:`hint_output_bytes`, else the program's
   learned output size, else ``est_factor`` times the arguments), cold
   cached results spill until the governor's ledger fits under the
   watermark fraction of the HBM budget (``event=mem_spill``). The
   inputs of the computes and the dispatch in flight are never
   spilled: they stay alive through the work, so spilling them frees
   nothing.
2. **OOM retry.** A device OOM spills every cold cached result and runs
   the work again under the shared backoff policy (``event=oom_retry``),
   at one of two places:

   - at the dispatch (:func:`recover_dispatch`), for every program
     called through ``MeshExec.dispatch``: the stitched programs of
     ``api/fusion.py`` and the per-op programs of the ops they stitch.
     ``oom_retries`` then counts re-dispatches;
   - at node level (:meth:`PressureMonitor.compute`), for a compute
     whose device work runs outside the choke point (the W > 1 Sort,
     the exchanges, GroupByKey, Merge, a source that generates on the
     device). While it runs, ``ParentLink.pull`` memoises what it
     returned (:class:`PullMemo`), and the retry gets the same shards
     back instead of pulling consumed parents again.

   The second and later retries of one piece of work also release the
   caching allocator's free blocks to the card
   (``torch.cuda.empty_cache``). An OOM that leaves a rung is marked, so
   an enclosing compute does not retry it again.
3. **Split** (``api/fusion.py`` ``FusionPlan._execute_degraded``). When
   rung 2 gives up on a stitched dispatch whose segments are row-local
   (Map, Filter, FlatMap stacks), the chain runs as :func:`split_k`
   row-range sub-dispatches and the parts are put back together in
   order (``event=segment_split``, ``segment_splits``).
4. **Host fallback.** When even the split chunks run out of memory, the
   chain runs per item on the host (``host_fallbacks``).

The budget is ``THRILL_TPU_HBM_LIMIT``, else the card's total memory
(``torch.cuda.mem_get_info``), else 0 on the CPU (admission off).
``THRILL_TPU_OOM_RETRY=0`` takes the ladder away. Injection sites:
``mem.oom`` (a :class:`SimulatedOom` at every attempt of a dispatch, and
after a compute that made device shards without one, so its retry
replays every pull),
``mem.spill`` and ``mem.estimate``. A compute that emptied a consumed
host input in place is not retried.
"""

from __future__ import annotations

import os
import sys
import traceback
from typing import Any, List, Optional

import torch

from ..common import faults
from ..common.retry import RetryPolicy, default_policy
from ..common.trace import instant_of
from ..data.shards import DeviceShards, HostShards
from .hbm import device_bytes, storages

OOM_KIND = "oom"

#: the fraction of the HBM budget admission keeps the ledger under
WATERMARK = 0.85
#: a compute's working set, as a multiple of its inputs' bytes
EST_FACTOR = 2.0
#: rung 3's count of row-range sub-dispatches (clamped to the capacity)
SPLIT_K = 4


class SimulatedOom(faults.InjectedFault, RuntimeError):
    """Injected device OOM, with the runtime's RESOURCE_EXHAUSTED text."""

    def __init__(self, site: str, kind: str = OOM_KIND) -> None:
        faults.InjectedFault.__init__(self, site, kind)
        self.args = (f"RESOURCE_EXHAUSTED: injected out of memory "
                     f"at site '{site}'",)


_F_OOM = faults.declare("mem.oom", kind=OOM_KIND, exc=SimulatedOom)
_F_SPILL = faults.declare("mem.spill")
_F_EST = faults.declare("mem.estimate")

# the allocation-failure texts of the runtimes; narrow on purpose
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                "Out of memory", "out of memory",
                "Failed to allocate", "failed to allocate",
                "Attempting to allocate")


def is_oom_error(exc: BaseException) -> bool:
    """Is this a device or allocator out-of-memory failure? A
    ``torch.OutOfMemoryError`` is, by its type. Any other CUDA error is
    not, whatever its text: it leaves the context unusable, so a retry
    could only fail again."""
    if isinstance(exc, SimulatedOom):
        return True
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    if isinstance(exc, faults.InjectedFault):
        return False
    if isinstance(exc, MemoryError):
        return True
    if not isinstance(exc, (RuntimeError, ValueError, OSError)):
        return False
    msg = str(exc)
    if "CUDA error" in msg or type(exc).__name__ == "AcceleratorError":
        return False
    return any(m in msg for m in _OOM_MARKERS)


def retry_enabled() -> bool:
    """``THRILL_TPU_OOM_RETRY=0`` takes the whole ladder away."""
    return os.environ.get("THRILL_TPU_OOM_RETRY", "1") not in (
        "0", "off", "false")


def split_k(cap: int) -> int:
    """Rung 3's sub-dispatch count for a source of capacity ``cap``:
    :data:`SPLIT_K` clamped to ``[2, cap]``."""
    return max(2, min(SPLIT_K, cap))


def detect_hbm_budget(device: Optional[torch.device] = None) -> int:
    """The HBM budget in bytes: ``THRILL_TPU_HBM_LIMIT``, else the
    card's total memory on a ``cuda`` mesh, else 0 (admission off)."""
    env = os.environ.get("THRILL_TPU_HBM_LIMIT")
    if env:
        from ..common.config import parse_si_iec_units
        try:
            return parse_si_iec_units(env)
        except (ValueError, TypeError):
            print(f"thrill_tpu_torch: bad THRILL_TPU_HBM_LIMIT={env!r}; "
                  f"ignoring", file=sys.stderr)
    if device is not None and device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return 0


class PullMemo:
    """The shards one compute pulled, in order: a retry of the compute
    gets them back instead of pulling consumed parents again. A pull
    that a fusible op made as a plan (``api/fusion.py`` ``pull_plan``)
    is kept as a copy of the plan, its lineage."""

    def __init__(self) -> None:
        self.pulls: List[tuple] = []      # (key, shards or plan)
        self.cursor = 0
        # a host input whose parent is gone may have been emptied in
        # place by the compute (the host reduce and group do): a retry
        # would read it wrong
        self.host_consumed = False

    @staticmethod
    def key(link, consume: bool, plan: bool = False) -> tuple:
        return (link.node.id, consume, len(link.stack), plan)

    def rewind(self) -> None:
        self.cursor = 0

    def replay(self, link, consume: bool, plan: bool = False):
        """The pull at the cursor when it is this one."""
        if self.cursor < len(self.pulls):
            key, shards = self.pulls[self.cursor]
            if key == self.key(link, consume, plan):
                self.cursor += 1
                return shards
        return None

    def record(self, link, consume: bool, shards,
               plan: bool = False) -> None:
        host = shards
        if plan and not shards.stitchable:
            host = shards.sources[0]
        if isinstance(host, HostShards) and link.node.state in (
                "DISPOSED", "FUSED"):
            self.host_consumed = True
        if self.cursor == len(self.pulls):
            self.pulls.append((self.key(link, consume, plan), shards))
            self.cursor += 1

    def storages(self) -> set:
        out: set = set()
        for _, shards in self.pulls:
            for s in getattr(shards, "sources", [shards]):
                out |= storages(s)
        return out


class _OomRetryPolicy(RetryPolicy):
    """The shared policy with a device OOM as its one transient class."""

    def classify(self, exc: BaseException) -> str:
        return faults.TRANSIENT if is_oom_error(exc) else faults.PERMANENT


def _drop_frames(exc: BaseException) -> None:
    """Free the locals of a failed compute's frames: the traceback would
    keep its device tensors alive through the retry."""
    if exc.__traceback__ is not None:
        traceback.clear_frames(exc.__traceback__)


class PressureMonitor:
    """A Context's memory-pressure state: the budget, the watermark, the
    ladder and its counters."""

    def __init__(self, mesh_exec, governor) -> None:
        self.mex = mesh_exec
        self.governor = governor
        self.budget = detect_hbm_budget(mesh_exec.device)
        self.watermark = WATERMARK
        self.enabled = self.budget > 0 and governor is not None
        self.est_factor = EST_FACTOR
        self.oom_retries = 0
        self.segment_splits = 0         # rung 3: chains run in parts
        self.host_fallbacks = 0         # rung 4: chains run on the host
        self.admission_spills = 0
        self.spilled_bytes = 0
        self.high_watermark = 0         # most (ledger + estimate) seen
        self.cache_flushes = 0          # empty_cache calls of rung 2
        # the memos of the computes in flight, innermost last
        self.memos: List[PullMemo] = []
        # the next dispatch's output bytes, from the plan that knows its
        # shapes (api/fusion.py); one slot, taken by the dispatch
        self._out_hint: Optional[int] = None

    def inadmissible(self, est_bytes: int) -> bool:
        """True when ``est_bytes`` cannot fit under the watermark at any
        spill level: the planner's HBM term (api/planner.py), which
        splits such a chain before its dispatch."""
        return self.enabled and est_bytes > self.budget * self.watermark

    # -- rung 1: admission ----------------------------------------------
    def _limit(self) -> int:
        return int(self.budget * self.watermark)

    def admit_stage(self, node) -> None:
        """Before ``node`` computes: bring the ledger under the
        watermark."""
        live = self.governor.mem.total
        if live > self.high_watermark:
            self.high_watermark = live
        if live <= self._limit():
            return
        self._admission_spill(live - self._limit(), node.label,
                              live=live, exclude=node.id)

    def admit(self, shards) -> None:
        """After a pull: the pulled bytes times ``est_factor`` is what
        the compute is about to need; spill cold results until the
        ledger plus that fits under the watermark."""
        try:
            if faults.REGISTRY.active():
                faults.check(_F_EST)
            est = int(device_bytes(shards) * self.est_factor)
        except Exception as e:
            faults.note("recovery", what="mem.estimate_skipped",
                        error=repr(e)[:200])
            return
        live = self.governor.mem.total
        if live + est > self.high_watermark:
            self.high_watermark = live + est
        if live + est <= self._limit():
            return
        self._admission_spill(live + est - self._limit(), "pull",
                              live=live, estimate=est,
                              exclude_storage=storages(shards))

    def hint_output_bytes(self, nbytes: int) -> None:
        """The next dispatch produces at most ``nbytes``."""
        self._out_hint = int(nbytes)

    def estimate_call_bytes(self, prog, args) -> int:
        """A dispatch's bytes: its arguments plus its output, taken from
        the plan's hint, else the program's learned output size, else
        ``est_factor`` times the arguments."""
        if faults.REGISTRY.active():
            faults.check(_F_EST)
        from ..parallel.mesh import tensor_bytes
        in_bytes = tensor_bytes(args)
        hint, self._out_hint = self._out_hint, None
        if hint is None:
            hint = prog.out_bytes
        if hint is not None:
            return in_bytes + int(hint)
        return int(in_bytes * self.est_factor)

    def admit_call(self, prog, args) -> None:
        """Before a dispatch: spill cold results until the ledger plus
        the dispatch's estimate fits under the watermark; never one
        whose storage is an argument of the dispatch."""
        try:
            est = self.estimate_call_bytes(prog, args)
        except Exception as e:
            faults.note("recovery", what="mem.estimate_skipped",
                        error=repr(e)[:200])
            return
        live = self.governor.mem.total
        if live + est > self.high_watermark:
            self.high_watermark = live + est
        if live + est <= self._limit():
            return
        self._admission_spill(live + est - self._limit(), "dispatch",
                              live=live, estimate=est,
                              exclude_storage=_arg_storages(args))

    def _admission_spill(self, need: int, label: str, **detail) -> None:
        exclude = detail.pop("exclude", None)
        extra = detail.pop("exclude_storage", set())
        try:
            freed = self.spill_cold(need=need, exclude=exclude,
                                    exclude_storage=extra)
        except Exception as e:
            faults.note("recovery", what="mem.pressure_spill_skipped",
                        error=repr(e)[:200])
            return
        if freed:
            faults.note("mem_spill", freed=freed, budget=self.budget,
                        node=label, **detail)
            self._trace_rung("admission_spill", freed=freed)

    def spill_cold(self, need: Optional[int] = None,
                   exclude: Optional[int] = None,
                   exclude_storage: Optional[set] = None,
                   admission: bool = True) -> int:
        """Spill the coldest cached results until ``need`` bytes left the
        ledger or nothing cold is left; never a result whose storage is
        an input of a compute in flight (or in ``exclude_storage``).
        ``admission=False`` (rung 2) counts the bytes but not an
        admission spill. Returns the bytes freed."""
        freed = self.governor.spill_coldest(
            need=need, exclude=exclude, exclude_storage=exclude_storage,
            before=lambda node: faults.check(_F_SPILL, node=node.label))
        if freed:
            if admission:
                self.admission_spills += 1
            self.spilled_bytes += freed
            # the eviction choice in the decision ledger: the policy
            # that ran, what it was asked to free and what it freed
            from ..common.decisions import record_of, resolve_of
            rec = record_of(self.mex, "io_evict", "mem.pressure",
                            "spill-lru-cold",
                            predicted=need if need else None,
                            reason="admission watermark" if admission
                            else "oom-retry ladder")
            resolve_of(self.mex, rec, freed)
        return freed

    # -- rung 2: OOM retry ----------------------------------------------
    def compute(self, node) -> Any:
        """``node.compute()`` with its pulls memoised, retried after a
        device OOM (see the module)."""
        memo = PullMemo()
        self.memos.append(memo)
        try:
            try:
                return self._attempt(node, memo)
            except Exception as e:
                if (not retry_enabled() or not is_oom_error(e)
                        or getattr(e, "_ladder_done", False)):
                    raise
                if memo.host_consumed:
                    e._ladder_done = True
                    raise
                return self._recover(node, memo, e)
        finally:
            self.memos.remove(memo)

    def _attempt(self, node, memo: PullMemo) -> Any:
        memo.rewind()
        d0 = self.mex.stats_dispatches
        out = node.compute()
        if (isinstance(out, DeviceShards) and faults.REGISTRY.active()
                and self.mex.stats_dispatches == d0):
            # the injected OOM stands for the device work of a compute
            # that ran outside the dispatch choke point, whose own site
            # stands for the rest
            faults.check(_F_OOM, node=node.label)
        return out

    def _recover(self, node, memo: PullMemo, exc: BaseException) -> Any:
        shared = default_policy()
        if (shared.max_attempts <= 1
                or os.environ.get("THRILL_TPU_RETRY", "1") == "0"):
            exc._ladder_done = True
            raise exc
        policy = _OomRetryPolicy(max_attempts=shared.max_attempts - 1,
                                 base_delay_s=shared.base_delay_s,
                                 max_delay_s=shared.max_delay_s)
        state = {"last": exc, "tries": 0}
        dev = self.mex.device

        def attempt():
            _drop_frames(state["last"])
            try:
                freed = self.spill_cold(exclude=node.id, admission=False)
            except Exception as e:
                faults.note("recovery", what="mem.pressure_spill_skipped",
                            error=repr(e)[:200])
                freed = 0
            if state["tries"] and dev.type == "cuda":
                torch.cuda.empty_cache()
                self.cache_flushes += 1
            state["tries"] += 1
            self.oom_retries += 1
            faults.note("oom_retry", freed=freed, node=node.label,
                        level="node", error=repr(state["last"])[:200])
            try:
                out = self._attempt(node, memo)
            except Exception as e:
                state["last"] = e
                raise
            faults.note("recovery", what="mem.oom", _quiet=True)
            return out

        try:
            return policy.run(attempt, what="mem.oom_retry")
        except Exception as e:
            if is_oom_error(e):
                e._ladder_done = True
            raise

    def _trace_rung(self, rung: str, **attrs) -> None:
        """A ladder rung as an instant on the ``mem`` trace lane
        (common/trace.py): the timeline shows when each escalation fired
        among the dispatch and exchange spans around it."""
        instant_of(self.mex.tracer, "mem", rung, **attrs)

    def stats(self) -> dict:
        return {
            "hbm_high_watermark": self.high_watermark,
            "oom_retries": self.oom_retries,
            "segment_splits": self.segment_splits,
            "host_fallbacks": self.host_fallbacks,
            "admission_spills": self.admission_spills,
            "pressure_spilled_bytes": self.spilled_bytes,
        }


def _arg_storages(args) -> set:
    """The storage addresses of the tensors in a dispatch's arguments."""
    out: set = set()

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.add(o.untyped_storage().data_ptr())
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)

    walk(args)
    return out


def monitor_for(mex) -> PressureMonitor:
    """The mesh's monitor; a bare mesh (no Context) gets one without a
    governor, so the ladder can still count and retry."""
    pres = getattr(mex, "pressure", None)
    if pres is None:
        pres = PressureMonitor(mex, governor=None)
        mex.pressure = pres
    return pres


def recover_dispatch(prog, args, kwargs, exc: BaseException):
    """Rung 2 at the dispatch (reference: ``recover_dispatch``,
    ``thrill_tpu/mem/pressure.py:392``): ``prog``'s call died with a
    device OOM, so spill cold results and call it again under the shared
    backoff policy, the failed call counting as its first attempt. The
    ``mem.oom`` site rides every retry too, so an armed run can use up
    this rung on purpose. Re-raises the last OOM, marked, when the
    budget is spent: the stitched plan (rungs 3-4) owns the next step."""
    pres = monitor_for(prog.mex)
    shared = default_policy()
    if (shared.max_attempts <= 1
            or os.environ.get("THRILL_TPU_RETRY", "1") == "0"):
        exc._ladder_done = True
        raise exc
    policy = _OomRetryPolicy(max_attempts=shared.max_attempts - 1,
                             base_delay_s=shared.base_delay_s,
                             max_delay_s=shared.max_delay_s)
    state = {"last": exc, "tries": 0}
    dev = prog.mex.device
    held = _arg_storages(args)

    def attempt():
        _drop_frames(state["last"])
        try:
            # never the dispatch's own inputs: they stay alive through it
            freed = pres.spill_cold(admission=False, exclude_storage=held) \
                if pres.governor is not None else 0
        except Exception as e:
            faults.note("recovery", what="mem.pressure_spill_skipped",
                        error=repr(e)[:200])
            freed = 0
        if state["tries"] and dev.type == "cuda":
            torch.cuda.empty_cache()
            pres.cache_flushes += 1
        state["tries"] += 1
        pres.oom_retries += 1
        faults.note("oom_retry", freed=freed, level="dispatch",
                    program=str(prog.key[0]) if prog.key else "?",
                    error=repr(state["last"])[:200])
        pres._trace_rung("oom_retry", freed=freed)
        try:
            if faults.REGISTRY.active():
                faults.check(_F_OOM, retry=True)
            out = prog.fn(*args, **kwargs)
        except Exception as e:
            state["last"] = e
            raise
        faults.note("recovery", what="mem.oom", _quiet=True)
        return out

    try:
        return policy.run(attempt, what="mem.oom_retry")
    except Exception as e:
        if is_oom_error(e):
            e._ladder_done = True
        raise
