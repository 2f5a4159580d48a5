"""The adaptive cost-based planner (counterpart of the reference
package's ``api/planner.py``): one model that chooses, learns and
re-optimizes the port's data-driven plan choices.

One :class:`Planner` per Context (``mesh_exec.planner``; one attribute
read and one predicate on the off path) owns:

* **The cost model**: bytes a candidate plan moves, plus its launches
  times ``bytes_eq`` (the per-launch overhead in equivalent bytes,
  ``data/exchange.py``), plus an HBM term (a candidate whose estimate
  cannot fit under the watermark at any spill level costs infinity).
* **The choices**: ``exchange_strategy`` (dense against the 1-factor
  rounds), ``chunk_count``, ``optimistic_verdict`` (dispatch on the
  cached capacity plan or re-sync, with the guaranteed-miss check on
  host-known counts), ``prune_verdict`` (core/preshuffle.py),
  ``sort_engine`` (core/device_sort.py), ``fusion_split_k`` (the
  proactive split of api/fusion.py) and ``io_prefetch_depth``.
* **Re-optimization**: the decision ledger calls :meth:`on_audit` with
  every joined actual; a store-seeded capacity that overshoots by more
  than ``THRILL_TPU_REPLAN_ERR`` (default 1.0 in log2), a prune
  fraction off its prediction, or a readahead hit rate under target
  marks the site, and its next choice re-plans from current data.

``THRILL_TPU_PLANNER=0`` constructs no planner: every call site takes
its per-site rule, numerically the same choices, and nothing replans.
Every value here is correctness-neutral: a wrong choice costs time,
never results.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..common.config import _env_flag


def planner_enabled() -> bool:
    """THRILL_TPU_PLANNER=0 restores the per-site heuristics exactly
    (read once, at Context construction)."""
    return _env_flag("THRILL_TPU_PLANNER", True)


def replan_threshold() -> float:
    """THRILL_TPU_REPLAN_ERR: |log2(predicted/actual)| beyond which an
    audited store-seeded prediction invalidates its site's plan
    (default 1.0 — off by more than 2x reads as a lie worth
    re-choosing over; in-process-learned capacities are pow2-ratcheted
    from measured data and cannot exceed 2x by construction, so only
    imported state can trip this)."""
    try:
        v = float(os.environ.get("THRILL_TPU_REPLAN_ERR", "") or 1.0)
    except ValueError:
        return 1.0
    return v if v > 0 else 1.0


def planner_of(mex) -> Optional["Planner"]:
    """The mesh's planner when adaptive planning is live, else None —
    one attribute read plus one predicate on the disabled path (the
    ledger_of pattern)."""
    pl = getattr(mex, "planner", None)
    if pl is not None and pl.enabled:
        return pl
    return None


class Planner:
    """Per-Context adaptive planner over the mesh's learned plan state.

    Thread-safe where it must be (replan marks arrive from deferred
    checks and audit joins, which may run on the service dispatcher
    thread while a client thread renders explain())."""

    def __init__(self, mex, enabled: Optional[bool] = None) -> None:
        self.mex = mex
        self.enabled = planner_enabled() if enabled is None else enabled
        self.err_threshold = replan_threshold()
        self._lock = threading.Lock()
        # sites marked for re-optimization: consumed (one-shot) by the
        # next plan choice at that site
        self._replan: Dict[str, str] = {}      # site -> reason
        # sites whose capacity plan came from the plan store: the only
        # sites an overprovision audit may invalidate (fresh-learned
        # capacities are pow2-ratcheted from measured data and cannot
        # lie past 2x by construction)
        self._seeded: set = set()
        # counters (ctx.overall_stats: planner_replans / _switches)
        self.replans = 0        # sites invalidated and re-chosen
        self.switches = 0       # re-choices that changed the plan
        # learned per-site readahead depths, grown from the audited
        # io_prefetch hit rate in place of the one THRILL_TPU_PREFETCH
        # default
        self._io_depth: Dict[str, int] = {}
        self._io_rate: Dict[str, float] = {}
        # shrink side of the loop: consecutive runs a site's audited
        # hit rate held >= IO_HIT_SHRINK, and the pending one-shot
        # shrink marks (site -> reason) the streak produced
        self._io_hi_streak: Dict[str, int] = {}
        self._io_shrink: Dict[str, str] = {}

    # -- cost model -----------------------------------------------------
    def bytes_eq(self) -> int:
        """Per-launch overhead in equivalent fabric bytes (the measured
        crossover constant, data/exchange.py; the CPU's: the card
        prices no launch)."""
        from ..data.exchange import _bytes_eq
        return _bytes_eq(self.mex)

    def plan_cost(self, fabric_bytes: float, dispatches: int = 0,
                  hbm_bytes: Optional[int] = None) -> float:
        """One candidate plan's scalar cost: bytes shipped plus launch
        overhead in byte-equivalents; an inadmissible HBM estimate
        (cannot fit under the watermark even after spilling everything
        cold) is infinite."""
        c = float(fabric_bytes)
        if dispatches:
            c += dispatches * self.bytes_eq()
        if hbm_bytes is not None and self.hbm_inadmissible(hbm_bytes):
            return math.inf
        return c

    def sort_engine(self, n: int, total_bits: int, radix_ok: bool,
                    site: Optional[str] = None, words: int = 1):
        """The device sort engine: the one cost model of
        core/device_sort.py, so the planner and the planner-off path
        cannot disagree; a pending replan mark on the sort site is
        consumed here (the caller records the decision either way)."""
        from ..core.device_sort import sort_engine_policy
        if site is not None:
            self.take_replan(site)
        return sort_engine_policy(n, total_bits, radix_ok,
                                  self.mex.device.type, words)

    def hbm_inadmissible(self, est_bytes: int) -> bool:
        """True when ``est_bytes`` cannot be admitted at any spill
        level: it exceeds the watermark fraction of the whole HBM
        budget (mem/pressure.py rung-1 inputs). False when admission
        is off (no budget known)."""
        pres = getattr(self.mex, "pressure", None)
        if pres is None or not pres.enabled:
            return False
        return pres.inadmissible(est_bytes)

    # -- choice: exchange strategy --------------------------------------
    def exchange_strategy(self, S: np.ndarray, row_bytes: int,
                          mode: str) -> Tuple[str, float, float, str]:
        """(chosen, dense_cost, onefactor_cost, reason) for one send
        matrix. ``mode`` is the configured exchange mode; only
        ``dense`` lets the cost model arbitrate (the legacy contract:
        forced modes pass through). Costs are total plan costs — padded
        fabric bytes plus per-round launch overhead — so
        ``dense_cost > onefactor_cost`` is EXACTLY the legacy
        ``_skewed`` inequality."""
        from ..data.exchange import _one_card, _strategy_costs
        dense_b, of_b, n_rounds = _strategy_costs(self.mex, S, row_bytes)
        dense_cost = self.plan_cost(dense_b)
        # the card prices no launch (it has no bytes_eq)
        of_cost = self.plan_cost(
            of_b, dispatches=0 if _one_card(self.mex) else n_rounds)
        if mode != "dense":
            return mode, dense_cost, of_cost, "configured mode"
        if _one_card(self.mex):
            return ("dense", dense_cost, of_cost,
                    "one card: the workers share one device")
        if dense_cost > of_cost:
            return ("onefactor", dense_cost, of_cost,
                    "skewed send matrix: 1-factor padding beats the "
                    "dense launch savings")
        return ("dense", dense_cost, of_cost, "balanced send matrix")

    def skew_developed(self, S: np.ndarray, row_bytes: int) -> bool:
        """Deferred-check probe: would the strategy choice flip to the
        1-factor schedule on this OBSERVED send matrix? Used by the
        optimistic exchange's capacity check, where the host S is
        fetched anyway — a True verdict marks the site so the next
        dispatch re-syncs immediately instead of waiting out the
        periodic resync window."""
        from ..data.exchange import resolve_mode
        if resolve_mode(self.mex) != "dense":
            return False
        chosen, _, _, _ = self.exchange_strategy(S, row_bytes, "dense")
        return chosen == "onefactor"

    # -- choice: phase-B chunk count ------------------------------------
    def chunk_count(self, W: int, M_pad: int, item_bytes: int) -> int:
        """Bulk vs chunked phase B and K. The planner owns the CHOICE;
        the policy (overlap kill switch, env pin, measured break-even
        volume) is the exchange's :func:`chunk_policy` — one
        implementation, so the planner-on and planner-off paths are
        numerically identical on every platform by construction."""
        from ..data.exchange import chunk_policy
        return chunk_policy(W, M_pad, item_bytes, self.mex.device.type,
                            self.hbm_inadmissible)

    # -- choice: optimistic dispatch vs re-sync -------------------------
    def optimistic_verdict(self, site: str, caps: Tuple[int, int],
                           counts: Optional[np.ndarray],
                           W: int) -> Tuple[bool, Optional[str]]:
        """May this site dispatch phase B on its cached capacity plan?

        (True, None) = dispatch optimistically (the steady-state hit
        path). (False, reason) = the planner re-chooses: either the
        site is marked for re-optimization (an audit or deferred check
        revealed the learned state lied) or host-known input counts
        PROVE the cached capacities cannot hold — a guaranteed miss,
        where dispatching optimistically would buy one wasted dispatch
        plus the heal's re-run. The caller takes the synced plan and
        drops the site's learned capacities so they re-ratchet from
        the current data. Either way the site leaves the seeded set:
        its state is in-process-learned from here (pow2-ratcheted from
        measured data), so the overprovision audit cannot re-fire on a
        capacity that min_cap legitimately dominates."""
        reason = self.take_replan(site)
        if reason is not None:
            with self._lock:
                self._seeded.discard(site)
            return False, reason
        if counts is not None and W > 1:
            M_pad, out_cap = caps
            total = int(np.asarray(counts).sum())
            per_worker_max = int(np.asarray(counts).max())
            # max receive column >= ceil(total/W); max cell >=
            # ceil(row_max/W): if either already exceeds the cached
            # capacity, SOME worker must overflow — no data
            # distribution can avoid it
            if -(-total // W) > out_cap \
                    or -(-per_worker_max // W) > M_pad:
                self.note_replan()
                with self._lock:
                    self._seeded.discard(site)
                return False, ("known row counts exceed the cached "
                               "capacity plan (guaranteed miss)")
        return True, None

    # -- choice: pre-shuffle pruning ------------------------------------
    def prune_verdict(self, rows: int, item_bytes: int, W: int,
                      sides: int, M: int, frac: float) -> bool:
        """The pre-shuffle cost inequality (core/preshuffle.py): prune
        when the expected pruned row bytes clear the fingerprint
        register traffic by the margin. The filter's own launch
        overhead is folded into the margin (the legacy ``_pays``
        calibration), so the verdict is numerically IDENTICAL to the
        per-site heuristic — the planner's value here is the replan
        path (a lying fraction re-evaluates immediately), not a
        different inequality."""
        from ..core.preshuffle import _MARGIN, _pays_est
        if W <= 1 or rows <= 0:
            return False
        pruned, fingerprint = _pays_est(rows, item_bytes, W, sides, M,
                                        frac)
        return pruned > _MARGIN * fingerprint

    # -- choice: proactive fusion split ---------------------------------
    def fusion_split_k(self, est_bytes: int, cap: int) -> Optional[int]:
        """K when a row-local fused chain should execute as K row-range
        sub-dispatches BEFORE dispatching whole (its admission estimate
        cannot fit under the HBM watermark at any spill level), else
        None. Uses the OOM ladder's own rung-3 K (mem/pressure.py
        ``split_k``) so the proactive and the reactive split produce
        identical sub-plans."""
        if cap <= 1 or not self.hbm_inadmissible(est_bytes):
            return None
        from ..mem.pressure import split_k
        return split_k(cap)

    # -- choice: out-of-core readahead depth ----------------------------

    #: grow the depth when a site's audited hit rate falls under this
    #: (log2(1/0.75) ~ 0.415 on the pred=1.0 io_prefetch records)
    IO_HIT_TARGET = 0.75
    #: never grow past this — beyond it the readahead pool itself (not
    #: depth) is the bound, and RAM cost scales with depth blocks
    IO_DEPTH_CAP = 32
    #: shrink a LEARNED depth back toward the default when the audited
    #: hit rate holds at least this for two consecutive runs — the
    #: readahead is comfortably ahead of the consumer, so half the
    #: depth (and half the pinned host RAM) likely still hits; an
    #: overshoot re-grows on the very next sub-target audit
    IO_HIT_SHRINK = 0.95

    def io_prefetch_depth(self, site: str, default: int) -> int:
        """LEARNED per-site readahead depth for an out-of-core site
        (the em_sort merge, spill/checkpoint restore).

        Seeding: the env-pinned depth (vfs/file_io.prefetch_depth,
        passed in as ``default``) the first time a site runs. Learning:
        every run records an ``io_prefetch`` decision predicting a
        perfect hit rate; the audit join (:meth:`on_audit`) marks the
        site when the MEASURED rate lands under ``IO_HIT_TARGET`` —
        the consumer outran the readahead — and the next run at that
        site doubles its depth (capped) instead of riding the one env
        default forever. Each re-choice lands as a ``kind=replan``
        ledger record carrying both depths and the measured rate, so
        ``ctx.explain()`` names the switch like any other plan
        re-optimization. ``default <= 0`` means prefetch is DISABLED
        (THRILL_TPU_PREFETCH=0 / OVERLAP=0) — the learned depth never
        overrides an explicit off switch (the synchronous-ladder
        restoration contract).

        Shrinking: a site whose audited hit rate held at least
        ``IO_HIT_SHRINK`` for two consecutive runs HALVES its learned
        depth back toward ``default`` (floor at ``default`` — the
        explicit/env setting is never undercut), reclaiming the pinned
        readahead RAM a transient burst grew. The re-choice lands as
        the same ``kind=replan`` record, carrying both depths."""
        if default <= 0:
            return default
        with self._lock:
            depth = self._io_depth.get(site, default)
            shrink_why = self._io_shrink.pop(site, None)
            shrink_rate = self._io_rate.get(site)
        if shrink_why is not None and depth > default:
            new = max(default, depth // 2)
            with self._lock:
                self._io_depth[site] = new
                self._io_hi_streak[site] = 0
                # a stale grow mark cannot coexist with a sustained
                # >= IO_HIT_SHRINK streak — drop it without counting
                self._replan.pop(site, None)
            self.note_replan()
            self.note_switch()
            from ..common.decisions import ledger_of
            self.record_replan(
                ledger_of(self.mex), site, f"depth={new}",
                predicted=float(new),
                rejected=[(f"depth={depth}", shrink_rate)],
                reason=shrink_why, depth=new, prev_depth=depth,
                measured_hit_rate=shrink_rate)
            return new
        with self._lock:
            if depth >= self.IO_DEPTH_CAP:
                # at the cap there is nothing to re-choose: drop any
                # pending mark WITHOUT counting a replan (the counter
                # counts performed re-optimizations, and none happens)
                self._replan.pop(site, None)
                return depth
        why = self.take_replan(site)
        if why is None:
            return depth
        new = min(max(depth * 2, default), self.IO_DEPTH_CAP)
        with self._lock:
            self._io_depth[site] = new
            rate = self._io_rate.get(site)
        if new != depth:
            self.note_switch()
        from ..common.decisions import ledger_of
        self.record_replan(
            ledger_of(self.mex), site, f"depth={new}",
            predicted=float(new),
            rejected=[(f"depth={depth}", rate)], reason=why,
            depth=new, prev_depth=depth,
            measured_hit_rate=rate)
        return new

    # -- re-optimization ------------------------------------------------
    def note_seeded(self, site: str) -> None:
        """The site's capacity plan came from the plan store — the one
        class of learned state an overprovision audit may invalidate."""
        with self._lock:
            self._seeded.add(site)

    def mark_replan(self, site: str, reason: str) -> None:
        """Flag ``site`` for re-optimization: its next plan choice
        invalidates the learned entry and re-chooses from current
        data. Idempotent; consumed by :meth:`take_replan`."""
        with self._lock:
            self._replan.setdefault(site, reason)

    def take_replan(self, site: str) -> Optional[str]:
        """Consume a pending re-optimization mark for ``site``. The
        consumer performs the re-choice, so consumption is what the
        ``planner_replans`` counter counts (a mark that never reaches
        a plan choice again re-optimized nothing)."""
        with self._lock:
            why = self._replan.pop(site, None)
            if why is not None:
                self.replans += 1
            return why

    def note_replan(self) -> None:
        """A re-optimization performed WITHOUT a prior mark (the
        pre-dispatch guaranteed-miss re-choice)."""
        with self._lock:
            self.replans += 1

    def note_switch(self) -> None:
        """A re-choice actually changed the plan (different strategy,
        re-ratcheted capacities, flipped verdict, proactive split)."""
        with self._lock:
            self.switches += 1

    def on_audit(self, rec) -> None:
        """Decision-ledger audit hook (common/decisions.py resolve):
        joined actuals whose error exceeds the threshold mark their
        site for re-optimization. Deliberately narrow per kind:

        * ``xchg_optimistic`` — a "hit" whose cached output capacity
          overshoots the measured need by more than the threshold, on
          a STORE-SEEDED site (in-process capacities are pow2-ratcheted
          from measured data and cannot lie), re-ratchets from scratch.
          Misses need no mark: the heal already re-chose.
        * ``prune`` — an observed prune fraction off the predicted one
          by more than the threshold re-evaluates the verdict on the
          next use instead of waiting out the periodic resync window.

        Everything else (admission estimates self-correct on first
        measure, strategy records are informational padding ratios) is
        audited but never triggers a replan."""
        err = rec.err_log2
        if err is None:
            return
        if rec.kind == "xchg_optimistic":
            if rec.verdict == "hit" and err > self.err_threshold \
                    and rec.site in self._seeded:
                self.mark_replan(
                    rec.site,
                    f"seeded capacity overshoots measured need "
                    f"{2 ** err:.1f}x")
        elif rec.kind == "prune":
            if abs(err) > self.err_threshold:
                self.mark_replan(
                    rec.site,
                    f"observed prune fraction off the prediction "
                    f"{2 ** abs(err):.1f}x")
        elif rec.kind == "io_prefetch":
            # predicted = 1.0 (perfect hit rate); a measured rate
            # under the target means the consumer outran the
            # readahead — grow that SITE's depth on its next run. A
            # rate holding >= IO_HIT_SHRINK two runs straight means
            # the depth overshoots — shrink it back toward default.
            rate = rec.actual
            if rate is None:
                return
            with self._lock:
                self._io_rate[rec.site] = float(rate)
                if rate >= self.IO_HIT_SHRINK:
                    streak = self._io_hi_streak.get(rec.site, 0) + 1
                    self._io_hi_streak[rec.site] = streak
                    if streak >= 2:
                        self._io_shrink.setdefault(
                            rec.site,
                            f"prefetch hit rate held >= "
                            f"{self.IO_HIT_SHRINK:.2f} for {streak} "
                            f"consecutive runs: learned depth "
                            f"overshoots")
                else:
                    self._io_hi_streak[rec.site] = 0
                    self._io_shrink.pop(rec.site, None)
            if rate < self.IO_HIT_TARGET:
                self.mark_replan(
                    rec.site,
                    f"prefetch hit rate {rate:.2f} under the "
                    f"{self.IO_HIT_TARGET:.2f} target")

    def record_replan(self, led, site: str, chosen: str, predicted,
                      rejected, reason: str, **inputs: Any) -> None:
        """The switched decision, with both plans' costs, in the
        ledger — what ``ctx.explain()`` shows for a re-optimization."""
        if led is not None:
            led.record("replan", site, chosen, predicted=predicted,
                       rejected=rejected, reason=reason, **inputs)

    def stats(self) -> dict:
        with self._lock:
            return {"planner_replans": self.replans,
                    "planner_switches": self.switches}
