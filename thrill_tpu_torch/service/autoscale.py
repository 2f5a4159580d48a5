"""Autoscaling policy: when the mesh should resize (counterpart of the
reference package's ``service/autoscale.py``).

W is a property of a generation (``Context.resize``), and
``Context.resize_processes`` makes a change of the process count one
supervised move; this module decides when. It is a deterministic,
tick-counted state machine fed by the metrics the service plane already
exports (queue depth, ``jobs_rejected``, the per-tenant serve-latency
p99 behind ``overall_stats()`` and the Prometheus endpoint).

* **Deterministic core.** :meth:`Autoscaler.observe` consumes one
  metric sample and returns a target W or ``None``: no wall clocks, no
  randomness, no I/O. Hysteresis is counted in ticks (consecutive
  confirmation and cooldown), so a test pins the exact decision tick by
  feeding a metric sequence, and every process of a mesh can run one
  Autoscaler over the same sequence and reach the same decision.
* **Hysteresis both ways.** Scale-up needs ``confirm_ticks``
  consecutive hot samples past a high-watermark (queue depth, reject
  delta, or p99); scale-down needs ``idle_ticks`` consecutive idle
  samples (empty queue, nothing in flight, no rejects). Every decision
  starts a ``cooldown_ticks`` window in which no further decision
  fires.
* **Audited.** Every decision lands in the decision ledger
  (``kind=autoscale``: inputs, predicted target, chosen move, rejected
  hold) and therefore in ``ctx.explain()``.
* **Crash-safe.** The ``svc.autoscale.decide`` fault site fires at tick
  entry, before the sample changes any hysteresis state: an injected
  failure leaves streaks and cooldown as they were, and the next tick
  retries from the same state.

The live side (``maybe_start``, ``THRILL_TPU_AUTOSCALE_S`` ticks on a
daemon thread) is one-process only, and applies its decisions through
``Context.resize``, which a serving Context runs fenced between jobs: a
thread on one process calling a collective move would desync a mesh of
several processes, which drives the same policy from its job loop.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

from ..common import faults

#: fired at decision-tick entry, before the sample advances any
#: hysteresis state — an injected failure is a skipped tick, nothing
#: mutated, clean retry on the next tick
F_DECIDE = faults.declare("svc.autoscale.decide")


def _env_i(name: str, default: int) -> int:
    try:
        v = os.environ.get(name)
        return int(v) if v not in (None, "") else default
    except ValueError:
        return default


def _env_f(name: str, default: float) -> float:
    try:
        v = os.environ.get(name)
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


class AutoscalePolicy:
    """The knobs (all overridable by env; see README "Environment").

    High-watermarks trigger scale-UP when any one is crossed:
    ``up_queue`` (queue depth), ``up_rejects`` (jobs_rejected delta
    per tick), ``up_p99_ms`` (serve p99; 0 disables the latency
    trigger). Scale-DOWN on sustained idle tenancy only. W is clamped
    to ``[min_w, max_w]`` and moves ONE step per decision — the
    cheapest move that changes the signal, and the one the
    orchestrated resize amortizes best."""

    def __init__(self,
                 min_w: Optional[int] = None,
                 max_w: Optional[int] = None,
                 up_queue: Optional[int] = None,
                 up_rejects: Optional[int] = None,
                 up_p99_ms: Optional[float] = None,
                 confirm_ticks: Optional[int] = None,
                 idle_ticks: Optional[int] = None,
                 cooldown_ticks: Optional[int] = None) -> None:
        self.min_w = max(1, min_w if min_w is not None
                         else _env_i("THRILL_TPU_AUTOSCALE_MIN_W", 1))
        self.max_w = max(self.min_w,
                         max_w if max_w is not None
                         else _env_i("THRILL_TPU_AUTOSCALE_MAX_W", 4))
        self.up_queue = up_queue if up_queue is not None \
            else _env_i("THRILL_TPU_AUTOSCALE_UP_QUEUE", 8)
        self.up_rejects = up_rejects if up_rejects is not None \
            else _env_i("THRILL_TPU_AUTOSCALE_UP_REJECTS", 1)
        self.up_p99_ms = up_p99_ms if up_p99_ms is not None \
            else _env_f("THRILL_TPU_AUTOSCALE_UP_P99_MS", 0.0)
        self.confirm_ticks = max(1, confirm_ticks
                                 if confirm_ticks is not None
                                 else _env_i(
                                     "THRILL_TPU_AUTOSCALE_CONFIRM", 2))
        self.idle_ticks = max(1, idle_ticks if idle_ticks is not None
                              else _env_i(
                                  "THRILL_TPU_AUTOSCALE_IDLE_TICKS", 5))
        self.cooldown_ticks = max(0, cooldown_ticks
                                  if cooldown_ticks is not None
                                  else _env_i(
                                      "THRILL_TPU_AUTOSCALE_COOLDOWN",
                                      3))


class Autoscaler:
    """One Context's scaling policy.

    Pure use (tests, multi-process SPMD driving)::

        a = Autoscaler(policy=AutoscalePolicy(confirm_ticks=2))
        target = a.observe({"queue_depth": 12, ...}, current_w=2)

    Live use (``maybe_start``): a daemon thread samples the
    scheduler/front-door counters every ``THRILL_TPU_AUTOSCALE_S``
    seconds and applies decisions through ``apply_fn`` (default:
    ``ctx.resize`` on a single-process mesh — a multi-process mesh
    must drive the policy from its own job loop, see module doc)."""

    def __init__(self, ctx=None,
                 policy: Optional[AutoscalePolicy] = None,
                 apply_fn: Optional[Callable[[int], None]] = None,
                 tick_s: Optional[float] = None) -> None:
        self.ctx = ctx
        self.policy = policy or AutoscalePolicy()
        self.apply_fn = apply_fn
        self.tick_s = tick_s if tick_s is not None \
            else _env_f("THRILL_TPU_AUTOSCALE_S", 0.0)
        # hysteresis state — mutated ONLY by observe(), after the
        # fault site in tick() had its chance to abort the tick
        self._tick = 0
        self._hot = 0
        self._idle = 0
        self._cooldown = 0
        self._last_rejected: Optional[int] = None
        # observability (overall_stats: autoscale_decisions)
        self.decisions_made = 0
        self.last_decision: Optional[dict] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic core ---------------------------------------------
    def observe(self, m: Dict[str, float], current_w: int
                ) -> Optional[int]:
        """Consume one metric sample; return the target W of a
        scaling decision, or None. ``m`` keys: ``queue_depth``,
        ``jobs_rejected`` (cumulative), ``jobs_in_flight``,
        ``serve_p99_ms``. Pure: ticks are the only clock."""
        p = self.policy
        self._tick += 1
        rejected = int(m.get("jobs_rejected", 0))
        if self._last_rejected is None:
            reject_delta = 0
        else:
            reject_delta = max(0, rejected - self._last_rejected)
        self._last_rejected = rejected
        depth = int(m.get("queue_depth", 0))
        inflight = int(m.get("jobs_in_flight", 0))
        p99 = float(m.get("serve_p99_ms", 0.0))
        hot = (depth > p.up_queue
               or reject_delta >= max(1, p.up_rejects)
               or (p.up_p99_ms > 0 and p99 > p.up_p99_ms))
        idle = depth == 0 and inflight == 0 and reject_delta == 0
        if hot:
            self._hot += 1
            self._idle = 0
        elif idle:
            self._idle += 1
            self._hot = 0
        else:
            self._hot = 0
            self._idle = 0
        if self._cooldown > 0:
            # streaks keep counting through the cooldown so a
            # sustained condition fires on the first eligible tick,
            # but no decision lands inside the window
            self._cooldown -= 1
            return None
        target: Optional[int] = None
        why = ""
        if self._hot >= p.confirm_ticks and current_w < p.max_w:
            target = current_w + 1
            why = (f"hot x{self._hot}: depth={depth} "
                   f"rejects+{reject_delta} p99={p99:.0f}ms")
        elif self._idle >= p.idle_ticks and current_w > p.min_w:
            target = current_w - 1
            why = f"idle x{self._idle}"
        if target is None:
            return None
        self._hot = 0
        self._idle = 0
        self._cooldown = p.cooldown_ticks
        self.decisions_made += 1
        self.last_decision = {
            "tick": self._tick, "from_w": current_w, "to_w": target,
            "queue_depth": depth, "rejects_delta": reject_delta,
            "p99_ms": p99, "reason": why}
        self._ledger(current_w, target, depth, reject_delta, p99, why)
        return target

    def _ledger(self, w: int, target: int, depth: int,
                reject_delta: int, p99: float, why: str) -> None:
        ctx = self.ctx
        led = getattr(ctx, "decisions", None) if ctx is not None \
            else None
        if led is None or not led.enabled:
            return
        led.record(
            "autoscale", "svc.autoscale.decide",
            f"resize:{w}->{target}", predicted=float(target),
            rejected=[(f"hold:{w}", None)], reason=why,
            tick=self._tick, queue_depth=depth,
            rejects_delta=reject_delta, p99_ms=round(p99, 1))
        log = getattr(ctx, "logger", None)
        if log is not None and log.enabled:
            log.line(event="autoscale_decision", from_w=w,
                     to_w=target, tick=self._tick, queue_depth=depth,
                     rejects_delta=reject_delta,
                     p99_ms=round(p99, 1))

    # -- live side ------------------------------------------------------
    def sample(self) -> Dict[str, float]:
        """One live metric sample off the Context's service plane —
        the same counters ``overall_stats()``/Prometheus export, read
        directly so a tick never pays a full stats merge."""
        ctx = self.ctx
        m: Dict[str, float] = {"queue_depth": 0, "jobs_rejected": 0,
                               "jobs_in_flight": 0, "serve_p99_ms": 0.0}
        if ctx is None:
            return m
        svc = ctx.service
        if svc is not None:
            with svc._cv:
                m["queue_depth"] = svc.queue.depth
                m["jobs_rejected"] = svc.jobs_rejected
                m["jobs_in_flight"] = max(
                    0, svc.jobs_submitted - svc.jobs_done)
            q = svc.latency_quantiles().get("serve_p99_ms", {})
            if q:
                m["serve_p99_ms"] = max(q.values())
        fd = getattr(ctx, "front_door", None)
        if fd is not None:
            m["jobs_rejected"] += fd.jobs_rejected
        return m

    def tick(self) -> Optional[int]:
        """One live decision tick: fault gate, sample, observe. The
        fault site fires BEFORE the sample is consumed, so an injected
        failure mutates nothing — streaks, cooldown and the reject
        baseline all retry identical on the next tick."""
        faults.check(F_DECIDE, tick=self._tick + 1)
        ctx = self.ctx
        w = ctx.num_workers if ctx is not None else 0
        return self.observe(self.sample(), w)

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            ctx = self.ctx
            if ctx is None or ctx._closed:
                return
            try:
                target = self.tick()
            except faults.InjectedFault:
                continue              # skipped tick; state untouched
            if target is None:
                continue
            try:
                if self.apply_fn is not None:
                    self.apply_fn(target)
                else:
                    ctx.resize(target)
            except Exception as e:
                faults.note("recovery", what="svc.autoscale.apply",
                            target=target, error=repr(e)[:200])

    def start(self) -> "Autoscaler":
        if self._thread is None and self.tick_s > 0:
            self._thread = threading.Thread(
                target=self._loop, name="thrill-autoscale",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout)

    def stats(self) -> dict:
        return {"autoscale_decisions": self.decisions_made,
                "autoscale_ticks": self._tick}


def maybe_start(ctx) -> Optional[Autoscaler]:
    """Start the live policy thread when ``THRILL_TPU_AUTOSCALE_S``
    names a tick period (mirrors front_door/metrics maybe_start).
    Single-process only — per-rank threads deciding on their own
    timing would desync a multi-process mesh's collective resize;
    those deployments drive
    the policy from the job loop instead (module doc)."""
    period = _env_f("THRILL_TPU_AUTOSCALE_S", 0.0)
    if period <= 0:
        return None
    if ctx.mesh_exec.num_processes > 1 or ctx.net.num_workers > 1:
        import sys
        print("thrill_tpu.service: THRILL_TPU_AUTOSCALE_S ignored on "
              "a multi-process mesh — drive the Autoscaler from the "
              "job loop so every rank reaches the same decision "
              "(ARCHITECTURE.md \"Elastic mesh, phase 2\")",
              file=sys.stderr)
        return None
    return Autoscaler(ctx, tick_s=period).start()
