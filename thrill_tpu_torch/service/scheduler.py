"""Concurrent pipeline scheduling on one long-lived Context
(counterpart of the reference package's ``service/scheduler.py``).

``ctx.submit(pipeline_fn, tenant=...)`` accepts pipelines from any
number of client threads and returns a :class:`JobFuture`. One
dispatcher thread drains the queue and runs each job on the mesh: the
Context is not re-entrant, so jobs serialize on the card; concurrency
buys queueing, fairness and isolation, not co-scheduling. Every CUDA
call of a served job is made on the dispatcher thread (the job's
inputs, kernels, fetches and, through the front door, the copy of its
result to the host), so a whole-loop CUDA graph captures there as it
does on the thread that made the Context. Each job runs inside its own
``ctx.pipeline()`` failure domain (api/context.py): a failing job
surfaces its :class:`~thrill_tpu_torch.api.context.PipelineError` into
its own future while the Context heals that generation, and later jobs
run normally. An unrecoverable verdict (a dead peer, a sticky CUDA
error, a failed heal) fails the whole queue: that Context cannot serve
any more and a supervised relaunch owns it.

Fairness is start-time weighted-fair queueing (SFQ) across tenants:
job ``start_tag = max(global_vtime, tenant.finish)``, ``tenant.finish
= start_tag + 1/weight``; the dispatcher always runs the queued job
with the smallest start tag (ties break by tenant name, then FIFO), so
a tenant with weight 2 gets about twice the job slots of a weight-1
tenant under sustained load while an idle tenant's first job is
admitted at once. Weights come from ``THRILL_TPU_SERVE_WEIGHTS``
("a=3,b=1") or per-submit ``weight=``.

Admission order across processes: there is no central master; every
process submits the same jobs at the same program points (the lockstep
contract every collective already has), but client-thread timing may
enqueue them in different local orders. Rank 0's dispatcher therefore
picks the next job and broadcasts an ordering frame ``(tenant,
tenant_seq, name)`` over the host control plane (``ctx.net``); the
other processes run exactly that job, so the gloo collectives of the
job are issued in the same order everywhere. The frames ride the same
generation-tagged wire as every control frame, so a heal's stale-frame
drain discards the frames of an aborted generation too.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..common import faults

# fired at job admission, INSIDE the job's pipeline() failure domain:
# an armed fire aborts exactly that job's generation — its future gets
# the PipelineError, the Context heals, the next job runs normally
_F_SUBMIT = faults.declare("service.submit")


class ShedLoad(RuntimeError):
    """Base of every typed admission rejection — a shed job's future
    (and the front door's reject frame) always carries one of these,
    never a silent drop. ``kind`` is the rejection taxonomy label
    (``rate_limited``, ``tenant_queue_full``, ``queue_full``);
    ``retry_after_s``
    is the server's backoff hint — the earliest moment a retry could
    plausibly be admitted (queue drain estimate for depth sheds, token
    refill time for rate sheds). Clients honoring it
    (service/client.py submit_retry) turn an overload spike into a
    delayed success instead of a retry storm."""

    kind = "shed"

    def __init__(self, msg: str, tenant: str,
                 retry_after_s: float = 0.0) -> None:
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = max(float(retry_after_s), 0.0)


class QueueFull(ShedLoad):
    """submit() shed this job: the admission queue sits at its
    THRILL_TPU_SERVE_QUEUE depth cap. The rejection is IMMEDIATE and
    per-job — the returned future is born resolved with this error,
    nothing was queued, and the scheduler keeps serving everything
    already admitted. Carries the tenant and the depth/cap pair so a
    client's backpressure loop can tell "my tenant is flooding" from
    "the service is drowning"."""

    kind = "queue_full"

    def __init__(self, tenant: str, depth: int, cap: int,
                 retry_after_s: float = 0.0) -> None:
        super().__init__(
            f"admission queue full: depth {depth} >= cap {cap} "
            f"(THRILL_TPU_SERVE_QUEUE); job for tenant {tenant!r} shed",
            tenant, retry_after_s)
        self.depth = depth
        self.cap = cap


class TenantQueueFull(ShedLoad):
    """submit() shed this job: THIS tenant's queue sits at its
    THRILL_TPU_SERVE_TENANT_QUEUE depth cap. Per-tenant bounding is
    the isolation half of backpressure: one flooding tenant fills its
    own queue and sheds, while every other tenant keeps its full
    admission depth."""

    kind = "tenant_queue_full"

    def __init__(self, tenant: str, depth: int, cap: int,
                 retry_after_s: float = 0.0) -> None:
        super().__init__(
            f"tenant queue full: tenant {tenant!r} at depth {depth} "
            f">= cap {cap} (THRILL_TPU_SERVE_TENANT_QUEUE); job shed",
            tenant, retry_after_s)
        self.depth = depth
        self.cap = cap


class RateLimited(ShedLoad):
    """submit() shed this job: the tenant's token bucket
    (THRILL_TPU_SERVE_RATE) is empty. ``retry_after_s`` is the exact
    refill time of the next token — the one rejection whose hint is a
    guarantee, not an estimate."""

    kind = "rate_limited"

    def __init__(self, tenant: str, rate: float,
                 retry_after_s: float) -> None:
        super().__init__(
            f"rate limited: tenant {tenant!r} over {rate:g} jobs/s "
            f"(THRILL_TPU_SERVE_RATE); retry after "
            f"{retry_after_s:.3f}s", tenant, retry_after_s)
        self.rate = rate


def _queue_cap(var: str = "THRILL_TPU_SERVE_QUEUE") -> int:
    """Admission depth cap from ``var``; 0 = unbounded (the default).
    Malformed values are skipped loudly — a typo must not silently
    shed traffic."""
    v = os.environ.get(var, "")
    if not v:
        return 0
    try:
        cap = int(v)
    except ValueError:
        import sys
        print(f"thrill_tpu.service: ignoring malformed "
              f"{var}={v!r} (want an integer); "
              f"queue is unbounded", file=sys.stderr)
        return 0
    return max(cap, 0)


class _TokenBucket:
    """One tenant's admission token bucket: ``rate`` tokens/s refill,
    ``burst`` capacity (a freshly-seen tenant starts full, so a burst
    up to ``burst`` jobs is admitted before pacing kicks in)."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t_last = time.monotonic()

    def try_take(self) -> float:
        """0.0 when a token was taken (admitted); else the seconds
        until the next token exists — the retry-after hint."""
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


def _rate_entry(v: str):
    """One THRILL_TPU_SERVE_RATE value: ``rps`` or ``rps:burst``."""
    rps, _, burst = v.partition(":")
    r = float(rps)
    if r <= 0:
        raise ValueError(v)
    b = float(burst) if burst else max(1.0, r)
    if b < 1.0:
        raise ValueError(v)
    return (r, b)


def _parse_rates(spec: str) -> Dict[str, tuple]:
    """Parse THRILL_TPU_SERVE_RATE ("a=5,b=2:10,default=50") —
    jobs/s[:burst] per tenant; the ``default`` key covers tenants not
    named. Malformed entries are skipped loudly."""
    from ..common.config import parse_kv_spec
    return parse_kv_spec(spec, _rate_entry, "SERVE_RATE")


def _weight(v: str) -> float:
    w = float(v)
    if w <= 0:
        raise ValueError(v)
    return w


#: accept-to-result latency histogram buckets: fixed log2 boundaries,
#: bucket i = [2^(i-1), 2^i) milliseconds (bucket 0 = sub-millisecond).
#: 28 buckets reach ~37 hours. The BUCKETING is deterministic — two
#: runs whose jobs land in the same buckets report identical
#: serve_p50/p99 — which is what lets the quantiles ride stats
#: contracts where raw wall clocks cannot.
_LAT_BUCKETS = 28


def _lat_bucket(ms: float) -> int:
    return min(max(int(ms), 0).bit_length(), _LAT_BUCKETS - 1)


def _lat_quantile(counts: List[int], q: float) -> float:
    """Upper bucket boundary (ms) at quantile ``q`` — 2^i for bucket
    i, deterministic given the counts."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    need = max(1, -(-int(total * q * 1000) // 1000))  # ceil(q*total)
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= need:
            return float(1 << i)
    return float(1 << (_LAT_BUCKETS - 1))


def _parse_weights(spec: str) -> Dict[str, float]:
    """Parse THRILL_TPU_SERVE_WEIGHTS ("a=3,b=1.5"); malformed entries
    are skipped loudly (a typo must not silently starve a tenant)."""
    from ..common.config import parse_kv_spec
    return parse_kv_spec(spec, _weight, "SERVE_WEIGHTS")


class JobFuture:
    """Handle to one submitted pipeline.

    ``result()`` blocks until the job ran and returns its value — or
    raises the job's error (:class:`~thrill_tpu_torch.api.context.
    PipelineError` for
    a scoped pipeline failure, the original abort for an unrecoverable
    one). ``queue_wait_s`` / ``run_s`` / ``generation`` are populated
    when the job completes."""

    def __init__(self, job_id: int, tenant: str, name: str) -> None:
        self.job_id = job_id
        self.tenant = tenant
        self.name = name
        self.queue_wait_s = 0.0
        self.run_s = 0.0
        self.generation: Optional[int] = None
        # plan choices the decision ledger recorded while THIS job
        # ran (the serve lane's plan-choices-per-job metric)
        self.plan_decisions = 0
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def _finish(self, result: Any = None,
                error: Optional[BaseException] = None) -> None:
        self._result = result
        self._error = error
        self._event.set()

    @classmethod
    def failed(cls, job_id: int, tenant: str, name: str,
               error: BaseException) -> "JobFuture":
        """A future born resolved-with-error: the one shape every
        rejected submission (dead scheduler, closing scheduler, closed
        Context) hands back."""
        fut = cls(job_id, tenant, name)
        fut._finish(error=error)
        return fut

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"job {self.job_id} ({self.name}) still "
                               f"queued/running after {timeout}s")
        return self._error

    def result(self, timeout: Optional[float] = None) -> Any:
        err = self.exception(timeout)
        if err is not None:
            raise err
        return self._result


class _Job:
    __slots__ = ("fn", "tenant", "name", "future", "t_submit",
                 "tenant_seq", "start_tag")

    def __init__(self, fn, tenant: str, name: str, future: JobFuture,
                 tenant_seq: int, start_tag: float) -> None:
        self.fn = fn
        self.tenant = tenant
        self.name = name
        self.future = future
        self.t_submit = time.monotonic()
        self.tenant_seq = tenant_seq
        self.start_tag = start_tag


class _TenantQ:
    __slots__ = ("weight", "finish", "jobs", "seq")

    def __init__(self, weight: float) -> None:
        self.weight = weight
        self.finish = 0.0         # virtual finish tag of the last job
        self.jobs: List[_Job] = []
        self.seq = 0              # per-tenant submission counter


class WfqQueue:
    """Start-time fair queue over per-tenant FIFOs (caller locks)."""

    def __init__(self, weights: Optional[Dict[str, float]] = None) -> None:
        self._tenants: Dict[str, _TenantQ] = {}
        self._weights = dict(weights or {})
        self._vtime = 0.0          # start tag of the job last serviced
        self.depth = 0
        self.depth_peak = 0

    def set_weight(self, tenant: str, weight: float) -> None:
        self._weights[tenant] = float(weight)
        tq = self._tenants.get(tenant)
        if tq is not None:
            tq.weight = float(weight)

    def tenant_depth(self, tenant: str) -> int:
        tq = self._tenants.get(tenant)
        return len(tq.jobs) if tq is not None else 0

    def push(self, fn, tenant: str, name: str, future: JobFuture) -> _Job:
        tq = self._tenants.get(tenant)
        if tq is None:
            tq = self._tenants[tenant] = _TenantQ(
                self._weights.get(tenant, 1.0))
        start = max(self._vtime, tq.finish)
        tq.finish = start + 1.0 / tq.weight
        tq.seq += 1
        if not name:
            name = f"{tenant}-{tq.seq}"
            future.name = name
        job = _Job(fn, tenant, name, future, tq.seq, start)
        tq.jobs.append(job)
        self.depth += 1
        if self.depth > self.depth_peak:
            self.depth_peak = self.depth
        return job

    def pop(self) -> Optional[_Job]:
        """The queued job with the smallest start tag (ties: tenant
        name, then FIFO — per-tenant FIFOs keep submission order)."""
        best_t = None
        for t, tq in sorted(self._tenants.items()):
            if not tq.jobs:
                continue
            if best_t is None or (tq.jobs[0].start_tag
                                  < self._tenants[best_t].jobs[0].start_tag):
                best_t = t
        if best_t is None:
            return None
        job = self._tenants[best_t].jobs.pop(0)
        self.depth -= 1
        self._vtime = max(self._vtime, job.start_tag)
        return job

    def take(self, tenant: str, tenant_seq: int) -> Optional[_Job]:
        """Remove a SPECIFIC job (non-root ranks following rank 0's
        ordering frame). None until the lockstep submission arrives."""
        tq = self._tenants.get(tenant)
        if tq is None:
            return None
        for i, job in enumerate(tq.jobs):
            if job.tenant_seq == tenant_seq:
                tq.jobs.pop(i)
                self.depth -= 1
                self._vtime = max(self._vtime, job.start_tag)
                return job
        return None

    def drain(self) -> List[_Job]:
        out = [j for tq in self._tenants.values() for j in tq.jobs]
        for tq in self._tenants.values():
            tq.jobs.clear()
        self.depth = 0
        return out


class Scheduler:
    """Owns the admission queue and the dispatcher thread of one
    Context. Constructed lazily by ``Context.submit``."""

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        from . import tenancy
        tenancy.configure(ctx)          # env budgets, idempotent
        self._cv = threading.Condition()
        self.queue = WfqQueue(_parse_weights(
            os.environ.get("THRILL_TPU_SERVE_WEIGHTS", "")))
        self.jobs_submitted = 0
        self.jobs_failed = 0
        # bounded admission (THRILL_TPU_SERVE_QUEUE): jobs shed at the
        # cap, total and per tenant. Enforced ONLY on single-controller
        # meshes — admission is per-rank client-thread timing, so two
        # controllers could legally disagree on which submit hits the
        # cap, and a job rank 0 runs that a follower rejected wedges
        # the mesh collectives. Multi-controller: loud one-time skip.
        self.queue_cap = _queue_cap()
        # per-tenant backpressure: a flooding tenant fills
        # its OWN bounded queue / drains its OWN token bucket and
        # sheds, while other tenants keep their full admission depth.
        # Same single-controller-only rule as the global cap.
        self.tenant_queue_cap = _queue_cap("THRILL_TPU_SERVE_TENANT_QUEUE")
        self._rates = _parse_rates(
            os.environ.get("THRILL_TPU_SERVE_RATE", ""))
        self._buckets: Dict[str, _TokenBucket] = {}
        self.jobs_rejected = 0
        self.jobs_rate_limited = 0
        self.rejected_by_tenant: Dict[str, int] = {}
        # EWMA of completed-job run seconds: the drain-time estimate
        # behind queue-full retry-after hints (depth * ewma)
        self._run_ewma_s = 0.0
        self._cap_skip_noted = False
        # resize fencing (Context.resize): callables the dispatcher
        # runs EXCLUSIVELY, between jobs — never concurrent with a
        # pipeline that would trace W-shaped programs mid-swap
        self._fences: List[Any] = []
        # jobs that LEFT the system (resolved any way: result, scoped
        # failure, drain) — the live metrics endpoint's jobs_in_flight
        # gauge is submitted - done (common/metrics.py)
        self.jobs_done = 0
        # per-tenant accept-to-result latency histograms (fixed log2
        # buckets — see _LAT_BUCKETS): serve_p50/p99 in
        # overall_stats() and the Prometheus histogram export both
        # read these. Only jobs that RAN are recorded (a drained
        # future's latency is the shutdown's, not the service's).
        self._lat: Dict[str, List[int]] = {}
        self._lat_count: Dict[str, int] = {}
        self._lat_sum_ms: Dict[str, float] = {}
        self._job_ids = 0
        self._closing = False
        self._dead: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, name="thrill-serve-dispatch", daemon=True)
        self._thread.start()

    # -- client side ----------------------------------------------------
    def submit(self, fn: Callable, tenant: str = "default",
               name: str = "", weight: Optional[float] = None
               ) -> JobFuture:
        """Queue ``fn(ctx) -> result`` for execution; thread-safe."""
        with self._cv:
            self._job_ids += 1
            # the default name must be RANK-DETERMINISTIC under the
            # per-tenant lockstep contract: the global job counter
            # depends on how tenants' client threads interleave, which
            # may legally differ across ranks — the follower's
            # divergence check compares names, so a counter-based
            # default would poison a legal submission order. The
            # per-tenant seq is what the contract agrees on.
            if self._dead is not None:
                return JobFuture.failed(
                    self._job_ids, tenant,
                    name or f"job-{self._job_ids}",
                    RuntimeError(
                        f"scheduler is dead after an unrecoverable "
                        f"abort: {self._dead!r}"))
            if self._closing:
                return JobFuture.failed(
                    self._job_ids, tenant,
                    name or f"job-{self._job_ids}",
                    RuntimeError("scheduler is closed"))
            err = self._admission_verdict(tenant)
            if err is not None:
                if self.ctx.net.num_workers > 1 \
                        or self.ctx.mesh_exec.num_processes > 1:
                    # cross-rank divergent rejection would be fatal
                    # (see __init__) — never shed on multi-controller
                    if not self._cap_skip_noted:
                        self._cap_skip_noted = True
                        import sys
                        print("thrill_tpu.service: THRILL_TPU_SERVE_"
                              "QUEUE / _TENANT_QUEUE / _RATE ignored "
                              "on a multi-controller mesh — per-rank "
                              "shed decisions could diverge and "
                              "desync the lockstep admission "
                              "contract; admission is unbounded",
                              file=sys.stderr)
                else:
                    return self._reject(tenant, name, err)
            future = JobFuture(self._job_ids, tenant, name)
            if weight is not None:
                self.queue.set_weight(tenant, weight)
            job = self.queue.push(fn, tenant, future.name, future)
            self.jobs_submitted += 1
            depth = self.queue.depth
            self._cv.notify_all()
        log = self.ctx.logger
        if log.enabled:
            log.line(event="job_submit", job=future.job_id,
                     name=future.name, tenant=tenant,
                     queue_depth=depth)
        return future

    def _admission_verdict(self, tenant: str) -> Optional[ShedLoad]:
        """The typed shed verdict for one would-be submission, or None
        when admitted (caller holds _cv). Check order: rate limit
        first (cheapest hint, and a paced tenant should not consume
        queue headroom), then the tenant depth cap, then the global
        cap. Retry-after hints: token refill time is exact; depth
        sheds estimate drain as depth * run-seconds EWMA."""
        rate = self._rates.get(tenant) or self._rates.get("default")
        if rate is not None:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = _TokenBucket(*rate)
            wait = bucket.try_take()
            if wait > 0.0:
                return RateLimited(tenant, rate[0], wait)
        ewma = self._run_ewma_s or 0.05
        if self.tenant_queue_cap:
            depth = self.queue.tenant_depth(tenant)
            if depth >= self.tenant_queue_cap:
                return TenantQueueFull(
                    tenant, depth, self.tenant_queue_cap,
                    retry_after_s=round(depth * ewma, 3))
        if self.queue_cap and self.queue.depth >= self.queue_cap:
            depth = self.queue.depth
            return QueueFull(tenant, depth, self.queue_cap,
                             retry_after_s=round(depth * ewma, 3))
        return None

    def _reject(self, tenant: str, name: str,
                err: ShedLoad) -> JobFuture:
        """Shed one job with its typed verdict (caller holds _cv)."""
        self.jobs_rejected += 1
        if isinstance(err, RateLimited):
            self.jobs_rate_limited += 1
        n = self.rejected_by_tenant.get(tenant, 0) + 1
        self.rejected_by_tenant[tenant] = n
        fut = JobFuture.failed(self._job_ids, tenant,
                               name or f"job-{self._job_ids}", err)
        log = self.ctx.logger
        if log.enabled:
            log.line(event="job_reject", tenant=tenant, kind=err.kind,
                     retry_after_s=err.retry_after_s,
                     depth=self.queue.depth, tenant_rejected=n,
                     jobs_rejected=self.jobs_rejected)
        if n == 1:
            # first shed PER TENANT goes to stderr: a flooding client
            # must be visible even without the JSON log
            import sys
            print(f"thrill_tpu.service: shedding load for tenant "
                  f"{tenant!r} — {err}", file=sys.stderr)
        return fut

    def fence(self, fn: Callable[[], Any],
              timeout: Optional[float] = None) -> Any:
        """Run ``fn()`` EXCLUSIVELY on the dispatcher thread, at the
        next job boundary, and return its result (or re-raise its
        error). Fences take PRIORITY over queued jobs — under
        sustained traffic the queue may never drain, and a resize must
        not wait for it. This is how ``Context.resize`` swaps the mesh
        under live traffic: the in-flight job finishes on the old W,
        queued jobs run on the new — no pipeline ever observes a
        half-swapped mesh.

        Deliberately NOT wrapped in ``ctx.pipeline()``: pipeline()
        restores the parent generation on exit, which would undo the
        generation bump a resize performs. Single-controller only (the
        callers that need multi-controller coordination — there are
        none today — would have to broadcast the fence like a job)."""
        if self.ctx.net.num_workers > 1 \
                or self.ctx.mesh_exec.num_processes > 1:
            raise RuntimeError(
                "Scheduler.fence is single-controller only: a fence is "
                "not part of the cross-rank admission agreement")
        done = threading.Event()
        cell: Dict[str, Any] = {}
        with self._cv:
            if self._dead is not None:
                raise RuntimeError(
                    f"scheduler is dead after an unrecoverable abort: "
                    f"{self._dead!r}")
            self._fences.append((fn, done, cell))
            self._cv.notify_all()
        if not done.wait(timeout):
            raise TimeoutError(
                f"fence did not run within {timeout}s (dispatcher "
                f"busy or stopped)")
        if "error" in cell:
            raise cell["error"]
        return cell.get("result")

    def _run_fence(self, fence) -> None:
        fn, done, cell = fence
        try:
            cell["result"] = fn()
        except BaseException as e:
            cell["error"] = e
        finally:
            done.set()

    def _fail_fences(self, fences, cause: str) -> None:
        for _fn, done, cell in fences:
            cell["error"] = RuntimeError(cause)
            done.set()

    @property
    def alive(self) -> bool:
        """The dispatcher thread still owns the mesh/control plane."""
        return self._thread.is_alive()

    def stats(self) -> dict:
        with self._cv:
            return {"jobs_submitted": self.jobs_submitted,
                    "jobs_failed": self.jobs_failed,
                    "jobs_rejected": self.jobs_rejected,
                    "jobs_rate_limited": self.jobs_rate_limited,
                    "queue_depth_peak": self.queue.depth_peak}

    def _note_latency(self, tenant: str, seconds: float) -> None:
        ms = seconds * 1e3
        with self._cv:
            counts = self._lat.get(tenant)
            if counts is None:
                counts = self._lat[tenant] = [0] * _LAT_BUCKETS
                self._lat_count[tenant] = 0
                self._lat_sum_ms[tenant] = 0.0
            counts[_lat_bucket(ms)] += 1
            self._lat_count[tenant] += 1
            self._lat_sum_ms[tenant] += ms

    def latency_quantiles(self) -> dict:
        """Per-tenant accept-to-result p50/p99 (log2-bucket upper
        bounds, ms) — the overall_stats() serve-latency summary the
        front-door work will be judged by."""
        with self._cv:
            return {
                "serve_p50_ms": {t: _lat_quantile(c, 0.50)
                                 for t, c in sorted(self._lat.items())},
                "serve_p99_ms": {t: _lat_quantile(c, 0.99)
                                 for t, c in sorted(self._lat.items())},
            }

    def latency_histogram(self) -> dict:
        """Raw per-tenant histogram state for the Prometheus export:
        {tenant: (bucket_counts, count, sum_ms)}."""
        with self._cv:
            return {t: (list(c), self._lat_count[t],
                        self._lat_sum_ms[t])
                    for t, c in sorted(self._lat.items())}

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain queued jobs, then stop the dispatcher. Called by
        ``Context.close`` — submitted futures always resolve."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        t = self._thread
        if t.is_alive() and t is not threading.current_thread():
            from ..common.timeouts import scaled
            t.join(timeout=timeout if timeout is not None
                   else scaled(300.0))
            if t.is_alive():
                import sys
                print("thrill_tpu.service: dispatcher thread did not "
                      "drain before close timeout", file=sys.stderr)

    # -- dispatcher side ------------------------------------------------
    def _loop(self) -> None:
        while True:
            job = self._next_job()
            if job is None:
                break
            self._run(job)
        # whatever ended the loop, no submitted future may be left
        # pending — close()'s contract is that every future resolves
        # (_poison already drained on the dead paths; this covers a
        # rank whose local queue still held jobs at the sentinel).
        # Pending fences resolve too: a resize blocked on fence()
        # must not hang forever on a stopping dispatcher.
        with self._cv:
            stranded = self.queue.drain()
            fences, self._fences = self._fences, []
            self.jobs_failed += len(stranded)
            self.jobs_done += len(stranded)
        for job in stranded:
            job.future._finish(error=RuntimeError(
                "scheduler stopped before this job ran"))
        self._fail_fences(fences,
                          "scheduler stopped before this fence ran")

    def _next_job(self) -> Optional[_Job]:
        net = self.ctx.net
        multi = net.num_workers > 1
        if not multi or net.group.my_rank == 0:
            while True:
                fence = None
                with self._cv:
                    while True:
                        if self._dead is not None:
                            job = None
                            break
                        if self._fences:
                            # between-jobs exclusivity: the fence runs
                            # HERE, on the dispatcher thread, before
                            # the next job is even picked (fences are
                            # single-controller only — see fence())
                            fence = self._fences.pop(0)
                            job = None
                            break
                        job = self.queue.pop()
                        if job is not None or self._closing:
                            break
                        self._cv.wait()
                if fence is None:
                    break
                self._run_fence(fence)
            if multi:
                # the admission agreement: rank 0's pick becomes the
                # cluster's next job (or the drain sentinel). The
                # frame rides the generation-tagged control plane.
                # (tenant, tenant_seq) identifies the job ONLY when
                # each tenant's submission order agrees across ranks —
                # the per-tenant half of the lockstep contract (one
                # submitting thread per tenant, or an order the app
                # makes rank-deterministic). The job NAME rides along
                # so a violated contract dies loudly on the follower
                # instead of silently running different pipelines in
                # the same collective slot.
                frame = (None if job is None
                         else (job.tenant, job.tenant_seq, job.name))
                try:
                    net.broadcast(frame, origin=0)
                except Exception as e:
                    if job is not None:
                        # already popped: _poison's drain won't see it,
                        # count its failure here
                        with self._cv:
                            self.jobs_failed += 1
                            self.jobs_done += 1
                        job.future._finish(error=e)
                        self._poison(e)
                    return None
            return job
        # non-root: follow rank 0's ordering frame, then wait for the
        # lockstep submission to arrive locally
        try:
            frame = net.broadcast(None, origin=0)
        except Exception as e:
            self._poison(e)
            return None
        if frame is None:
            return None
        tenant, seq, name = frame
        with self._cv:
            while True:
                job = self.queue.take(tenant, seq)
                if job is not None:
                    if job.name != name:
                        # per-tenant submission order diverged across
                        # ranks: running this job in rank 0's slot
                        # would mismatch the mesh collectives — fail
                        # LOUDLY instead
                        err = RuntimeError(
                            f"cross-rank admission divergence: rank 0 "
                            f"announced ({tenant}, {seq}) = {name!r}, "
                            f"this rank holds {job.name!r} — tenant "
                            f"submission order must be "
                            f"rank-deterministic")
                        # already taken off the queue: _poison's drain
                        # won't see it — settle its counters here
                        # (the Condition's RLock tolerates the nested
                        # _poison acquisition)
                        self.jobs_failed += 1
                        self.jobs_done += 1
                        job.future._finish(error=err)
                        self._poison(err)
                        return None
                    return job
                if self._dead is not None:
                    return None
                # NOT an exit on _closing: rank 0 announced this job,
                # so by the lockstep contract the local submit is on
                # its way — leaving now would strand the future AND
                # desert rank 0 mid-collective. The drain sentinel
                # (frame is None) is the orderly exit; a violated
                # contract is bounded by close()'s join timeout (the
                # dispatcher is a daemon thread).
                self._cv.wait()

    def _run(self, job: _Job) -> None:
        ctx = self.ctx
        fut = job.future
        t0 = time.monotonic()
        fut.queue_wait_s = t0 - job.t_submit
        from ..api.context import PipelineError
        err: Optional[BaseException] = None
        # plan choices recorded during this job (decision ledger delta
        # across the run — the dispatcher serializes jobs, so the
        # delta is unambiguously this job's)
        led = getattr(ctx, "decisions", None)
        dec0 = (sum(led.kind_counts.values())
                if led is not None and led.enabled else None)

        def settle_decisions() -> None:
            # must run BEFORE fut._finish: result() unblocks the
            # client the instant the future's event is set, and a
            # client reading fut.plan_decisions right after result()
            # must not race the dispatcher's bookkeeping
            if dec0 is not None:
                fut.plan_decisions = (sum(led.kind_counts.values())
                                      - dec0)

        tr = getattr(ctx, "tracer", None)
        sp = None
        if tr is not None and tr.enabled:
            # the queue-wait bar (submit -> start, measured on the
            # monotonic clock the scheduler already uses) and the run
            # span; every dispatch/exchange/loop span the job's
            # pipeline emits nests under the run span and inherits the
            # job name through the tracer's current_job tag
            now = time.perf_counter()
            tr.emit_span("service", "queue_wait",
                         now - fut.queue_wait_s, now,
                         job=fut.name, tenant=job.tenant)
            sp = tr.begin("service", f"job:{fut.name}",
                          tenant=job.tenant, job=fut.name,
                          job_id=fut.job_id)
            tr.current_job = fut.name
        try:
            with ctx.pipeline(name=job.name) as gen:
                fut.generation = gen
                ctx.current_tenant = job.tenant
                faults.check(_F_SUBMIT, job=fut.job_id,
                             tenant=job.tenant)
                out = job.fn(ctx)
            fut.run_s = time.monotonic() - t0
            settle_decisions()
            fut._finish(result=out)
        except PipelineError as e:
            # scoped failure: the Context healed; only THIS job failed
            err = e
            fut.generation = e.generation
            fut.run_s = time.monotonic() - t0
            with self._cv:
                self.jobs_failed += 1
            settle_decisions()
            fut._finish(error=e)
        except BaseException as e:
            # unrecoverable abort (dead peer, failed heal): the
            # Context cannot serve anymore — fail everything queued,
            # loudly; supervised relaunch owns recovery from here
            err = e
            fut.run_s = time.monotonic() - t0
            with self._cv:
                self.jobs_failed += 1
            settle_decisions()
            fut._finish(error=e)
            self._poison(e)
        finally:
            ctx.current_tenant = None
            # accept-to-result: submit() call to future resolution,
            # queue wait included — the latency a CLIENT of this
            # tenant actually observed for the job
            self._note_latency(job.tenant,
                               time.monotonic() - job.t_submit)
            with self._cv:
                self.jobs_done += 1
                # drain-time estimate behind retry-after hints
                self._run_ewma_s = (fut.run_s if not self._run_ewma_s
                                    else 0.8 * self._run_ewma_s
                                    + 0.2 * fut.run_s)
            if sp is not None:
                tr.current_job = None
                tr.end(sp, generation=fut.generation,
                       ok=err is None,
                       error=(repr(err)[:200] if err is not None
                              else None))
        log = ctx.logger
        if log.enabled:
            log.line(event="job_done", job=fut.job_id, name=fut.name,
                     tenant=job.tenant, ok=err is None,
                     generation=fut.generation,
                     queue_wait_s=round(fut.queue_wait_s, 4),
                     run_s=round(fut.run_s, 4),
                     plan_decisions=(fut.plan_decisions
                                     if dec0 is not None else None),
                     error=(repr(err)[:200] if err is not None
                            else None))

    def _poison(self, cause: BaseException) -> None:
        with self._cv:
            self._dead = cause
            stranded = self.queue.drain()
            fences, self._fences = self._fences, []
            self.jobs_failed += len(stranded)
            self.jobs_done += len(stranded)
            self._cv.notify_all()
        for job in stranded:
            job.future._finish(error=RuntimeError(
                f"job never ran: scheduler died after an unrecoverable "
                f"abort: {cause!r}"))
        self._fail_fences(
            fences, f"fence never ran: scheduler died after an "
                    f"unrecoverable abort: {cause!r}")
        faults.note("recovery", what="service.scheduler_dead",
                    stranded=len(stranded), error=repr(cause)[:200])
