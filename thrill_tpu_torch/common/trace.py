"""Tracing spine: correlated spans across the port's layers
(counterpart of the reference package's ``common/trace.py``).

The JSON log (common/logger.py) records flat event lines; this module
adds their correlation: spans with ``trace``/``span``/``parent`` ids and
a category lane per layer, so a timeline shows which dispatch, in which
exchange, of which loop iteration bounded the run. The choke points:

* ``parallel/mesh.py`` ``MeshExec.dispatch``: every program call (lane
  ``dispatch``), and ``api/loop.py``'s whole-loop CUDA graph launch;
* ``api/fusion.py`` ``FusionPlan.execute``: stitched segments
  (``fusion``), and the rung-3/4 degradations (``mem`` instants);
* ``data/exchange.py`` and ``api/ops/sort.py``: phase A, chunked phase
  B, the optimistic and synced plans, the Sort's fused ship-and-merge,
  and the deferred capacity verdicts (``exchange``);
* ``data/multiplexer.py``: the host exchange (``host``), and the
  background sender's ``async_send`` span a frame, parented under the
  exchange's span across the thread boundary;
* ``mem/pressure.py``: the ladder's rungs (``mem`` instants);
  ``mem/hbm.py`` and ``data/writeback.py``: restores and write-behind
  jobs (``io``);
* ``common/decisions.py`` and ``common/doctor.py``: plan choices, their
  audits and skew verdicts (``plan`` instants);
* ``api/loop.py``: capture and replay iterations (``loop``).

* ``net/tcp.py``: link repairs (``net`` instants).
* ``service/scheduler.py``: each served job's ``queue_wait`` bar and its
  ``job:<name>`` span with ``tenant``, ``job`` and ``job_id``
  (``service``), ``current_job`` set around the run so the job's nested
  spans carry its name; ``service/front_door.py``: ``admit`` and
  ``stream:<pipeline>`` (``front_door``).

Spans time the host (``time.perf_counter``), as the reference's do: a
span around a dispatch measures the host's time to queue the work, not
the device's time to run it. No attribute may be a tensor; the logger
refuses one rather than sync the device to print it.

Spans emit through the JSON logger as ``event=span`` lines and
``tools/trace2perfetto.py`` exports them as Chrome trace events, one
pid lane per rank and one tid lane per category.

**Flight recorder**: every finished span and instant also lands in a
bounded ring (``THRILL_TPU_TRACE_RING`` records, default 512). When a
job fails (``api/context.py`` ``Context.note_failure``) the ring dumps
to a timestamped file under ``THRILL_TPU_FLIGHT_DIR``; its last spans
carry the ``error`` attribute of the failing site. The header records
the ``THRILL_TPU_FAULTS`` arming.

Overhead contract: ``THRILL_TPU_TRACE=0`` is a pinned no-op: the
dispatch choke point pays one attribute read and one predicate and
allocates no span (:data:`SPANS_CREATED` stays flat).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Optional

#: total Span objects ever allocated in this process — the pin the
#: THRILL_TPU_TRACE=0 no-op test asserts stays flat across dispatches
SPANS_CREATED = 0

#: shared do-nothing context manager for the disabled path (stateless,
#: so one instance serves every call site)
_NULL = contextlib.nullcontext()

_FLIGHT_SEQ = itertools.count()


def trace_enabled() -> bool:
    """THRILL_TPU_TRACE=0 disables span creation everywhere (read once
    per Tracer, at Context construction)."""
    from .config import _env_flag
    return _env_flag("THRILL_TPU_TRACE", True)


def _env_int_clamped(name: str, default: int, lo: int) -> int:
    from .config import _env_int
    try:
        return max(_env_int(name, default), lo)
    except ValueError:
        return default


def ring_capacity() -> int:
    """THRILL_TPU_TRACE_RING: flight-recorder ring size in records
    (default 512; 0 disables the ring and with it the flight dumps)."""
    return _env_int_clamped("THRILL_TPU_TRACE_RING", 512, 0)


def flight_dir() -> Optional[str]:
    """Directory flight-recorder dumps land in. Default: a per-USER
    stable path under the system temp dir (the recorder is always on;
    a shared fixed path would be owned by whichever user ran first and
    silently unwritable for everyone else);
    ``THRILL_TPU_FLIGHT_DIR=0|off|none`` disables dumps entirely."""
    v = os.environ.get("THRILL_TPU_FLIGHT_DIR")
    if v in ("0", "off", "none"):
        return None
    if v:
        return v
    import tempfile
    uid = getattr(os, "getuid", lambda: "u")()
    return os.path.join(tempfile.gettempdir(),
                        f"thrill_tpu_flight-{uid}")


def _flight_keep() -> int:
    """Newest-N dump files kept per directory (THRILL_TPU_FLIGHT_KEEP,
    default 40) — an abort-heavy chaos sweep must not fill the disk."""
    return _env_int_clamped("THRILL_TPU_FLIGHT_KEEP", 40, 1)


class Span:
    """One timed region. Context-manager: exceptions escaping the block
    are recorded as an ``error`` attribute before the span finishes —
    the flight recorder's final spans name the failing site this way."""

    __slots__ = ("tracer", "span_id", "parent", "cat", "name", "ts_us",
                 "t0", "t1", "attrs", "generation", "tenant", "job")

    def __init__(self, tracer: "Tracer", span_id: int,
                 parent: Optional[int], cat: str, name: str,
                 attrs: Dict[str, Any]) -> None:
        self.tracer = tracer
        self.span_id = span_id
        self.parent = parent
        self.cat = cat
        self.name = name
        self.attrs = attrs
        # one clock read for both: a stall between two reads would put
        # the span's end (ts + dur_us) before lines logged inside it
        self.t0 = time.perf_counter()
        self.ts_us = tracer._us_at(self.t0)
        self.t1: Optional[float] = None
        self.generation = tracer.gen_fn() if tracer.gen_fn is not None \
            else None
        self.tenant = tracer.tenant_fn() if tracer.tenant_fn is not None \
            else None
        self.job = tracer.current_job

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, et, ev, tb) -> None:
        if ev is not None:
            self.attrs["error"] = repr(ev)[:200]
        self.tracer.end(self)

    def rec(self) -> dict:
        r = {"event": "span", "cat": self.cat, "name": self.name,
             "trace": self.tracer.trace_id, "span": self.span_id,
             "rank": self.tracer.rank, "ts": self.ts_us,
             "dur_us": int(((self.t1 if self.t1 is not None
                             else time.perf_counter()) - self.t0) * 1e6)}
        if self.parent is not None:
            r["parent"] = self.parent
        if self.generation is not None:
            r["generation"] = self.generation
        if self.tenant is not None:
            r["tenant"] = self.tenant
        if self.job is not None:
            r["job"] = self.job
        r.update(self.attrs)
        return r


class Tracer:
    """Per-Context span factory + flight-recorder ring.

    Attached as ``mesh_exec.tracer`` / ``decisions.tracer`` /
    ``ctx.tracer`` so every choke point reaches it in one attribute
    read; ``enabled`` False (THRILL_TPU_TRACE=0) makes every guarded
    site skip span allocation entirely. Propagation is EXPLICIT: a
    per-thread span stack supplies the parent id; cross-thread workers
    (the async host sender) pass ``parent=`` captured on the
    submitting thread (the write-behind jobs)."""

    def __init__(self, rank: int = 0, logger=None,
                 ring: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        self.enabled = trace_enabled() if enabled is None else enabled
        self.rank = rank
        self.logger = logger
        cap = ring_capacity() if ring is None else ring
        self.ring: Optional[collections.deque] = \
            collections.deque(maxlen=cap) if cap > 0 else None
        self.trace_id = f"{os.getpid():x}.{rank}"
        self._ids = itertools.count(1)
        self._tls = threading.local()
        # context binders: generation / tenant of the moment a span
        # starts (the Context sets both), and the job name nested spans
        # carry (the scheduler sets it around a served job)
        self.gen_fn = None
        self.tenant_fn = None
        self.current_job: Optional[str] = None
        # finished spans and instants per category lane
        self.lane_counts: Dict[str, int] = {}
        if logger is not None and hasattr(logger, "us_at"):
            self._us_at = logger.us_at
        else:
            wall0, perf0 = time.time(), time.perf_counter()
            self._us_at = lambda perf: int((wall0 + perf - perf0) * 1e6)

    def _now_us(self) -> int:
        return self._us_at(time.perf_counter())

    # -- span lifecycle -------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_id(self) -> Optional[int]:
        """The calling thread's innermost open span id (for explicit
        cross-thread parenting)."""
        st = getattr(self._tls, "stack", None)
        return st[-1].span_id if st else None

    def span(self, cat: str, name: str, parent: Optional[int] = None,
             **attrs: Any) -> Span:
        """Open a span (use as a context manager). ``parent`` defaults
        to the calling thread's innermost open span."""
        return self.begin(cat, name, parent=parent, **attrs)

    def begin(self, cat: str, name: str, parent: Optional[int] = None,
              **attrs: Any) -> Span:
        """Open a span without the context-manager protocol (callers
        with early-exit control flow pair it with ``end`` in a
        try/finally)."""
        global SPANS_CREATED
        SPANS_CREATED += 1
        st = self._stack()
        if parent is None and st:
            parent = st[-1].span_id
        sp = Span(self, next(self._ids), parent, cat, name, attrs)
        st.append(sp)
        return sp

    def end(self, sp: Span, **attrs: Any) -> None:
        sp.t1 = time.perf_counter()
        if attrs:
            sp.attrs.update({k: v for k, v in attrs.items()
                             if v is not None})
        st = getattr(self._tls, "stack", None)
        if st:
            # pop the span plus anything leaked above it (an exception
            # that skipped a child's end must not corrupt parenting)
            for i in range(len(st) - 1, -1, -1):
                if st[i] is sp:
                    del st[i:]
                    break
        self.lane_counts[sp.cat] = self.lane_counts.get(sp.cat, 0) + 1
        self._record(sp.rec())

    def emit_span(self, cat: str, name: str, start_s: float,
                  end_s: float, parent: Optional[int] = None,
                  **attrs: Any) -> None:
        """Record an already-elapsed region measured with
        ``time.perf_counter()`` (a region that could not hold a span
        open while it ran)."""
        if not self.enabled:
            return
        now_us = self._now_us()
        elapsed_us = int(max(time.perf_counter() - start_s, 0.0) * 1e6)
        rec = {"event": "span", "cat": cat, "name": name,
               "trace": self.trace_id, "span": next(self._ids),
               "rank": self.rank, "ts": now_us - elapsed_us,
               "dur_us": int(max(end_s - start_s, 0.0) * 1e6)}
        if parent is not None:
            rec["parent"] = parent
        if self.gen_fn is not None:
            rec["generation"] = self.gen_fn()
        rec.update({k: v for k, v in attrs.items() if v is not None})
        self.lane_counts[cat] = self.lane_counts.get(cat, 0) + 1
        self._record(rec)

    def instant(self, cat: str, name: str, **attrs: Any) -> None:
        """Zero-duration marker (ladder rungs, exchange verdicts)."""
        if not self.enabled:
            return
        rec = {"event": "span", "kind": "instant", "cat": cat,
               "name": name, "trace": self.trace_id,
               "span": next(self._ids), "rank": self.rank,
               "ts": self._now_us(), "dur_us": 0}
        pid = self.current_id()
        if pid is not None:
            rec["parent"] = pid
        if self.gen_fn is not None:
            rec["generation"] = self.gen_fn()
        if self.tenant_fn is not None:
            t = self.tenant_fn()
            if t is not None:
                rec["tenant"] = t
        if self.current_job is not None:
            rec["job"] = self.current_job
        rec.update({k: v for k, v in attrs.items() if v is not None})
        # instants count toward the lane totals too: the mem lane is
        # made of instants only (ladder rungs) and must show in the
        # trace_spans metric
        self.lane_counts[cat] = self.lane_counts.get(cat, 0) + 1
        self._record(rec)

    def _record(self, rec: dict) -> None:
        if self.ring is not None:
            self.ring.append(rec)
        log = self.logger
        if log is not None and log.enabled:
            log.line(**rec)

    # -- flight recorder ------------------------------------------------
    def dump_flight(self, reason: Any, generation: Optional[int] = None
                    ) -> Optional[str]:
        """Write the ring's records to a timestamped post-mortem file.
        Best-effort by contract: returns the path, or None when the
        recorder is disabled (tracing off / no ring /
        THRILL_TPU_FLIGHT_DIR=0), the ring is empty (a header-only
        dump would only churn the keep-N rotation — the TRACE=0 abort
        path writes nothing), or the write fails — a failing dump must
        never mask the abort being recorded."""
        if not self.enabled or not self.ring:
            return None
        d = flight_dir()
        if d is None:
            return None
        recs = list(self.ring)
        from . import faults
        header = {"event": "flight_header",
                  "reason": str(reason)[:300],
                  "generation": generation, "rank": self.rank,
                  "trace": self.trace_id, "ts": self._now_us(),
                  "records": len(recs),
                  "faults": os.environ.get(faults.ENV_VAR) or None}
        name = (f"flight-{int(time.time() * 1e3)}-p{os.getpid()}"
                f"-r{self.rank}-{next(_FLIGHT_SEQ)}.json")
        path = os.path.join(d, name)
        try:
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps(header, default=str) + "\n")
                for r in recs:
                    f.write(json.dumps(r, default=str) + "\n")
        except OSError:
            return None
        try:
            _prune(d, _flight_keep())
        except OSError:
            pass
        return path


def _prune(d: str, keep: int) -> None:
    """Drop all but the newest ``keep`` flight dumps in ``d`` — along
    with each pruned dump's decision-ledger sibling
    (``decisions-*.json``, common/decisions.py), which would otherwise
    pile up under a run of failing jobs."""
    files = [os.path.join(d, f) for f in os.listdir(d)
             if f.startswith("flight-") and f.endswith(".json")]
    if len(files) <= keep:
        return
    files.sort(key=lambda p: os.path.getmtime(p), reverse=True)
    for p in files[keep:]:
        for victim in (p, os.path.join(
                os.path.dirname(p), "decisions-"
                + os.path.basename(p)[len("flight-"):])):
            try:
                os.unlink(victim)
            except OSError:
                pass


def span_of(tracer: Optional[Tracer], cat: str, name: str,
            **attrs: Any):
    """``tracer.span(...)`` when tracing is live, the shared null
    context otherwise — the one-liner guard for call sites where a
    with-block reads best."""
    if tracer is not None and tracer.enabled:
        return tracer.span(cat, name, **attrs)
    return _NULL


def instant_of(tracer: Optional[Tracer], cat: str, name: str,
               **attrs: Any) -> None:
    """Guarded instant: the one-liner the marker sites (ladder rungs,
    reconnects, fusion degradations) share instead of each carrying
    the None/enabled check."""
    if tracer is not None and tracer.enabled:
        tracer.instant(cat, name, **attrs)
