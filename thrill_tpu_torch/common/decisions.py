"""The decision ledger (counterpart of the reference package's
``common/decisions.py``, single controller).

Every data-driven plan choice the port makes (fusion split points and
barriers, the exchange's strategy, chunk count, narrow spec and
optimistic-versus-synced verdict, pre-shuffle prune verdicts, the sort
engine, plan-store seeds, readahead depths) becomes a record:

* :class:`DecisionRecord`: site, kind, the chosen alternative, the
  rejected ones with their estimated costs, the predicted value and,
  once the truth arrives, the joined actual with its
  ``log2(predicted / actual)`` error.
* :class:`DecisionLedger`: one per Context, attached as
  ``mesh_exec.decisions`` so every choke point reaches it in one
  attribute read. Records land in a bounded ring
  (``THRILL_TPU_DECISIONS_RING``, default 4096) and as
  ``event=decision`` lines of the JSON log.
* :func:`render_plan`: the annotated plan tree ``Context.explain()``
  prints.

With a tracer (``tracer=``, common/trace.py) every record and audit is
also an instant on the trace's ``plan`` lane, and
:meth:`DecisionLedger.dump_beside` archives the ledger next to a
flight-recorder dump.

``THRILL_TPU_DECISIONS=0`` makes the ledger a no-op: the choke points
pay one attribute read and allocate no record
(:data:`RECORDS_CREATED` stays flat). A dropped record changes no plan.
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from .config import _env_flag, _env_int
from .stats import Aggregate

#: DecisionRecord objects allocated in this process (the
#: THRILL_TPU_DECISIONS=0 test holds it flat)
RECORDS_CREATED = 0

#: |log2(pred/actual)| up to this reads "ok", past it "off"
_OK_LOG2 = 1.0


def decisions_enabled() -> bool:
    """THRILL_TPU_DECISIONS=0 turns the ledger off (read once per
    ledger)."""
    return _env_flag("THRILL_TPU_DECISIONS", True)


def ring_capacity() -> int:
    """THRILL_TPU_DECISIONS_RING: records kept for explain() (default
    4096; the per-kind counters and aggregates never drop)."""
    try:
        return max(_env_int("THRILL_TPU_DECISIONS_RING", 4096), 0)
    except ValueError:
        return 4096


class DecisionRecord:
    """One plan choice and, once known, how far its prediction was
    from the truth."""

    __slots__ = ("seq", "kind", "site", "chosen", "predicted",
                 "rejected", "reason", "inputs", "dia", "node",
                 "actual", "err_log2", "verdict")

    def __init__(self, seq: int, kind: str, site: str, chosen: str,
                 predicted: Optional[float], rejected, reason,
                 inputs: Dict[str, Any], dia: Optional[int],
                 node: Optional[str]) -> None:
        self.seq = seq
        self.kind = kind
        self.site = site
        self.chosen = chosen
        self.predicted = predicted
        self.rejected = rejected     # [(alternative, est_cost), ...]
        self.reason = reason
        self.inputs = inputs
        self.dia = dia
        self.node = node
        self.actual: Optional[float] = None
        self.err_log2: Optional[float] = None
        self.verdict: Optional[str] = None

    def rec(self) -> dict:
        """The ``event=decision`` log line's fields."""
        r: Dict[str, Any] = {"event": "decision", "seq": self.seq,
                             "kind": self.kind, "site": self.site,
                             "chosen": self.chosen}
        if self.predicted is not None:
            r["predicted"] = self.predicted
        if self.rejected:
            r["rejected"] = [[a, c] for a, c in self.rejected]
        if self.reason:
            r["reason"] = self.reason
        if self.inputs:
            r["inputs"] = self.inputs
        if self.dia is not None:
            r["dia_id"] = self.dia
        if self.node is not None:
            r["node"] = self.node
        return r

    def audit_rec(self) -> dict:
        r: Dict[str, Any] = {"event": "decision_audit", "seq": self.seq,
                             "kind": self.kind, "site": self.site,
                             "verdict": self.verdict}
        if self.actual is not None:
            r["actual"] = self.actual
        if self.err_log2 is not None:
            r["err_log2"] = round(self.err_log2, 4)
        return r


class DecisionLedger:
    """Per-Context decision store with predicted-versus-actual
    aggregates; ``enabled`` False makes every guarded site allocate
    nothing."""

    def __init__(self, logger=None, tracer=None,
                 ring: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        self.enabled = decisions_enabled() if enabled is None \
            else enabled
        self.logger = logger
        self.tracer = tracer
        # the planner's re-optimization trigger (api/planner.py
        # Planner.on_audit), called with every record whose actual
        # just joined; None: a pure observatory
        self.audit_hook = None
        cap = ring_capacity() if ring is None else ring
        self.records: collections.deque = collections.deque(
            maxlen=cap if cap > 0 else 1)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.kind_counts: Dict[str, int] = {}
        self.joined_counts: Dict[str, int] = {}
        self._acc: Dict[str, Aggregate] = {}
        self._site_err: Dict[Tuple[str, str], List[float]] = {}
        # records awaiting a resolve_site() join from another scope
        self._open: Dict[Tuple[str, str], DecisionRecord] = {}
        # the DIA node whose compute is running (dia_base binds it), so
        # decisions recorded inside land on it in explain()
        self._tls = threading.local()

    # -- node binding ---------------------------------------------------
    def push_node(self, dia_id: int, label: str) -> None:
        st = getattr(self._tls, "nodes", None)
        if st is None:
            st = self._tls.nodes = []
        st.append((dia_id, label))

    def pop_node(self) -> None:
        st = getattr(self._tls, "nodes", None)
        if st:
            st.pop()

    def _current_node(self) -> Tuple[Optional[int], Optional[str]]:
        st = getattr(self._tls, "nodes", None)
        return st[-1] if st else (None, None)

    # -- recording ------------------------------------------------------
    def record(self, kind: str, site: str, chosen: str,
               predicted: Optional[float] = None,
               rejected=None, reason: Optional[str] = None,
               join: bool = False, dia: Optional[int] = None,
               node: Optional[str] = None,
               **inputs: Any) -> DecisionRecord:
        """Record one plan choice. ``join=True`` keeps it open under
        (kind, site) for a later :meth:`resolve_site`; ``dia``/``node``
        override the current node (a barrier record is about a node,
        not made inside its compute)."""
        global RECORDS_CREATED
        RECORDS_CREATED += 1
        if dia is None:
            dia, node = self._current_node()
        rec = DecisionRecord(next(self._ids), kind, site, chosen,
                             _num(predicted), rejected, reason,
                             inputs, dia, node)
        with self._lock:
            self.records.append(rec)
            self.kind_counts[kind] = self.kind_counts.get(kind, 0) + 1
            if join:
                self._open[(kind, site)] = rec
        log = self.logger
        if log is not None and log.enabled:
            log.line(**rec.rec())
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("plan", kind, site=site, chosen=chosen,
                       predicted=rec.predicted, reason=reason)
        return rec

    # -- joining actuals ------------------------------------------------
    def resolve(self, rec: Optional[DecisionRecord], actual,
                verdict: Optional[str] = None) -> None:
        """Join the measured truth onto a decision: the
        ``log2(predicted/actual)`` error where both are positive
        numbers, folded into the per-kind aggregates, then the
        ``event=decision_audit`` line and the planner's hook."""
        if rec is None:
            return
        actual = _num(actual)
        rec.actual = actual
        pred = rec.predicted
        if pred is not None and actual is not None \
                and pred > 0 and actual > 0:
            rec.err_log2 = math.log2(pred / actual)
            rec.verdict = verdict or (
                "ok" if abs(rec.err_log2) <= _OK_LOG2 else "off")
            with self._lock:
                self.joined_counts[rec.kind] = \
                    self.joined_counts.get(rec.kind, 0) + 1
                self._acc.setdefault(rec.kind, Aggregate()).add(
                    abs(rec.err_log2))
                se = self._site_err.setdefault((rec.kind, rec.site),
                                               [0, 0.0])
                se[0] += 1
                se[1] += abs(rec.err_log2)
        else:
            rec.verdict = verdict or "unmeasured"
            with self._lock:
                self.joined_counts[rec.kind] = \
                    self.joined_counts.get(rec.kind, 0) + 1
        log = self.logger
        if log is not None and log.enabled:
            log.line(**rec.audit_rec())
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("plan", rec.kind + "_audit", site=rec.site,
                       verdict=rec.verdict,
                       err_log2=(round(rec.err_log2, 3)
                                 if rec.err_log2 is not None else None))
        hook = self.audit_hook
        if hook is not None:
            # planning is performance and the join observability:
            # neither may take down the pipeline that made the actual
            try:
                hook(rec)
            except Exception:
                pass

    def resolve_site(self, kind: str, site: str, actual,
                     verdict: Optional[str] = None) -> bool:
        """Join by (kind, site) for a scope that no longer holds the
        record; False when none is open."""
        with self._lock:
            rec = self._open.pop((kind, site), None)
        if rec is None:
            return False
        self.resolve(rec, actual, verdict=verdict)
        return True

    # -- aggregates -----------------------------------------------------
    def accuracy(self) -> Dict[str, dict]:
        """Per kind: records, joined actuals, mean and standard
        deviation of |log2(predicted/actual)|."""
        with self._lock:
            out = {}
            for kind, n in sorted(self.kind_counts.items()):
                agg = self._acc.get(kind)
                have = agg is not None and agg.count
                out[kind] = {
                    "n": n,
                    "joined": self.joined_counts.get(kind, 0),
                    "mae_log2": round(agg.mean, 4) if have else None,
                    "stdev_log2": round(agg.stdev, 4) if have else None,
                }
            return out

    def worst_sites(self, k: int = 5) -> List[dict]:
        """The k sites with the largest mean |log2 err|."""
        with self._lock:
            rows = [{"kind": kind, "site": site, "n": n,
                     "mae_log2": round(tot / n, 4)}
                    for (kind, site), (n, tot) in self._site_err.items()
                    if n]
        rows.sort(key=lambda r: -r["mae_log2"])
        return rows[:k]

    def snapshot(self) -> List[dict]:
        """Record dicts with their audit fields, a copy."""
        with self._lock:
            recs = list(self.records)
        out = []
        for r in recs:
            d = r.rec()
            if r.verdict is not None:
                d["verdict"] = r.verdict
            if r.actual is not None:
                d["actual"] = r.actual
            if r.err_log2 is not None:
                d["err_log2"] = round(r.err_log2, 4)
            out.append(d)
        return out

    def summary(self) -> dict:
        """The accuracy report the plan store keeps beside its plans."""
        return {"version": 1,
                "decisions": sum(self.kind_counts.values()),
                "accuracy": self.accuracy(),
                "worst_sites": self.worst_sites()}

    def dump_beside(self, flight_path: Optional[str]) -> Optional[str]:
        """Archive the ledger next to a flight-recorder dump:
        ``flight-*.json`` gains a sibling ``decisions-*.json`` with the
        summary and the ring's records. Best-effort like the dump: the
        path, or None."""
        if flight_path is None or not self.enabled:
            return None
        recs = self.snapshot()
        if not recs:
            return None
        d, name = os.path.split(flight_path)
        if not name.startswith("flight-"):
            return None
        path = os.path.join(d, "decisions-" + name[len("flight-"):])
        try:
            with open(path, "w") as f:
                f.write(json.dumps(self.summary(), default=str) + "\n")
                for r in recs:
                    f.write(json.dumps(r, default=str) + "\n")
        except OSError:
            return None
        return path


def _num(v) -> Optional[float]:
    """A plain float; None and NaN stay None."""
    if v is None or isinstance(v, bool):
        return None
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


# -- guarded one-liners for the choke points ---------------------------

def ledger_of(mex) -> Optional[DecisionLedger]:
    """The mesh's ledger when recording is on, else None: one attribute
    read and one predicate on the off path."""
    led = getattr(mex, "decisions", None)
    if led is not None and led.enabled:
        return led
    return None


def record_of(mex, kind: str, site: str, chosen: str,
              **kw) -> Optional[DecisionRecord]:
    led = ledger_of(mex)
    if led is None:
        return None
    return led.record(kind, site, chosen, **kw)


def resolve_of(mex, rec: Optional[DecisionRecord], actual,
               verdict: Optional[str] = None) -> None:
    if rec is None:
        return
    led = getattr(mex, "decisions", None)
    if led is not None:
        led.resolve(rec, actual, verdict=verdict)


def resolve_io_prefetch(mex, rec: Optional[DecisionRecord],
                        io_delta: dict) -> None:
    """The audit join of every ``io_prefetch`` decision: the measured
    hit rate of the window's consumed readahead, kept above zero so an
    all-miss run resolves as a finite error; a window that consumed no
    readahead stays unmeasured."""
    if rec is None:
        return
    from .iostats import hit_rate
    consumed = io_delta.get("prefetch_hits", 0) \
        + io_delta.get("prefetch_misses", 0)
    resolve_of(mex, rec,
               max(hit_rate(io_delta), 1e-3) if consumed else None)


# -- the explain() renderer --------------------------------------------

def _fmt_bytes(n) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.1f}{unit}")
        n /= 1024
    return f"{n:.1f}GiB"


def _fmt_decision(d: dict) -> str:
    """One decision as a line: kind, chosen over rejected with their
    estimated costs, the reason and the audit."""
    parts = [f"{d['kind']}: chose {d['chosen']}"]
    unit = (d.get("inputs") or {}).get("unit") or "bytes"
    fmt = (lambda v: f"{float(v):.3g}") if unit != "bytes" else _fmt_bytes
    rej = d.get("rejected") or []
    if rej:
        alts = ", ".join(f"{a} est {_fmt_bytes(c)}" if _num(c)
                         is not None else str(a) for a, c in rej)
        parts.append(f"over {alts}")
    if d.get("predicted") is not None:
        parts.append(f"pred {fmt(d['predicted'])}")
    if d.get("reason"):
        parts.append(f"({d['reason']})")
    if d.get("actual") is not None:
        err = d.get("err_log2")
        audit = f"actual {fmt(d['actual'])}"
        if err is not None:
            audit += f", err x{2 ** abs(err):.2f} [{d.get('verdict')}]"
        elif d.get("verdict"):
            audit += f" [{d['verdict']}]"
        parts.append("-> " + audit)
    elif d.get("verdict"):
        parts.append(f"-> [{d['verdict']}]")
    return " ".join(parts)


def render_plan(nodes: List[dict], decisions: List[dict],
                W: Optional[int] = None, title: str = "") -> str:
    """The physical plan as an annotated tree. ``nodes``: ``[{"id",
    "label", "state", "parents"}]``; ``decisions``: the ledger's
    :meth:`DecisionLedger.snapshot`. Sinks print first with their
    parents indented below; a shared parent prints once. Decisions sit
    under the node whose compute made them; the rest close the tree as
    "plan-wide decisions", repeats collapsed with a count."""
    by_id = {n["id"]: n for n in nodes}
    ids = set(by_id)
    referenced = {p for n in nodes for p in n.get("parents", ())
                  if p in ids}
    sinks = [n for n in nodes if n["id"] not in referenced]
    per_node: Dict[int, List[dict]] = {}
    rest: List[dict] = []
    fused_names: Dict[int, str] = {}
    for d in decisions:
        if d.get("kind") == "fusion":
            for nid in (d.get("inputs") or {}).get("dia_ids") or ():
                if nid is not None:
                    fused_names.setdefault(int(nid),
                                           (d.get("inputs")
                                            or {}).get("ops", ""))
        nid = d.get("dia_id")
        if nid is not None:
            if nid in ids:
                per_node.setdefault(nid, []).append(d)
        else:
            rest.append(d)
    lines: List[str] = []
    head = title or "physical plan"
    if W:
        head += f" (W={W})"
    lines.append(head)
    seen: set = set()

    def walk(root: int) -> None:
        stack: List[Tuple[int, int]] = [(root, 0)]
        while stack:
            nid, depth = stack.pop()
            pad = "  " * depth
            n = by_id.get(nid)
            if n is None:
                lines.append(f"{pad}- #{nid} (outside this plan)")
                continue
            state = n.get("state") or "?"
            tag = f"{pad}- {n.get('label', '?')}#{nid} [{state}]"
            if state == "FUSED" and nid in fused_names:
                tag += f"  ~ fused into [{fused_names[nid]}]"
            if nid in seen:
                lines.append(tag + "  (see above)")
                continue
            seen.add(nid)
            lines.append(tag)
            for d in per_node.get(nid, ()):
                lines.append(f"{pad}    . {_fmt_decision(d)}")
            for p in reversed(n.get("parents", ())):
                stack.append((p, depth + 1))

    for s in sorted(sinks, key=lambda n: n["id"], reverse=True):
        walk(s["id"])
    if rest:
        lines.append("plan-wide decisions:")
        grouped: Dict[Tuple, List[dict]] = {}
        for d in rest:
            grouped.setdefault((d.get("kind"), d.get("site"),
                                d.get("chosen")), []).append(d)
        for ds in grouped.values():
            cnt = f"  x{len(ds)}" if len(ds) > 1 else ""
            lines.append(f"  . {_fmt_decision(ds[-1])}{cnt}")
    return "\n".join(lines)


def render_accuracy(accuracy: Dict[str, dict],
                    worst: List[dict]) -> str:
    """The audited-accuracy table."""
    lines = ["decision accuracy (|log2 predicted/actual|):",
             f"  {'kind':<16} {'n':>5} {'joined':>7} {'mae':>7} "
             f"{'stdev':>7}"]
    for kind, row in sorted(accuracy.items()):
        mae = row.get("mae_log2")
        sd = row.get("stdev_log2")
        lines.append(
            f"  {kind:<16} {row.get('n', 0):>5} "
            f"{row.get('joined', 0):>7} "
            f"{mae if mae is not None else '-':>7} "
            f"{sd if sd is not None else '-':>7}")
    if worst:
        lines.append("worst-audited sites:")
        for r in worst:
            lines.append(f"  {r['kind']}@{r['site']}: "
                         f"mae {r['mae_log2']} over {r['n']} joins")
    return "\n".join(lines)
