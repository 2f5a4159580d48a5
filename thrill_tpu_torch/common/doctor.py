"""Performance doctor: where did the time go? (counterpart of the
reference package's ``common/doctor.py``).

Three attributions on top of the trace spine (common/trace.py) and the
decision ledger (common/decisions.py):

* **Wait attribution**: every blocking read of an exchange's plan
  (``xchg.plan_sync``: the host read of phase A's send matrix;
  ``xchg.deferred_check``: an optimistic exchange's capacity verdict)
  records how long the host was blocked. On the card such a "wait" is
  the host waiting for the device's queue to reach the read: the work
  queued before it, not a peer. The totals decompose in
  ``overall_stats()``:

  - ``wait_net_s``      blocked in host-group collectives (the
    processes of a mesh; 0 in one process, whose group has no peer);
  - ``wait_exchange_s`` blocked at exchange barriers;
  - ``wait_io_s``       the part that overlapped busy background I/O;
  - ``wait_skew_s``     the remainder.

* **Partition-skew attribution**: every exchange whose ``[W, W]`` send
  matrix is already on the host folds its per-worker receive rows into
  the site's histogram and a hot-slot verdict (``max/mean >=
  THRILL_TPU_SKEW_HOT``, default 3.0): ``skew_ratio`` in
  ``overall_stats()``, ``kind=skew`` instants on the trace's plan lane
  and a ``skew`` decision record for ``ctx.explain()``.

* **Critical path**: a pass over span records (the tracer's ring, or
  ``event=span`` log lines offline, tools/doctor_report.py) rebuilds
  the span forest, computes each span's exclusive time and walks the
  latest-finishing child chain from the longest root: the
  ``loop -> exchange -> dispatch`` chain that bounded the run.

Overhead contract: ``THRILL_TPU_DOCTOR=0`` makes no Doctor; the choke
points pay one attribute read and one predicate and record nothing
(:data:`RECORDS` stays flat). A skew record runs only where the send
matrix was already read; the doctor itself never reads the device.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

#: wait records ever taken in this process — the THRILL_TPU_DOCTOR=0
#: no-op pin asserts this stays flat across a full pipeline
RECORDS = 0


def doctor_enabled() -> bool:
    """THRILL_TPU_DOCTOR=0 disables the doctor everywhere (read once
    per Context, at construction)."""
    from .config import _env_flag
    return _env_flag("THRILL_TPU_DOCTOR", True)


def skew_hot_ratio() -> float:
    """Hot-slot verdict threshold (max/mean receive rows per exchange
    site): THRILL_TPU_SKEW_HOT, default 3.0."""
    import os
    try:
        v = float(os.environ.get("THRILL_TPU_SKEW_HOT", "3.0"))
    except ValueError:
        return 3.0
    return v if v > 1.0 else 3.0


class Doctor:
    """Per-Context wait/skew ledger.

    Attached as ``ctx.doctor`` / ``mesh_exec.doctor`` so every choke
    point reaches it in one attribute read; a None attribute
    (THRILL_TPU_DOCTOR=0) makes every guarded site skip recording."""

    def __init__(self, rank: int = 0) -> None:
        self.rank = rank
        self._lock = threading.Lock()
        # seconds this rank spent blocked waiting for each peer's frame
        self.wait_by_peer: Dict[int, float] = {}
        # seconds blocked per site ("all_reduce", "xchg.plan_sync"...)
        self.wait_by_site: Dict[str, float] = {}
        self.wait_net_s = 0.0        # host-group collective lane
        self.wait_exchange_s = 0.0   # exchange-barrier lane
        self.wait_io_s = 0.0         # overlapped with local bg I/O
        # per-exchange-site skew state:
        # site -> {"ratio": max seen, "worker": hot worker at max,
        #          "rows": recv rows at max, "exchanges": count,
        #          "hot": verdict, "reported": ratio last put in the
        #          decision ledger}
        self.skew_by_site: Dict[str, dict] = {}
        self._hot_thresh = skew_hot_ratio()

    # -- collective wait attribution ------------------------------------

    def record_wait(self, site: str, peer: Optional[int],
                    wait_s: float, lane: Optional[str] = None,
                    io_s: float = 0.0) -> None:
        """One blocked window: ``wait_s`` seconds at ``site`` waiting
        on ``peer`` (None when the wait has no single peer — a device
        plan sync). ``io_s`` is the background-I/O busy time that
        elapsed DURING the window (callers sample iostats around the
        block); it caps the I/O attribution. ``lane`` defaults by
        site name: exchange-barrier sites (``xchg.*``,
        ``host_exchange``) land on the exchange lane, everything else
        on the net lane."""
        global RECORDS
        RECORDS += 1
        if wait_s <= 0:
            return
        if lane is None:
            lane = ("exchange"
                    if site.startswith(("xchg", "host_exchange"))
                    else "net")
        io = min(max(io_s, 0.0), wait_s)
        with self._lock:
            if peer is not None:
                self.wait_by_peer[peer] = \
                    self.wait_by_peer.get(peer, 0.0) + wait_s
            self.wait_by_site[site] = \
                self.wait_by_site.get(site, 0.0) + wait_s
            if lane == "exchange":
                self.wait_exchange_s += wait_s
            else:
                self.wait_net_s += wait_s
            self.wait_io_s += io

    @property
    def collective_wait_s(self) -> float:
        return self.wait_net_s + self.wait_exchange_s

    def straggler_scores(self) -> Dict[int, float]:
        """Per-peer arrival deltas: seconds of blocked time beyond the
        FASTEST peer's — the peer everyone arrives after scores 0, the
        straggler scores what it cost. With one peer the delta is the
        raw wait (nothing to subtract against)."""
        with self._lock:
            waits = dict(self.wait_by_peer)
        if not waits:
            return {}
        if len(waits) == 1:
            return waits
        floor = min(waits.values())
        return {p: w - floor for p, w in waits.items()}

    def straggler_rank(self) -> Optional[int]:
        scores = self.straggler_scores()
        if not scores or max(scores.values()) <= 0:
            return None
        return max(sorted(scores), key=lambda p: scores[p])

    # -- partition-skew attribution -------------------------------------

    def record_exchange(self, site: str, recv_rows: np.ndarray,
                        item_bytes: int, tracer=None,
                        ledger=None) -> Optional[tuple]:
        """Fold one exchange's per-worker receive rows into the site's
        skew state; returns THIS exchange's ``(ratio, hot_worker,
        hot_rows)`` (the caller's log-line fields — one computation,
        here). Emits the ``kind=skew`` plan-lane instant + the
        ``skew`` decision record on the FIRST hot verdict per site
        (and again when the ratio doubles past the last report — a
        loop must not spam one record per iteration)."""
        rows = np.asarray(recv_rows, dtype=np.int64)
        total = int(rows.sum())
        if rows.size == 0 or total <= 0:
            return None
        mean = total / rows.size
        worker = int(rows.argmax())
        ratio = float(rows[worker] / mean) if mean > 0 else 1.0
        with self._lock:
            st = self.skew_by_site.get(site)
            if st is None:
                st = self.skew_by_site[site] = {
                    "ratio": 0.0, "worker": worker, "rows": 0,
                    "bytes": 0, "exchanges": 0, "hot": False,
                    "reported": 0.0}
            st["exchanges"] += 1
            st["bytes"] += total * max(item_bytes, 0)
            if ratio > st["ratio"]:
                st["ratio"] = ratio
                st["worker"] = worker
                st["rows"] = int(rows[worker])
            hot = st["ratio"] >= self._hot_thresh
            st["hot"] = hot
            report = hot and (st["reported"] == 0.0
                              or st["ratio"] >= 2 * st["reported"])
            if report:
                st["reported"] = st["ratio"]
            snap = dict(st)
        if report:
            if tracer is not None and tracer.enabled:
                # kind=skew instant on the plan lane: the trace shows
                # WHERE in the timeline the hot slot was detected
                tracer.instant("plan", "skew", kind="skew", site=site,
                               ratio=round(snap["ratio"], 2),
                               worker=snap["worker"])
            if ledger is not None and getattr(ledger, "enabled", False):
                ledger.record(
                    "skew", site, f"worker {snap['worker']}",
                    predicted=snap["rows"],
                    reason=(f"hot slot: {snap['ratio']:.1f}x the mean "
                            f"receive volume lands on worker "
                            f"{snap['worker']}"),
                    ratio=round(snap["ratio"], 2))
        return (ratio, worker, int(rows[worker]))

    def max_skew_ratio(self) -> float:
        with self._lock:
            if not self.skew_by_site:
                return 0.0
            return max(st["ratio"] for st in self.skew_by_site.values())

    def hot_sites(self) -> List[dict]:
        with self._lock:
            return sorted(
                ({"site": s, **st}
                 for s, st in self.skew_by_site.items() if st["hot"]),
                key=lambda d: -d["ratio"])

    # -- reporting -------------------------------------------------------

    def stats(self) -> dict:
        """The overall_stats() contribution (always present; zeros on
        an idle doctor). ``wait_skew_s`` is the unexplained remainder:
        peer compute skew or net transit, attributed to the peer."""
        with self._lock:
            total = self.wait_net_s + self.wait_exchange_s
            out = {
                "collective_wait_s": round(total, 4),
                "wait_net_s": round(self.wait_net_s, 4),
                "wait_exchange_s": round(self.wait_exchange_s, 4),
                "wait_io_s": round(self.wait_io_s, 4),
                "wait_skew_s": round(max(total - self.wait_io_s, 0.0),
                                     4),
                "straggler_waits": {
                    str(p): round(w, 4)
                    for p, w in sorted(self.wait_by_peer.items())},
            }
        out["skew_ratio"] = round(self.max_skew_ratio(), 3)
        return out

    def report(self, ring=None, k: int = 5) -> dict:
        """The full diagnosis: stats + per-site tables + the critical
        path over ``ring`` (an iterable of span record dicts — the
        tracer's flight-recorder ring, or records loaded from logs)."""
        out = self.stats()
        out["straggler_rank"] = self.straggler_rank()
        out["straggler_scores"] = {
            str(p): round(s, 4)
            for p, s in sorted(self.straggler_scores().items())}
        with self._lock:
            out["wait_by_site"] = {
                s: round(w, 4)
                for s, w in sorted(self.wait_by_site.items(),
                                   key=lambda kv: -kv[1])}
            out["skew_sites"] = sorted(
                ({"site": s, **{k2: (round(v, 3)
                                     if isinstance(v, float) else v)
                                for k2, v in st.items()}}
                 for s, st in self.skew_by_site.items()),
                key=lambda d: -d["ratio"])
        if ring is not None:
            out["critical_path"] = critical_path(list(ring), k=k)
        return out


def fold_skew_sites(events) -> Dict[str, dict]:
    """Per-site skew state folded from ``event=exchange`` log lines —
    the offline twin of :meth:`Doctor.record_exchange`'s live fold,
    shared by tools/doctor_report.py and tools/json2profile.py so the
    two renderers cannot drift. Only lines carrying ``skew_ratio``
    participate; ``rows`` is the hot worker's diagonal-included
    receive total (``hot_rows`` — the figure the ratio was computed
    from)."""
    hot = skew_hot_ratio()
    sites: Dict[str, dict] = {}
    for e in events:
        if e.get("event") != "exchange" \
                or e.get("skew_ratio") is None:
            continue
        site = str(e.get("site") or "xchg:?")
        st = sites.setdefault(site, {"ratio": 0.0, "worker": 0,
                                     "rows": 0, "bytes": 0,
                                     "items": 0, "exchanges": 0,
                                     "hot": False})
        st["exchanges"] += 1
        st["bytes"] += int(e.get("bytes", 0) or 0)
        st["items"] += int(e.get("items", 0) or 0)
        try:
            ratio = float(e["skew_ratio"])
        except (TypeError, ValueError):
            continue
        if ratio > st["ratio"]:
            st["ratio"] = ratio
            st["worker"] = int(e.get("hot_worker", 0) or 0)
            st["rows"] = int(e.get("hot_rows", 0) or 0)
        st["hot"] = st["ratio"] >= hot
    return sites


# ----------------------------------------------------------------------
# cross-rank critical path over span records
# ----------------------------------------------------------------------

def _span_key(rec: dict) -> tuple:
    """Spans are unique per (rank, trace, span id) — merged multi-rank
    logs reuse span ids across ranks."""
    return (rec.get("rank", 0), rec.get("trace"), rec.get("span"))


def critical_path(records: List[dict], k: int = 5) -> List[dict]:
    """Top-``k`` edges by exclusive time along the critical path.

    ``records`` are span record dicts (``event=span`` — the tracer's
    ring entries or log lines; non-span records are ignored). The
    forest is rebuilt from parent ids per rank; exclusive time is a
    span's duration minus its children's (clamped at 0 — async
    children can outlive the parent window). The critical path starts
    at the longest root span across ALL ranks (multi-rank logs merged
    by the caller: whichever rank's chain ran longest bounds the
    cluster) and at each level follows the child that FINISHES last.
    Every span on that path becomes an edge record ``{name, cat,
    rank, excl_us, dur_us, path}`` where ``path`` is the ancestor
    chain (``job:x > exchange:phase_b > dispatch``); edges rank by
    exclusive time."""
    spans = {}
    for rec in records:
        if rec.get("event") != "span" or rec.get("kind") == "instant":
            continue
        if rec.get("ts") is None or not rec.get("dur_us"):
            continue
        spans[_span_key(rec)] = rec
    if not spans:
        return []
    children: Dict[tuple, List[tuple]] = {}
    roots: List[tuple] = []
    for key, rec in spans.items():
        parent = rec.get("parent")
        pkey = (key[0], key[1], parent) if parent is not None else None
        if pkey is not None and pkey in spans:
            children.setdefault(pkey, []).append(key)
        else:
            roots.append(key)
    if not roots:
        return []

    def end_us(key: tuple) -> int:
        r = spans[key]
        return int(r["ts"]) + int(r["dur_us"])

    def excl_us(key: tuple) -> int:
        r = spans[key]
        kids = children.get(key, ())
        covered = sum(int(spans[c]["dur_us"]) for c in kids)
        return max(int(r["dur_us"]) - covered, 0)

    # deterministic tie-breaks: duration desc, then ts, then span id
    root = max(roots, key=lambda c: (int(spans[c]["dur_us"]),
                                     -int(spans[c]["ts"] or 0),
                                     c[2] if c[2] is not None else 0))
    path: List[tuple] = [root]
    cur = root
    while True:
        kids = children.get(cur)
        if not kids:
            break
        cur = max(kids, key=lambda c: (end_us(c),
                                       int(spans[c]["dur_us"]),
                                       c[2] if c[2] is not None else 0))
        path.append(cur)

    def label(key: tuple) -> str:
        r = spans[key]
        return f"{r.get('cat', '?')}:{r.get('name', '?')}"

    edges = []
    for i, key in enumerate(path):
        r = spans[key]
        edges.append({
            "name": str(r.get("name", "?")),
            "cat": str(r.get("cat", "?")),
            "rank": int(r.get("rank", 0) or 0),
            "dur_us": int(r.get("dur_us", 0)),
            "excl_us": excl_us(key),
            "job": r.get("job"),
            "path": " > ".join(label(p) for p in path[:i + 1]),
        })
    edges.sort(key=lambda e: -e["excl_us"])
    return edges[:k]


def render_report(report: dict) -> str:
    """Human-readable rendering of :meth:`Doctor.report` (shared by
    tools/doctor_report.py and tests)."""
    lines = ["== performance doctor =="]
    lines.append(
        f"collective wait {report.get('collective_wait_s', 0.0):.4f}s "
        f"(net {report.get('wait_net_s', 0.0):.4f}s, exchange "
        f"{report.get('wait_exchange_s', 0.0):.4f}s, io "
        f"{report.get('wait_io_s', 0.0):.4f}s, skew "
        f"{report.get('wait_skew_s', 0.0):.4f}s)")
    sr = report.get("straggler_rank")
    scores = report.get("straggler_scores") or {}
    if sr is not None:
        lines.append(f"straggler: rank {sr} "
                     f"(+{scores.get(str(sr), 0.0):.4f}s vs fastest "
                     f"peer)")
    elif scores:
        lines.append("straggler: none (peers balanced)")
    for site, w in (report.get("wait_by_site") or {}).items():
        lines.append(f"  wait {w:8.4f}s  at {site}")
    skews = report.get("skew_sites") or []
    if skews:
        lines.append("-- partition skew --")
        for st in skews:
            verdict = "HOT" if st.get("hot") else "ok"
            lines.append(
                f"  {verdict:3s} {st['ratio']:6.2f}x on worker "
                f"{st['worker']} ({st['rows']} rows peak, "
                f"{st['exchanges']} exchanges) at {st['site']}")
    cp = report.get("critical_path") or []
    if cp:
        lines.append("-- critical path (top edges by exclusive "
                     "time) --")
        for e in cp:
            lines.append(
                f"  {e['excl_us']:>10d}us excl ({e['dur_us']}us "
                f"total) rank {e['rank']}  {e['path']}")
    return "\n".join(lines) + "\n"
