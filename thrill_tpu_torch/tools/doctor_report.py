"""Offline performance-doctor report over JSON event logs.

The in-process doctor (common/doctor.py) diagnoses a live Context;
this tool rebuilds the same report from the event logs a run left
behind — pass every rank's log (multi-controller runs merge by the
``rank`` field exactly like tools/trace2perfetto.py):

* **critical path** — recomputed from the merged ``event=span``
  records (parent chains across job -> exchange -> dispatch), naming
  the top edges by exclusive time;
* **partition skew** — per-site max ``skew_ratio`` / hot worker folded
  from the ``event=exchange`` lines' per-worker receive columns;
* **wait attribution** — the ``collective_wait_s`` decomposition and
  straggler waits from the ``event=overall_stats`` lines: ONE
  cluster-merged line when the run produced one (multi-host ranks
  each log the identical merged stats — summing them would inflate
  P-fold), per-rank local views summed otherwise.

Usage::

    python -m thrill_tpu_torch.tools.doctor_report LOG.json [LOG2.json ...]

A copy of the reference package's ``tools/doctor_report.py`` that prints the
same bytes on the same logs, whichever package wrote them.
"""

from __future__ import annotations

import sys
from typing import List

from ..common.doctor import (critical_path, fold_skew_sites,
                             render_report)
from .json2profile import load_many

_WAIT_KEYS = ("collective_wait_s", "wait_net_s", "wait_exchange_s",
              "wait_io_s", "wait_skew_s")


def build_report(events: List[dict], k: int = 5) -> dict:
    """Doctor-report dict (the common/doctor.py ``report()`` shape)
    from merged event logs."""
    report: dict = {key: 0.0 for key in _WAIT_KEYS}
    waits: dict = {}
    # multi-rank stats dedup: on a P-host run every rank logs the
    # CLUSTER-MERGED overall_stats (the merge stamps "hosts"), so
    # summing all P identical lines would inflate the waits P-fold —
    # use ONE merged line when any exists; per-rank LOCAL views (no
    # "hosts" field: single-host runs, aborted/serving ranks) are
    # genuine partials and sum
    stats_lines = [e for e in events
                   if e.get("event") == "overall_stats"]
    merged = [e for e in stats_lines if e.get("hosts")]
    for e in (merged[:1] if merged else stats_lines):
        for key in _WAIT_KEYS:
            try:
                report[key] += float(e.get(key, 0) or 0)
            except (TypeError, ValueError):
                pass
        for p, w in (e.get("straggler_waits") or {}).items():
            try:
                waits[str(p)] = waits.get(str(p), 0.0) + float(w)
            except (TypeError, ValueError):
                pass
    skew_sites = fold_skew_sites(events)
    report["straggler_waits"] = {
        p: round(w, 4) for p, w in sorted(waits.items())}
    if waits:
        floor = min(waits.values()) if len(waits) > 1 else 0.0
        scores = {p: round(w - floor, 4) for p, w in waits.items()}
        report["straggler_scores"] = dict(sorted(scores.items()))
        best = max(sorted(scores), key=lambda p: scores[p])
        report["straggler_rank"] = (int(best)
                                    if scores[best] > 0 else None)
    report["skew_sites"] = sorted(
        ({"site": s, **st} for s, st in skew_sites.items()),
        key=lambda d: -d["ratio"])
    report["critical_path"] = critical_path(events, k=k)
    return report


def main() -> None:
    if len(sys.argv) < 2:
        print("usage: doctor_report LOG.json [LOG2.json ...]",
              file=sys.stderr)
        sys.exit(2)
    report = build_report(load_many(sys.argv[1:]))
    sys.stdout.write(render_report(report))


if __name__ == "__main__":
    main()
