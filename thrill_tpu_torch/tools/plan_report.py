"""Render the plan observatory from JSON event logs.

The offline twin of ``ctx.explain()`` (common/decisions.py): rebuilds
the physical-plan tree from ``node_execute_start`` / ``node_fused``
events, joins every ``event=decision`` record with its
``event=decision_audit`` line, and prints the annotated tree plus the
audited accuracy ledger (per-kind mean |log2(predicted/actual)| and
the worst-audited sites). Usage:

    python -m thrill_tpu_torch.tools.plan_report LOG.json [LOG2.json ...]

Multiple logs (one per host of a multi-controller run) merge on the
shared timestamp axis; decision seqs are joined per host (each host's
ledger numbers its own records).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from ..common.decisions import render_accuracy, render_plan
from ..common.stats import Aggregate
from .json2profile import load_many


def collect(events: List[dict]) -> Tuple[List[dict], List[dict]]:
    """(nodes, decisions) in render_plan's input form."""
    nodes: Dict[int, dict] = {}
    for e in events:
        ev = e.get("event")
        if ev in ("node_execute_start", "node_fused"):
            nid = e.get("dia_id")
            if nid is None:
                continue
            n = nodes.setdefault(int(nid), {"id": int(nid)})
            n["label"] = e.get("node", "?")
            n["parents"] = [int(p) for p in (e.get("parents") or ())]
            n["state"] = "FUSED" if ev == "node_fused" else "EXECUTED"
    decisions: List[dict] = []
    by_seq: Dict[Tuple[int, int], dict] = {}
    for e in events:
        ev = e.get("event")
        if ev == "decision":
            d = dict(e)
            decisions.append(d)
            if "seq" in e:
                by_seq[(e.get("host", 0), e["seq"])] = d
        elif ev == "decision_audit" and "seq" in e:
            d = by_seq.get((e.get("host", 0), e["seq"]))
            if d is not None:
                for k in ("actual", "err_log2", "verdict"):
                    if e.get(k) is not None:
                        d[k] = e[k]
    return list(nodes.values()), decisions


def accuracy_of(decisions: List[dict]) -> Tuple[dict, List[dict]]:
    """Recompute the per-kind accuracy ledger and worst-site table
    from joined decision dicts (the offline form of
    ``DecisionLedger.accuracy`` / ``worst_sites``)."""
    acc: Dict[str, Aggregate] = {}
    counts: Dict[str, int] = {}
    joined: Dict[str, int] = {}
    site_err: Dict[Tuple[str, str], List[float]] = {}
    for d in decisions:
        kind = d.get("kind", "?")
        counts[kind] = counts.get(kind, 0) + 1
        if d.get("verdict") is None:
            continue
        joined[kind] = joined.get(kind, 0) + 1
        err = d.get("err_log2")
        if err is None:
            continue
        acc.setdefault(kind, Aggregate()).add(abs(err))
        se = site_err.setdefault((kind, d.get("site", "?")), [0, 0.0])
        se[0] += 1
        se[1] += abs(err)
    table = {}
    for kind, n in sorted(counts.items()):
        agg = acc.get(kind)
        table[kind] = {
            "n": n, "joined": joined.get(kind, 0),
            "mae_log2": round(agg.mean, 4) if agg is not None else None,
            "stdev_log2": round(agg.stdev, 4)
            if agg is not None else None}
    worst = [{"kind": k, "site": s, "n": n,
              "mae_log2": round(tot / n, 4)}
             for (k, s), (n, tot) in site_err.items() if n]
    worst.sort(key=lambda r: -r["mae_log2"])
    return table, worst[:5]


def render(events: List[dict]) -> str:
    nodes, decisions = collect(events)
    workers = next((e.get("workers") for e in events
                    if e.get("workers") is not None), None)
    out = [render_plan(nodes, decisions, W=workers,
                       title="plan report")]
    table, worst = accuracy_of(decisions)
    if table:
        out.append("")
        out.append(render_accuracy(table, worst))
    else:
        out.append("\n(no event=decision lines in this log — run with "
                   "THRILL_TPU_DECISIONS=1 and THRILL_TPU_LOG set)")
    return "\n".join(out)


def main() -> None:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        raise SystemExit(2)
    print(render(load_many(sys.argv[1:])))


if __name__ == "__main__":
    main()
