"""Export thrill_tpu span logs as Chrome-trace-event JSON.

Reads the JSON-lines event logs the tracing spine emits
(``event=span`` records from common/trace.py — the same files
json2profile renders, and flight-recorder dumps work too) and writes
the Chrome trace-event format that loads directly in Perfetto
(ui.perfetto.dev) or chrome://tracing:

* one **pid lane per rank** (multi-controller logs merge into one
  timeline — pass every host's log; the span records carry their
  ``rank``, and the generation/job tags they share are what correlates
  work across controllers);
* one **tid lane per subsystem** (dispatch / fusion / exchange / host /
  net / mem / loop / service), named via thread_name metadata;
* spans become complete (``ph="X"``) events with their correlation
  tags (``trace``/``span``/``parent``, generation, tenant, job) in
  ``args``; instants (ladder rungs, exchange verdicts) become ``ph="i"``
  marks; every OTHER log event (exchange, pipeline_abort, heal,
  job_submit...) lands as an instant on a per-rank ``log`` lane so the
  flat event stream stays visible next to the spans it correlates with.

Usage::

    python -m thrill_tpu_torch.tools.trace2perfetto [--merge] \
        LOG.json [LOG2.json ...] > trace.json

``--merge`` is the explicit multi-host spelling: every rank's log
merges into ONE timeline on the shared timestamp axis — one pid lane
per rank, correlated by the generation/job tags the spans carry.
Records without a ``rank``/``host`` tag take their FILE's index as
the pid lane (an untagged rank's events must not collapse onto rank
0's lane). Passing several logs without the flag behaves identically
— one merge implementation serves both spellings.

A copy of the reference package's ``tools/trace2perfetto.py`` that prints the
same bytes on the same logs, whichever package wrote them.
"""

from __future__ import annotations

import json
import sys
from typing import List

from .json2profile import load_many

#: fixed tid per category so lanes are stable across runs/ranks
_LANES = ("service", "loop", "fusion", "dispatch", "exchange", "host",
          "net", "mem", "log")

_TAGS = ("trace", "span", "parent", "generation", "tenant", "job")


def _tid(cat: str) -> int:
    try:
        return _LANES.index(cat)
    except ValueError:
        return len(_LANES)


def _args(e: dict, skip=("event", "ts", "dur_us", "cat", "name",
                         "rank", "host", "kind", "program",
                         "workers")) -> dict:
    return {k: v for k, v in e.items()
            if k not in skip and v is not None}


def to_chrome(events: List[dict]) -> dict:
    """Event dicts (json2profile.load_events/load_many shape) ->
    Chrome trace-event document."""
    out = []
    seen_lanes = set()          # (pid, tid, name) metadata emitted once
    seen_pids = set()
    for e in events:
        ev = e.get("event")
        ts = e.get("ts")
        if ts is None:
            continue
        pid = int(e.get("rank", e.get("host", 0)) or 0)
        if ev == "span":
            cat = str(e.get("cat", "log"))
            name = str(e.get("name", "?"))
            instant = e.get("kind") == "instant" \
                or not e.get("dur_us")
        else:
            # flat log events ride a per-rank "log" lane so aborts,
            # heals and exchanges line up against the spans
            cat, name, instant = "log", str(ev), True
        tid = _tid(cat)
        if pid not in seen_pids:
            seen_pids.add(pid)
            out.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name",
                        "args": {"name": f"rank {pid}"}})
        if (pid, tid) not in seen_lanes:
            seen_lanes.add((pid, tid))
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": cat}})
        rec = {"pid": pid, "tid": tid, "ts": int(ts), "name": name,
               "cat": cat, "args": _args(e)}
        if instant:
            rec.update(ph="i", s="t")
        else:
            rec.update(ph="X", dur=int(e.get("dur_us", 0)))
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def main() -> None:
    # --merge is the explicit multi-host spelling; the merge itself is
    # load_many's contract either way (per-file host default -> one
    # pid lane per rank even in hand-rolled logs; ts-sorted axis) —
    # ONE implementation, so the two spellings cannot drift
    argv = sys.argv[1:]
    if argv and argv[0] == "--merge":
        argv = argv[1:]
    if not argv:
        print("usage: trace2perfetto [--merge] LOG.json "
              "[LOG2.json ...] > trace.json", file=sys.stderr)
        sys.exit(2)
    doc = to_chrome(load_many(argv))
    json.dump(doc, sys.stdout)
    sys.stdout.write("\n")


if __name__ == "__main__":
    main()
