"""Render JSON event logs into a standalone HTML timeline report.

Equivalent of the reference's misc/json2profile.cpp (the HTML report
with CPU/net/disk/stage timelines). Sections: stage timeline, stage
summary table (duration/items/rate/per-worker balance), stage x worker
item matrix, exchange volume, per-worker exchange lanes, memory
pressure, host CPU + RAM + HBM overlay. Usage:

    python -m thrill_tpu_torch.tools.json2profile LOG.json [LOG2.json ...] \
        > report.html

Multiple logs (one per host of a multi-controller run) merge on the
shared timestamp axis; per-host samples are tagged by file order.

A copy of the reference package's ``tools/json2profile.py`` that prints the
same bytes on the same logs, whichever package wrote them.
"""

from __future__ import annotations

import html
import json
import sys
from typing import List


def load_events(path: str, host: int = 0) -> List[dict]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    e = json.loads(line)
                    e.setdefault("host", host)
                    events.append(e)
                except json.JSONDecodeError:
                    continue
    return events


def load_many(paths: List[str]) -> List[dict]:
    events = []
    for h, p in enumerate(paths):
        events.extend(load_events(p, host=h))
    events.sort(key=lambda e: e.get("ts", 0))
    return events


def _merge_host_nodes(per_host: dict) -> dict:
    """Merge per-(dia_id, host) node records into one per dia_id.

    Every controller of a multi-host run logs the same stages, so the
    records must MERGE, not overwrite: span = [min start, max end];
    counts that agree on every host are one replicated global value
    (device-path stages), disagreeing counts are per-host partials
    (host-storage stages hold only local workers' items) and sum."""
    merged: dict = {}
    for nid, by_host in per_host.items():
        m: dict = {}
        starts = [d["start"] for d in by_host.values() if "start" in d]
        ends = [d["end"] for d in by_host.values() if "end" in d]
        if starts:
            m["start"] = min(starts)
        if ends:
            m["end"] = max(ends)
        labels = [d.get("label") for d in by_host.values()
                  if d.get("label")]
        if labels:
            m["label"] = labels[0]
        items = [d["items"] for d in by_host.values()
                 if d.get("items") is not None]
        pws = [d["per_worker"] for d in by_host.values()
               if d.get("per_worker")]
        # ONE replicated-vs-partial decision for both count fields: the
        # per-worker split is the more discriminating signal (per-host
        # partials can coincide in total while owning different
        # workers), fall back to the scalar only without it
        if pws:
            replicated = all(p == pws[0] for p in pws)
        elif items:
            replicated = all(x == items[0] for x in items)
        else:
            replicated = True
        if items:
            m["items"] = items[0] if replicated else sum(items)
        if pws:
            if replicated:
                m["per_worker"] = pws[0]
            else:
                W = max(len(p) for p in pws)
                m["per_worker"] = [
                    sum(p[w] if w < len(p) else 0 for p in pws)
                    for w in range(W)]
        merged[nid] = m
    return merged


def render_html(events: List[dict]) -> str:
    per_host_nodes: dict = {}
    profiles = []
    exchanges = []
    fused = []         # fused_dispatch (api/fusion.py program stitching)
    jobs = []          # job_submit / job_done (service/scheduler.py)
    loops = []         # iteration / loop_* (api/loop.py LoopPlan replay)
    ckpt = []          # checkpoint / ckpt_restore / resume (durability)
    overall = []       # overall_stats summary lines
    device_xchg: dict = {}   # host -> ordered device-plane exchanges
    memory = []        # hbm_spill / hbm_restore / mem_negotiate / demotion
    io_events = []     # prefetch / writeback / restore_overlap
    faults = []        # fault_injected / retry / recovery / abort
    decisions = []     # decision / decision_audit (common/decisions.py)
    t0 = min((e["ts"] for e in events), default=0)
    for e in events:
        t = (e["ts"] - t0) / 1e6
        h = e.get("host", 0)
        if e.get("event") == "node_execute_start":
            per_host_nodes.setdefault(e.get("dia_id"), {}).setdefault(
                h, {}).update(start=t, label=e.get("node"))
        elif e.get("event") == "node_execute_done":
            per_host_nodes.setdefault(e.get("dia_id"), {}).setdefault(
                h, {}).update(end=t, items=e.get("items"),
                              per_worker=e.get("per_worker"))
        elif e.get("event") == "profile":
            profiles.append((t, e))
        elif e.get("event") == "exchange":
            # device-plane exchanges log GLOBAL bytes (derived from the
            # replicated send matrix) in the same deterministic order
            # on every controller: keep ONE host's sequence — the most
            # complete one, so a truncated host-0 log cannot hide
            # exchanges other hosts recorded
            device_xchg.setdefault(h, []).append((t, e))
        elif e.get("event") == "host_exchange":
            # host-plane counters are per-process partials: keep all
            exchanges.append((t, e))
        elif e.get("event") in ("hbm_spill", "hbm_restore",
                                "mem_negotiate", "device_to_host",
                                "host_replicate", "mem_spill",
                                "oom_retry", "segment_split"):
            memory.append((t, e))
        elif e.get("event") in ("prefetch", "writeback",
                                "restore_overlap"):
            io_events.append((t, e))
        elif e.get("event") in ("fault_injected", "retry", "recovery",
                                "abort", "pipeline_abort", "heal"):
            # the abort/heal lane: scoped pipeline failures and their
            # generation heals render chronologically alongside the
            # faults that caused them (reconnects arrive as
            # event=recovery what=net.reconnect)
            faults.append((t, e))
        elif e.get("event") == "fused_dispatch":
            fused.append(e)
        elif e.get("event") in ("job_submit", "job_done",
                                "plan_store_load", "plan_store_save"):
            jobs.append((t, e))
        elif e.get("event") in ("iteration", "loop_replay", "loop_plan",
                                "loop_capture_miss",
                                "loop_replay_fallback", "loop_done",
                                "loop_fori_unavailable"):
            loops.append((t, e))
        elif e.get("event") in ("checkpoint", "ckpt_restore", "resume"):
            ckpt.append((t, e))
        elif e.get("event") in ("decision", "decision_audit"):
            decisions.append(e)
        elif e.get("event") == "overall_stats":
            overall.append(e)
    if device_xchg:
        best = max(sorted(device_xchg), key=lambda h: len(device_xchg[h]))
        exchanges.extend(device_xchg[best])
        exchanges.sort(key=lambda te: te[0])
    nodes = _merge_host_nodes(per_host_nodes)

    rows = []
    for nid in sorted(k for k in nodes if k is not None):
        n = nodes[nid]
        if "start" not in n or "end" not in n:
            continue
        dur = n["end"] - n["start"]
        rows.append((nid, n.get("label", "?"), n["start"], dur,
                     n.get("items")))
    total = max((r[2] + r[3] for r in rows), default=1.0)

    bars = []
    for nid, label, start, dur, items in rows:
        left = 100.0 * start / total
        width = max(100.0 * dur / total, 0.2)
        bars.append(
            f'<div class="row"><span class="lbl">#{nid} '
            f'{html.escape(str(label))}</span>'
            f'<div class="track"><div class="bar" style="left:{left:.2f}%;'
            f'width:{width:.2f}%"></div></div>'
            f'<span class="dur">{dur * 1e3:.1f} ms'
            f'{f" · {items} items" if items is not None else ""}</span>'
            f'</div>')

    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>thrill_tpu profile</title><style>
body {{ font: 13px monospace; margin: 2em; }}
.row {{ display: flex; align-items: center; margin: 2px 0; }}
.lbl {{ width: 22em; }}
.track {{ position: relative; flex: 1; height: 14px; background: #eee; }}
.bar {{ position: absolute; top: 0; height: 100%; background: #07c; }}
.mark {{ position: absolute; top: 0; height: 100%; background: #e60; }}
.dur {{ width: 16em; text-align: right; color: #666; }}
.cpu {{ width: 100%; height: 80px; background: #f7f7f7; }}
.vol {{ width: 100%; height: 120px; background: #f7f7f7; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #ccc; padding: 2px 8px; text-align: right; }}
th {{ background: #eee; }}
td.l, th.l {{ text-align: left; }}
td.hm {{ min-width: 3em; }}
</style></head><body>
<h1>thrill_tpu execution profile</h1>
<p>{len(rows)} executed nodes, total span {total:.3f}s,
{len(profiles)} profile samples, {len(exchanges)} exchanges</p>
<h2>stage timeline</h2>
{''.join(bars)}
{_render_stage_table(rows, exchanges, nodes)}
{_render_stage_worker_matrix(nodes)}
{_render_exchange_volume(exchanges, total)}
{_render_overlap_lane(exchanges, overall, total)}
{_render_wire_lane(overall)}
{_render_worker_lanes(exchanges, total)}
{_render_skew_lane(exchanges, overall)}
{_render_memory_events(memory, total)}
{_render_io_lane(io_events, overall)}
{_render_fused_dispatches(fused, overall)}
{_render_decisions(decisions, overall)}
{_render_service_jobs(jobs, overall, total)}
{_render_loop_iterations(loops, overall)}
{_render_checkpoint_events(ckpt, overall)}
{_render_fault_events(faults)}
{_render_host_overlay(profiles, total)}
</body></html>"""


def _render_fused_dispatches(fused, overall) -> str:
    """Program-stitching table: per-stage fused-op lists with launch
    counts, and the fused-vs-unfused dispatch budget. Each fused
    dispatch carrying k ops saved k-1 link round trips versus the
    per-op dispatch model (THRILL_TPU_FUSE=0), so the 'saved' column
    IS the dispatch delta the fusion planner bought."""
    if not fused and not overall:
        return ""
    by_stage: dict = {}
    for e in fused:
        ops = tuple(e.get("ops") or ())
        by_stage[ops] = by_stage.get(ops, 0) + 1
    rows = []
    tot_disp = tot_ops = 0
    for ops, n in sorted(by_stage.items(),
                         key=lambda kv: -kv[1] * len(kv[0])):
        tot_disp += n
        tot_ops += n * len(ops)
        rows.append(
            f"<tr><td class=l>{html.escape(' + '.join(ops))}</td>"
            f"<td>{len(ops)}</td><td>{n}</td>"
            f"<td>{n * (len(ops) - 1)}</td></tr>")
    summary = ""
    if overall:
        o = overall[-1]
        fd = o.get("fused_dispatches", tot_disp)
        fo = o.get("fused_ops", tot_ops)
        dd = o.get("device_dispatches")
        summary = (f"<p>device dispatches: <b>{dd}</b> total, "
                   f"{fd} launched by the fusion runner carrying "
                   f"{fo} DOp segments (unfused they would have cost "
                   f"{(dd or 0) + max(fo - fd, 0)} dispatches)</p>")
    elif tot_disp:
        summary = (f"<p>{tot_disp} fused dispatches carrying "
                   f"{tot_ops} DOp segments "
                   f"({tot_ops - tot_disp} dispatches saved)</p>")
    return f"""
<h2>fused dispatches (program stitching)</h2>
{summary}
<table><tr><th class=l>stage composition</th><th>ops</th>
<th>dispatches</th><th>saved</th></tr>{''.join(rows)}</table>"""


def _render_decisions(decisions, overall) -> str:
    """Plan-observatory lane (common/decisions.py): chosen-strategy
    counts per decision kind, the optimistic exchange's hit/heal
    record, and the top-5 worst-audited sites by mean
    |log2(predicted/actual)| — where the cost model lies the most."""
    if not decisions:
        return ""
    chosen: dict = {}
    hits = misses = 0
    site_err: dict = {}
    joined = 0
    for e in decisions:
        if e.get("event") == "decision":
            key = (e.get("kind", "?"), e.get("chosen", "?"))
            chosen[key] = chosen.get(key, 0) + 1
            continue
        joined += 1
        if e.get("verdict") == "hit":
            hits += 1
        elif e.get("verdict") == "miss":
            misses += 1
        err = e.get("err_log2")
        if err is not None:
            se = site_err.setdefault(
                (e.get("kind", "?"), e.get("site", "?")), [0, 0.0])
            se[0] += 1
            se[1] += abs(err)
    rows = [f"<tr><td class=l>{html.escape(kind)}</td>"
            f"<td class=l>{html.escape(str(ch))}</td><td>{n}</td></tr>"
            for (kind, ch), n in sorted(chosen.items(),
                                        key=lambda kv: -kv[1])]
    n_dec = sum(chosen.values())
    summary = (f"<p>{n_dec} decisions recorded, {joined} with joined "
               f"actuals; optimistic-exchange audit: {hits} hits, "
               f"{misses} misses healed</p>")
    if overall:
        acc = overall[-1].get("decision_accuracy") or {}
        if isinstance(acc, dict) and acc:
            summary += ("<p>accuracy (mean |log2 pred/actual|): "
                        + ", ".join(f"{html.escape(str(k))}={v}"
                                    for k, v in sorted(acc.items()))
                        + "</p>")
    worst = [(k, s, n, tot / n)
             for (k, s), (n, tot) in site_err.items() if n]
    worst.sort(key=lambda r: -r[3])
    wrows = [f"<tr><td class=l>{html.escape(k)}</td>"
             f"<td class=l>{html.escape(s)}</td><td>{n}</td>"
             f"<td>{mae:.3f}</td></tr>"
             for k, s, n, mae in worst[:5]]
    wtable = ""
    if wrows:
        wtable = (f"<h3>worst-audited sites</h3>"
                  f"<table><tr><th class=l>kind</th>"
                  f"<th class=l>site</th><th>joins</th>"
                  f"<th>mae log2</th></tr>{''.join(wrows)}</table>")
    return f"""
<h2>plan decisions (decision ledger)</h2>
{summary}
<table><tr><th class=l>kind</th><th class=l>chosen</th>
<th>count</th></tr>{''.join(rows)}</table>
{wtable}"""


def _render_service_jobs(jobs, overall, total: float) -> str:
    """Per-job service timeline (service/scheduler.py): one row per
    submitted job — queue wait rendered as the orange span, execution
    as the blue one — plus the admission counters and plan-store
    events, so serving latency decomposes visually into waiting vs
    running the way the stage timeline decomposes a single pipeline."""
    if not jobs:
        return ""
    # pair job_submit/job_done by job id (per host)
    by_id: dict = {}
    store_rows = []
    for t, e in jobs:
        if e.get("event") == "job_submit":
            by_id.setdefault((e.get("host", 0), e.get("job")),
                             {})["submit"] = (t, e)
        elif e.get("event") == "job_done":
            by_id.setdefault((e.get("host", 0), e.get("job")),
                             {})["done"] = (t, e)
        else:
            store_rows.append(
                f"<tr><td>{t:8.3f}s</td><td class=l>"
                f"{html.escape(str(e.get('event')))}</td><td class=l>"
                f"{html.escape(str(e.get('path', '')))}</td>"
                f"<td>{e.get('entries', '')}</td></tr>")
    bars = []
    rows = []
    for (h, jid), rec in sorted(by_id.items(),
                                key=lambda kv: kv[1].get(
                                    "submit", kv[1].get("done"))[0]):
        sub = rec.get("submit")
        done = rec.get("done")
        t0 = sub[0] if sub else (done[0] - (done[1].get("run_s") or 0)
                                 - (done[1].get("queue_wait_s") or 0))
        e = done[1] if done else sub[1]
        wait = float(e.get("queue_wait_s") or 0)
        run = float(e.get("run_s") or 0)
        name = e.get("name") or f"job-{jid}"
        tenant = e.get("tenant") or "?"
        ok = e.get("ok")
        span = max(total, 1e-9)
        left = 100.0 * t0 / span
        ww = max(100.0 * wait / span, 0.1)
        rw = max(100.0 * run / span, 0.1)
        bars.append(
            f'<div class="row"><span class="lbl">{html.escape(str(name))}'
            f' [{html.escape(str(tenant))}]</span>'
            f'<div class="track">'
            f'<div class="mark" style="left:{left:.2f}%;width:{ww:.2f}%">'
            f'</div>'
            f'<div class="bar" style="left:{left + ww:.2f}%;'
            f'width:{rw:.2f}%"></div></div>'
            f'<span class="dur">{wait * 1e3:.1f} ms queued · '
            f'{run * 1e3:.1f} ms run'
            f'{" · FAILED" if ok is False else ""}</span></div>')
        rows.append(
            f"<tr><td>{t0:8.3f}s</td><td class=l>"
            f"{html.escape(str(name))}</td><td class=l>"
            f"{html.escape(str(tenant))}</td>"
            f"<td>{wait * 1e3:.1f}</td><td>{run * 1e3:.1f}</td>"
            f"<td class=l>{'ok' if ok else html.escape(str(e.get('error') or ('?' if ok is None else 'failed')))}"
            f"</td><td>{e.get('generation', '')}</td></tr>")
    summary = ""
    if overall:
        o = overall[-1]
        if o.get("jobs_submitted") is not None:
            peaks = o.get("tenant_hbm_peaks") or {}
            peak_s = ", ".join(f"{t}: {b}" for t, b in
                               sorted(peaks.items())) or "none"
            summary = (
                f"<p><b>{o.get('jobs_submitted')}</b> jobs submitted, "
                f"{o.get('jobs_failed')} failed, queue depth peak "
                f"{o.get('queue_depth_peak')}; plan builds "
                f"{o.get('plan_builds')}, plan-store hits "
                f"{o.get('plan_store_hits')}; tenant HBM peaks: "
                f"{html.escape(peak_s)}</p>")
    store_tbl = ""
    if store_rows:
        store_tbl = (f"<table><tr><th class=l>t</th><th class=l>event"
                     f"</th><th class=l>path</th><th>entries</th></tr>"
                     f"{''.join(store_rows)}</table>")
    return f"""
<h2>service jobs (queue wait + run)</h2>
{summary}
{''.join(bars)}
<table><tr><th class=l>t</th><th class=l>job</th><th class=l>tenant</th>
<th>wait ms</th><th>run ms</th><th class=l>outcome</th>
<th>gen</th></tr>{''.join(rows)}</table>
{store_tbl}"""


def _render_loop_iterations(loops, overall) -> str:
    """Iteration timeline (api/loop.py): one row per loop iteration —
    capture/plain/replay/fori mode, dispatches issued, wall seconds —
    plus plan-build/capture-miss/fallback markers and the loop_done
    summaries, so replay hit rate and donated HBM are visible next to
    the dispatch budget they bought."""
    if not loops:
        return ""
    trs = []
    for t, e in loops:
        kind = e.get("event")
        loop = e.get("loop") or e.get("name") or ""
        if kind == "iteration":
            row = (e.get("mode", "plain"), e.get("iter"),
                   e.get("dispatches"), e.get("seconds"))
        elif kind == "loop_replay":
            mode = "fori" if e.get("fori") else "replay"
            it = e.get("iter")
            if e.get("iters"):
                it = f"{it}..{it + e['iters'] - 1}"
            row = (mode, it, e.get("dispatches", 1), e.get("seconds"))
        elif kind == "loop_done":
            hit = ((e.get("replays", 0) + e.get("fori_iters", 0))
                   / max(e.get("iters", 1), 1))
            row = (f"done: {e.get('iters')} iters, "
                   f"{e.get('captures')} captures, "
                   f"replay hit {hit:.0%}, "
                   f"{e.get('fallbacks')} fallbacks, "
                   f"{e.get('donated_bytes', 0)} B donated",
                   "", "", round(e.get("capture_s", 0)
                                 + e.get("replay_s", 0), 4))
        elif kind == "loop_plan":
            row = (f"plan: {e.get('calls')} calls, "
                   f"{e.get('pruned_invariant')} invariant + "
                   f"{e.get('pruned_dead')} dead pruned, "
                   f"{e.get('donatable')} donatable"
                   f"{', fori' if e.get('fori') else ''}", "", "", "")
        else:
            row = (f"{kind}: "
                   f"{e.get('reason') or e.get('error') or ''}",
                   e.get("iter", ""), "", "")
        mode, it, disp, secs = row
        trs.append(f"<tr><td class=l>{t:8.3f}s</td>"
                   f"<td class=l>{html.escape(str(loop))}</td>"
                   f"<td class=l>{html.escape(str(mode))}</td>"
                   f"<td>{it}</td><td>{disp if disp is not None else ''}"
                   f"</td><td>{secs if secs is not None else ''}</td>"
                   f"</tr>")
    summary = ""
    if overall:
        o = overall[-1]
        if o.get("loop_plan_builds") is not None:
            summary = (f"<p>loop plans built: "
                       f"<b>{o.get('loop_plan_builds')}</b>, "
                       f"replayed iterations: {o.get('loop_replays')}"
                       f" + {o.get('loop_fori_iters')} in whole-loop "
                       f"fori dispatches, "
                       f"{o.get('loop_replay_fallbacks')} fallbacks, "
                       f"{o.get('loop_donated_bytes')} bytes of "
                       f"loop-carry HBM donated</p>")
    return f"""
<h2>iteration timeline (loop replay)</h2>
{summary}
<table><tr><th class=l>t</th><th class=l>loop</th><th class=l>mode</th>
<th>iter</th><th>dispatches</th><th>seconds</th></tr>{''.join(trs)}
</table>"""


def _render_checkpoint_events(ckpt, overall) -> str:
    """Durability timeline (api/checkpoint.py): every epoch commit,
    resume decision, and restore, with the overall checkpoint/recovery
    counters — rendered alongside the fused-dispatch table so the cost
    of durability sits next to the dispatch budget it rides on."""
    if not ckpt and not (overall and any(
            "checkpoint_epochs" in o for o in overall)):
        return ""
    trs = []
    for t, e in ckpt:
        kind = e.get("event")
        detail = ", ".join(
            f"{k}={v}" for k, v in sorted(e.items())
            if k not in ("ts", "event", "host"))
        trs.append(
            f'<tr><td>{t * 1e3:.1f}</td>'
            f'<td class="l">{html.escape(str(kind))}</td>'
            f'<td class="l">{html.escape(detail)}</td></tr>')
    summary = ""
    if overall:
        o = overall[-1]
        if "checkpoint_epochs" in o:
            summary = (
                f"<p>{o.get('checkpoint_epochs', 0)} epochs committed, "
                f"{o.get('ckpt_bytes_written', 0)} bytes sealed; resume "
                f"skipped {o.get('resume_skipped_ops', 0)} ops in "
                f"{o.get('recovery_time_s', 0)}s of recovery</p>")
    if not trs and not summary:
        return ""
    return f"""
<h2>checkpoint &amp; recovery</h2>
{summary}
<table><tr><th>ms</th><th class="l">event</th>
<th class="l">detail</th></tr>{''.join(trs)}</table>"""


def _render_fault_events(faults) -> str:
    """Robustness-layer timeline: every injected fault, retry sleep,
    recovery and coordinated abort as a chronological table (the
    observability half of the fault-injection harness in
    common/faults.py)."""
    if not faults:
        return ""
    trs = []
    for t, e in faults:
        what = e.get("site") or e.get("what") or ""
        detail = ", ".join(
            f"{k}={v}" for k, v in sorted(e.items())
            if k not in ("ts", "event", "site", "what", "host",
                         "program", "workers"))
        trs.append(
            f'<tr><td>{t * 1e3:.1f}</td>'
            f'<td class="l">{html.escape(str(e.get("event")))}</td>'
            f'<td class="l">{html.escape(str(what))}</td>'
            f'<td class="l">{html.escape(detail)}</td></tr>')
    counts = {}
    for _, e in faults:
        counts[e.get("event")] = counts.get(e.get("event"), 0) + 1
    head = ", ".join(f"{v} {k}" for k, v in sorted(counts.items()))
    return (f'<h2>faults &amp; recovery ({html.escape(head)})</h2>'
            '<table><tr><th>ms</th><th class="l">event</th>'
            '<th class="l">site</th><th class="l">detail</th></tr>'
            + "".join(trs) + "</table>")


def _render_stage_table(rows, exchanges, nodes) -> str:
    """Per-stage summary (reference: the stage table of
    misc/json2profile.cpp): duration, items, throughput, bytes shipped
    by exchanges during the stage, and worker balance (max/mean of the
    per-worker item counts — 1.0 is perfectly even)."""
    if not rows:
        return ""
    # attribute each exchange to exactly ONE stage: merged multi-host
    # records widen stage spans until they overlap, and summing every
    # exchange into every covering window counted the same bytes in
    # multiple rows. The tightest (latest-starting) covering stage wins.
    per_stage_bytes: dict = {}
    for t, e in exchanges:
        best = None
        for nid, _label, start, dur, _items in rows:
            if start <= t <= start + dur and (
                    best is None or (start, -dur) > (best[1], -best[2])):
                best = (nid, start, dur)
        if best is not None:
            per_stage_bytes[best[0]] = (per_stage_bytes.get(best[0], 0)
                                        + (e.get("bytes", 0) or 0))
    trs = []
    for nid, label, start, dur, items in rows:
        xb = per_stage_bytes.get(nid, 0)
        rate = f"{items / dur / 1e6:.2f}" if items and dur > 0 else ""
        pw = nodes.get(nid, {}).get("per_worker")
        bal = ""
        if pw and sum(pw):
            mean = sum(pw) / len(pw)
            bal = f"{max(pw) / mean:.2f}" if mean else ""
        trs.append(
            f'<tr><td class="l">#{nid} {html.escape(str(label))}</td>'
            f'<td>{dur * 1e3:.1f}</td>'
            f'<td>{items if items is not None else ""}</td>'
            f'<td>{rate}</td><td>{xb / 1e6:.2f}</td><td>{bal}</td></tr>')
    return ('<h2>stage summary</h2><table><tr><th class="l">stage</th>'
            '<th>ms</th><th>items</th><th>Mitems/s</th>'
            '<th>exchange MB</th><th>balance</th></tr>'
            + "".join(trs) + "</table>")


def _render_stage_worker_matrix(nodes) -> str:
    """Stage x worker item matrix: one row per executed stage, one cell
    per worker shaded by that worker's share of the stage's items —
    the reference report's per-worker lanes, in matrix form."""
    entries = [(nid, n) for nid, n in sorted(nodes.items(),
                                             key=lambda kv: (kv[0] is None,
                                                             kv[0]))
               if nid is not None and n.get("per_worker")]
    if not entries:
        return ""
    W = max(len(n["per_worker"]) for _, n in entries)
    head = "".join(f"<th>w{w}</th>" for w in range(W))
    trs = []
    for nid, n in entries:
        pw = n["per_worker"]
        peak = max(pw) or 1
        cells = []
        for w in range(W):
            v = pw[w] if w < len(pw) else 0
            alpha = v / peak if peak else 0
            cells.append(
                f'<td class="hm" style="background:rgba(0,119,204,'
                f'{alpha:.2f})">{v}</td>')
        trs.append(f'<tr><td class="l">#{nid} '
                   f'{html.escape(str(n.get("label", "?")))}</td>'
                   + "".join(cells) + "</tr>")
    return ('<h2>stage x worker items</h2><table>'
            f'<tr><th class="l">stage</th>{head}</tr>'
            + "".join(trs) + "</table>")


def _render_host_overlay(profiles, total: float) -> str:
    """Host CPU utilization, host RAM in use and device HBM in use on
    one time axis, one polyline set per host (multi-controller logs
    merge into one report)."""
    if not profiles:
        return ""
    hosts = sorted({e.get("host", 0) for _, e in profiles})
    palette = ["#07c", "#e60", "#2a4", "#a3c", "#888"]
    out = []

    def series(pred, norm, title):
        lines, legend = [], []
        for i, h in enumerate(hosts):
            pts = [(t, pred(e)) for t, e in profiles
                   if e.get("host", 0) == h and pred(e) is not None]
            if not pts:
                continue
            top = norm(pts)
            if not top:
                continue
            s = " ".join(f"{100 * t / total:.2f},"
                         f"{78 - 74 * min(v / top, 1.0):.1f}"
                         for t, v in pts)
            color = palette[i % len(palette)]
            lines.append(f'<polyline fill="none" stroke="{color}" '
                         f'stroke-width="0.5" points="{s}"/>')
            legend.append(f'<span style="color:{color}">host{h}</span>')
        if not lines:
            return ""
        return (f'<h2>{title} ({" ".join(legend)})</h2>'
                f'<svg viewBox="0 0 100 80" class="cpu" '
                f'preserveAspectRatio="none">{"".join(lines)}</svg>')

    out.append(series(lambda e: e.get("cpu_util"), lambda p: 1.0,
                      "host CPU utilization"))
    out.append(series(
        lambda e: (e["host_mem_total"] - e["host_mem_available"])
        if e.get("host_mem_total") and e.get("host_mem_available")
        is not None else None,
        lambda p: max(v for _, v in p),
        "host RAM in use"))
    out.append(series(lambda e: e.get("bytes_in_use"),
                      lambda p: max((v for _, v in p), default=0) or None,
                      "device HBM in use"))
    return "".join(out)


def _render_memory_events(memory, total: float) -> str:
    """Memory-pressure timeline: HBM spills/restores, device->host
    demotions, negotiation grants, and the escalation-ladder events
    (admission spills, OOM retries, segment splits — mem/pressure.py)
    as ticks on one lane each (reference: BlockPool occupancy in the
    profile report)."""
    if not memory:
        return ""
    kinds = ["hbm_spill", "hbm_restore", "device_to_host",
             "mem_negotiate", "mem_spill", "oom_retry",
             "segment_split"]
    lanes = []
    for kind in kinds:
        evs = [(t, e) for t, e in memory if e.get("event") == kind]
        if not evs:
            continue
        vol = sum(e.get("bytes", 0) or 0 for _, e in evs)
        marks = "".join(
            f'<div class="mark" style="left:{100 * t / total:.2f}%;'
            f'width:0.4%;height:100%"></div>' for t, _ in evs)
        extra = f" · {vol / 1e6:.1f} MB" if vol else ""
        lanes.append(
            f'<div class="row"><span class="lbl">{kind}</span>'
            f'<div class="track">{marks}</div>'
            f'<span class="dur">{len(evs)} events{extra}</span></div>')
    if not lanes:
        return ""
    return "<h2>memory pressure</h2>" + "".join(lanes)


def _render_io_lane(io_events, overall) -> str:
    """Out-of-core I/O lane: per-site prefetch summaries
    (hits/misses/wait), write-behind flush summaries (bytes/jobs), and
    restore-overlap markers, with the run's overlap ledger from
    overall_stats (hit rate, io_wait vs io_busy, write-behind volume,
    queue high-water mark)."""
    if not io_events and not any(
            o.get("io_busy_s") for o in overall):
        return ""
    rows = []
    for _, e in io_events:
        kind = e.get("event")
        if kind == "prefetch":
            detail = (f"hits {e.get('hits', 0)} · misses "
                      f"{e.get('misses', 0)} · wait "
                      f"{e.get('wait_s', 0):.3f}s · depth "
                      f"{e.get('depth', '?')}")
            where = e.get("what") or e.get("path", "?")
        elif kind == "writeback":
            detail = (f"{(e.get('bytes', 0) or 0) / 1e6:.1f} MB · "
                      f"{e.get('jobs', 0)} jobs"
                      f"{' · SYNC' if e.get('sync') else ''}")
            where = e.get("what", "?")
        else:                                   # restore_overlap
            detail = (f"{e.get('prefetched', 0)} of "
                      f"{e.get('blocks', e.get('files', '?'))} blocks "
                      f"prefetched")
            where = e.get("kind", "?")
        rows.append(f"<tr><td class='l'>{kind}</td>"
                    f"<td class='l'>{html.escape(str(where))}</td>"
                    f"<td class='l'>{detail}</td></tr>")
    # one aggregate over every host's overall_stats line (flows sum,
    # the queue peak maxes), through the ONE formula definition
    # (common/iostats.py) so report and stats can never diverge
    from ..common.iostats import hit_rate, overlap_frac
    agg = {"prefetch_hits": 0, "prefetch_misses": 0, "io_wait_s": 0.0,
           "io_busy_s": 0.0, "writeback_bytes": 0,
           "writeback_queue_peak": 0, "restore_overlaps": 0}
    for o in overall:
        for k in agg:
            v = o.get(k, 0) or 0
            agg[k] = max(agg[k], v) if k == "writeback_queue_peak" \
                else agg[k] + v
    summary = ""
    if agg["io_busy_s"]:
        n = agg["prefetch_hits"] + agg["prefetch_misses"]
        summary = (
            f"<p>prefetch hit rate {hit_rate(agg):.2f} "
            f"({agg['prefetch_hits']}/{n})"
            f" · io_wait {agg['io_wait_s']:.3f}s of "
            f"{agg['io_busy_s']:.3f}s busy "
            f"(overlap {overlap_frac(agg):.2f})"
            f" · write-behind {agg['writeback_bytes'] / 1e6:.1f} MB, "
            f"queue peak {agg['writeback_queue_peak']}"
            f" · {agg['restore_overlaps']} overlapped restores</p>")
    if not rows and not summary:
        return ""
    table = ("<table><tr><th class='l'>event</th><th class='l'>site"
             "</th><th class='l'>detail</th></tr>"
             + "".join(rows) + "</table>") if rows else ""
    return "<h2>out-of-core I/O</h2>" + summary + table


def _render_exchange_volume(exchanges, total: float) -> str:
    """Cumulative cross-worker bytes over time, with the DCN share as a
    second line on multi-slice meshes."""
    if not exchanges:
        return ""
    cum = cum_dcn = 0
    pts, pts_dcn = [(0.0, 0)], [(0.0, 0)]
    for t, e in exchanges:
        cum += e.get("bytes", 0)
        cum_dcn += e.get("bytes_dcn", 0)
        pts.append((t, cum))
        pts_dcn.append((t, cum_dcn))
    top = max(cum, 1)

    def line(p, color):
        s = " ".join(f"{100 * t / total:.2f},{118 - 110 * v / top:.1f}"
                     for t, v in p)
        return (f'<polyline fill="none" stroke="{color}" '
                f'stroke-width="0.6" points="{s}"/>')

    dcn = line(pts_dcn, "#e60") if cum_dcn else ""
    return (f'<h2>exchange volume (cumulative {cum / 1e6:.1f} MB'
            f'{f", DCN {cum_dcn / 1e6:.1f} MB" if cum_dcn else ""})</h2>'
            f'<svg viewBox="0 0 100 120" class="vol" '
            f'preserveAspectRatio="none">{line(pts, "#07c")}{dcn}</svg>')


def _render_overlap_lane(exchanges, overall, total: float) -> str:
    """Exchange-overlap lane (data/exchange.py overlapped data plane):
    one tick per device-plane exchange — overlapped dispatches
    (capacity-cache hit, no mid-shuffle host sync) vs synced plans —
    rendered next to the exchange-volume lanes, with the run's overlap
    fraction and capacity-plan cache hit rate from overall_stats."""
    dev = [(t, e) for t, e in exchanges if e.get("event") == "exchange"]
    if not dev:
        return ""
    lanes = []
    for kind, pred in (("overlapped", lambda e: e.get("overlapped")),
                       ("synced plan", lambda e: not e.get("overlapped"))):
        evs = [(t, e) for t, e in dev if pred(e)]
        marks = "".join(
            f'<div class="mark" style="left:{100 * t / total:.2f}%;'
            f'width:0.4%;height:100%"></div>' for t, _ in evs)
        lanes.append(
            f'<div class="row"><span class="lbl">{kind}</span>'
            f'<div class="track">{marks}</div>'
            f'<span class="dur">{len(evs)} exchanges</span></div>')
    summary = ""
    if overall:
        o = overall[-1]
        ex = o.get("exchanges") or 0
        ov = o.get("exchanges_overlapped", 0)
        h, m = o.get("cap_cache_hits", 0), o.get("cap_cache_misses", 0)
        wire = o.get("bytes_on_wire", 0)
        summary = (
            f"<p>overlap fraction <b>{(ov / ex if ex else 0):.0%}</b>"
            f" ({ov}/{ex} exchanges dispatched with no mid-shuffle "
            f"host sync), capacity-plan cache "
            f"{(h / (h + m) if h + m else 0):.0%} hit "
            f"({h} hits / {m} misses), "
            f"{wire / 1e6:.2f} MB on the wire</p>")
    return ("<h2>exchange overlap (capacity-plan cache)</h2>"
            + summary + "".join(lanes))


def _render_wire_lane(overall) -> str:
    """Bytes-on-wire lane: actual vs
    raw-equivalent wire volume per plane with the run's compression
    ratio — a wire regression (ratio sliding toward 1.0 on a workload
    that used to compress, or absolute bytes growing) is as loud here
    as a dispatch-budget slip."""
    if not overall:
        return ""
    o = overall[-1]
    wire = o.get("bytes_on_wire", 0)
    raw = o.get("bytes_on_wire_raw", wire)
    if not raw:
        return ""
    ratio = o.get("wire_compress_ratio",
                  round(raw / wire, 3) if wire else 1.0)
    dev = o.get("bytes_wire_device", 0)
    dev_raw = o.get("bytes_wire_device_raw", dev)
    host = o.get("bytes_wire_host", 0)
    host_saved = o.get("bytes_wire_host_saved", 0)
    width = max(wire, raw, 1)
    rows = []
    for label, actual, raw_eq in (
            ("device rows", dev, dev_raw),
            ("host frames", host, host + host_saved)):
        if not raw_eq:
            continue
        pct = 100.0 * actual / width
        pct_raw = 100.0 * raw_eq / width
        rows.append(
            f'<div class="row"><span class="lbl">{label}</span>'
            f'<div class="track">'
            f'<div class="mark" style="left:0;width:{pct_raw:.1f}%;'
            f'height:35%;top:0;background:#ccc"></div>'
            f'<div class="mark" style="left:0;width:{pct:.1f}%;'
            f'height:35%;top:55%"></div></div>'
            f'<span class="dur">{actual / 1e6:.2f} of '
            f'{raw_eq / 1e6:.2f} MB</span></div>')
    return (
        f"<h2>bytes on wire (shrink-the-wire)</h2>"
        f"<p><b>{wire / 1e6:.2f} MB</b> shipped of "
        f"{raw / 1e6:.2f} MB raw-equivalent — compression ratio "
        f"<b>{ratio}x</b> (grey = raw, colored = shipped)</p>"
        + "".join(rows))


def _render_worker_lanes(exchanges, total: float) -> str:
    """One lane per worker: each exchange draws a tick whose height is
    that worker's share of the shipped items (send side) — skew between
    lanes is load imbalance in the data plane."""
    pairs = [(t, e["per_worker_sent"]) for t, e in exchanges
             if e.get("per_worker_sent")]
    if not pairs:
        return ""
    W = max(len(p) for _, p in pairs)
    # tolerate appended logs from runs with different worker counts
    pairs = [(t, p) for t, p in pairs if len(p) == W]
    peak = max((max(p) for _, p in pairs), default=1) or 1
    lanes = []
    for w in range(W):
        sent_total = sum(p[w] for _, p in pairs)
        marks = []
        for t, p in pairs:
            h = max(100.0 * p[w] / peak, 2.0) if p[w] else 0.0
            if h:
                marks.append(
                    f'<div class="mark" style="left:'
                    f'{100 * t / total:.2f}%;width:0.4%;height:{h:.0f}%;'
                    f'top:{100 - h:.0f}%"></div>')
        lanes.append(
            f'<div class="row"><span class="lbl">worker {w}</span>'
            f'<div class="track">{"".join(marks)}</div>'
            f'<span class="dur">{sent_total} items sent</span></div>')
    return "<h2>per-worker exchange lanes</h2>" + "".join(lanes)


def _render_skew_lane(exchanges, overall) -> str:
    """Partition-skew lane (common/doctor.py): per exchange SITE, the
    worst receive-side max/mean ratio and the hot worker it lands on —
    the per-site table behind the run's ``skew_ratio`` summary. A HOT
    verdict (ratio past THRILL_TPU_SKEW_HOT) is the signal to re-key
    or pre-aggregate that operator."""
    from ..common.doctor import fold_skew_sites
    sites = fold_skew_sites(e for _, e in exchanges)
    if not sites:
        return ""
    head = ("<tr><th class='l'>exchange site</th><th>exchanges</th>"
            "<th>items moved</th><th>max skew</th><th>hot worker</th>"
            "<th class='l'>verdict</th></tr>")
    rows = []
    for site, st in sorted(sites.items(), key=lambda kv: -kv[1]["ratio"]):
        verdict = (f"HOT ({st['ratio']:.1f}x the mean on worker "
                   f"{st['worker']})" if st["hot"]
                   else "balanced")
        rows.append(
            f"<tr><td class='l'>{html.escape(site)}</td>"
            f"<td>{st['exchanges']}</td><td>{st['items']}</td>"
            f"<td>{st['ratio']:.2f}x</td><td>{st['worker']}</td>"
            f"<td class='l'>{verdict}</td></tr>")
    summary = ""
    if overall:
        o = overall[-1]
        if o.get("skew_ratio") is not None:
            summary = (f"<p>run skew_ratio {o.get('skew_ratio')} · "
                       f"collective_wait_s "
                       f"{o.get('collective_wait_s', 0)}s (net "
                       f"{o.get('wait_net_s', 0)} / exchange "
                       f"{o.get('wait_exchange_s', 0)} / io "
                       f"{o.get('wait_io_s', 0)} / skew "
                       f"{o.get('wait_skew_s', 0)})</p>")
    return ("<h2>partition skew</h2>" + summary
            + "<table>" + head + "".join(rows) + "</table>")


def main() -> None:
    if len(sys.argv) < 2:
        print("usage: json2profile LOG.json [LOG2.json ...] "
              "> report.html", file=sys.stderr)
        sys.exit(2)
    sys.stdout.write(render_html(load_many(sys.argv[1:])))


if __name__ == "__main__":
    main()
