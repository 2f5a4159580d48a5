"""Live metrics: a Prometheus text endpoint on a daemon thread
(counterpart of the reference package's ``common/metrics.py``).

``THRILL_TPU_METRICS_PORT=<port>`` makes every Context serve ``GET
/metrics`` (any path, in fact) with its ``overall_stats()`` counters,
the live service gauges (``thrill_tpu_queue_depth``,
``thrill_tpu_jobs_in_flight`` and the per-tenant histogram
``thrill_tpu_serve_latency_ms``), the HBM governor's live bytes, total
and per tenant, and the tracer's span counts per lane, in
Prometheus text exposition format, so a long job can be scraped while
it runs. A scrape reads this process's view (``overall_stats(
local_only=True)``): gathering every process's counters would be a
collective on the scrape thread.

A scrape reads host counters only: plain attribute reads under the
GIL, with the live dicts copied before they are iterated. It makes no
CUDA call and never waits for the device.

An unset, invalid or 0 port is off: no thread, no cost. The endpoint
binds ``127.0.0.1`` unless ``THRILL_TPU_METRICS_ADDR`` names another
address.
"""

from __future__ import annotations

import http.server
import os
import re
import sys
import threading
import weakref
from typing import Optional

_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _label(v) -> str:
    return str(v).replace("\\", "").replace('"', "").replace("\n", " ")


def render_prometheus(ctx) -> str:
    """One scrape's worth of metrics text for ``ctx``."""
    lines = []

    def gauge(name: str, value, labels: str = "") -> None:
        lines.append(f"{name}{labels} {value}")

    try:
        stats = ctx.overall_stats(local_only=True)
    except Exception as e:  # a scrape must answer, never raise
        return f"# thrill_tpu stats unavailable: {e!r}\n"
    for k in sorted(stats):
        v = stats[k]
        name = "thrill_tpu_" + _BAD.sub("_", str(k))
        if _num(v):
            lines.append(f"# TYPE {name} gauge")
            gauge(name, v)
        elif isinstance(v, dict):
            sub = [(t, b) for t, b in sorted(v.items()) if _num(b)]
            if sub:
                lines.append(f"# TYPE {name} gauge")
                for t, b in sub:
                    gauge(name, b, f'{{key="{_label(t)}"}}')
    # what is queued or running now
    svc = getattr(ctx, "service", None)
    if svc is not None:
        depth = getattr(getattr(svc, "queue", None), "depth", 0)
        done = getattr(svc, "jobs_done", 0)
        sub = getattr(svc, "jobs_submitted", 0)
        lines.append("# TYPE thrill_tpu_queue_depth gauge")
        gauge("thrill_tpu_queue_depth", depth)
        lines.append("# TYPE thrill_tpu_jobs_in_flight gauge")
        gauge("thrill_tpu_jobs_in_flight", max(sub - done, 0))
        # per-tenant accept-to-result latency: cumulative ``le`` buckets
        # at the scheduler's log2 boundaries
        hist = getattr(svc, "latency_histogram", None)
        hist = hist() if callable(hist) else {}
        if hist:
            name = "thrill_tpu_serve_latency_ms"
            lines.append(f"# TYPE {name} histogram")
            for tenant, (counts, count, sum_ms) in hist.items():
                t = _label(tenant)
                cum = 0
                for i, c in enumerate(counts[:-1]):
                    # the last bucket clamps the latencies past every
                    # boundary: it folds into +Inf only
                    if not c:
                        continue
                    cum += c
                    gauge(f"{name}_bucket", cum,
                          f'{{tenant="{t}",le="{1 << i}"}}')
                gauge(f"{name}_bucket", count,
                      f'{{tenant="{t}",le="+Inf"}}')
                gauge(f"{name}_count", count, f'{{tenant="{t}"}}')
                gauge(f"{name}_sum", round(sum_ms, 3),
                      f'{{tenant="{t}"}}')
    hbm = getattr(ctx, "hbm", None)
    if hbm is not None:
        lines.append("# TYPE thrill_tpu_hbm_live_bytes gauge")
        gauge("thrill_tpu_hbm_live_bytes", hbm.mem.total)
        tb = dict(getattr(hbm, "tenant_bytes", None) or {})
        if tb:
            lines.append("# TYPE thrill_tpu_tenant_hbm_bytes gauge")
            for t, b in sorted(tb.items()):
                gauge("thrill_tpu_tenant_hbm_bytes", b,
                      f'{{tenant="{_label(t)}"}}')
    tr = getattr(ctx, "tracer", None)
    lanes = dict(tr.lane_counts) if tr is not None else {}
    if lanes:
        lines.append("# TYPE thrill_tpu_trace_spans gauge")
        for lane, n in sorted(lanes.items()):
            gauge("thrill_tpu_trace_spans", n,
                  f'{{lane="{_label(lane)}"}}')
    return "\n".join(lines) + "\n"


class MetricsServer:
    """ThreadingHTTPServer on a daemon thread, bound to the Context by
    weakref (a server left open does not keep its Context alive)."""

    def __init__(self, ctx, port: int,
                 addr: Optional[str] = None) -> None:
        ctx_ref = weakref.ref(ctx)

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                c = ctx_ref()
                if c is None:
                    self.send_response(503)
                    self.end_headers()
                    return
                try:
                    body = render_prometheus(c).encode()
                except Exception as e:  # answer, never drop the conn
                    body = f"# thrill_tpu scrape failed: {e!r}\n" \
                        .encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass                    # scrapes must not spam stderr

        if addr is None:
            addr = os.environ.get("THRILL_TPU_METRICS_ADDR", "127.0.0.1")
        self.httpd = http.server.ThreadingHTTPServer((addr, port),
                                                     Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="thrill-tpu-torch-metrics", daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5)


def maybe_start(ctx) -> Optional[MetricsServer]:
    """Start the endpoint when THRILL_TPU_METRICS_PORT names a port. A
    failed bind (port taken) is reported on stderr and leaves no
    endpoint: observability must not take the job down."""
    raw = os.environ.get("THRILL_TPU_METRICS_PORT", "")
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        print(f"thrill_tpu_torch: bad THRILL_TPU_METRICS_PORT={raw!r}; "
              f"metrics endpoint disabled", file=sys.stderr)
        return None
    if port <= 0:
        return None
    try:
        return MetricsServer(ctx, port)
    except OSError as e:
        print(f"thrill_tpu_torch: metrics endpoint failed to bind port "
              f"{port}: {e}; disabled", file=sys.stderr)
        return None
