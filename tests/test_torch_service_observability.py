"""The service plane's observability against the reference package's on
the CPU: the tracer's ``service`` lane, the scheduler's log lines and the
live service gauges of ``common/metrics.py``.

* A served job at W = 1 and 2 writes the reference's ``service`` lane:
  a ``queue_wait`` span and a ``job:<name>`` span with ``tenant``,
  ``job``, ``job_id``, ``generation`` and ``ok`` (the failing job's with
  ``ok`` false and its ``error``), and every span the job's pipeline
  makes nests under the job's span and carries its name (the tracer's
  ``current_job``).
* The ``job_submit`` and ``job_done`` log lines have the reference's
  fields and values (but for host seconds), and ``json2profile`` prints
  the reference's bytes for the served log.
* ``render_prometheus`` prints the reference's bytes for the same
  service state (queue depth, jobs in flight, the per-tenant latency
  histogram, the tenants' HBM bytes); a scrape of a serving Context has
  the gauges and the histogram's series.

Tolerance: exact.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common import metrics as jmetrics
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
from thrill_tpu.tools import json2profile as jjson2profile

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults, metrics
from thrill_tpu_torch.tools import json2profile

_NOISE = ("ts", "ts_us", "dur_us", "trace", "span", "parent", "run_s",
          "queue_wait_s", "pid", "tid")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in (faults.ENV_VAR, "THRILL_TPU_SERVE_PORT",
                "THRILL_TPU_AUTOSCALE_S", "THRILL_TPU_TRACE",
                "THRILL_TPU_METRICS_PORT"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _kv(x):
    return (x % 3, x)


def _add(a, b):
    return a + b


def _job(ctx):
    return sorted((int(k), int(v)) for k, v in ctx.Distribute(
        np.arange(50, dtype=np.int64)).Map(_kv).ReducePair(_add).AllGather())


def _boom(ctx):
    ctx.Distribute(np.arange(8, dtype=np.int64)).Map(_kv).Size()
    raise ValueError("boom")


def _served(side, W, log_path):
    os.environ["THRILL_TPU_LOG"] = log_path
    try:
        ctx = (JContext(JMeshExec(num_workers=W)) if side == "j"
               else tt.Context(num_workers=W, device="cpu"))
    finally:
        del os.environ["THRILL_TPU_LOG"]
    try:
        ok = ctx.submit(_job, tenant="a", name="n1").result(120)
        err = ctx.submit(_boom, tenant="b", name="n2").exception(120)
        ring = list(ctx.tracer.ring)
    finally:
        ctx.close()
    return ok, err, ring


def _clean_rec(r):
    out = {k: v for k, v in r.items() if k not in _NOISE}
    if "error" in out and out["error"]:
        out["error"] = out["error"].split("(")[0]
    return out


@pytest.mark.parametrize("W", [1, 2])
def test_the_service_lane_and_the_job_lines_are_the_reference_s(W, tmp_path):
    got = {}
    for side in ("j", "t"):
        log = str(tmp_path / f"{side}.json")
        ok, err, ring = _served(side, W, log)
        service = [_clean_rec(r) for r in ring if r.get("cat") == "service"]
        job_span = {r["name"]: r["span"] for r in ring
                    if r.get("cat") == "service"}
        # every span of the first job's pipeline nests under its span and
        # carries the job's name
        by_id = {r["span"]: r for r in ring}

        def under(r, root):
            while r.get("parent") is not None:
                if r["parent"] == root:
                    return True
                r = by_id.get(r["parent"], {})
            return False
        nested = [r for r in ring if r.get("cat") != "service"
                  and under(r, job_span["job:n1"])]
        assert nested and all(r.get("job") == "n1" for r in nested)
        assert all(r.get("tenant") == "a" for r in nested)
        lines = []
        with open(log.replace(".json", "-host0.json")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("event") in ("job_submit", "job_done"):
                    rec.pop("program", None)
                    lines.append(_clean_rec(rec))
        got[side] = (ok, type(err).__name__, service, lines)
    assert got["t"] == got["j"]
    service = got["t"][2]
    assert [r["name"] for r in service] == ["queue_wait", "job:n1",
                                            "queue_wait", "job:n2"]
    assert service[1]["ok"] is True and service[3]["ok"] is False
    assert {"tenant", "job", "job_id", "generation"} <= set(service[1])


def test_json2profile_prints_the_reference_s_bytes_for_a_served_log(tmp_path):
    log = str(tmp_path / "t.json")
    _served("t", 2, log)
    path = log.replace(".json", "-host0.json")

    def run(mod):
        out = io.StringIO()
        saved = sys.argv
        sys.argv = ["json2profile", path]
        try:
            with contextlib.redirect_stdout(out):
                mod.main()
        finally:
            sys.argv = saved
        return out.getvalue()

    mine = run(json2profile)
    assert mine == run(jjson2profile)
    assert "n1" in mine and "n2" in mine


class _Svc:
    """A fixed service state behind both packages' renderers."""

    def __init__(self):
        self.queue = type("Q", (), {"depth": 5})()
        self.jobs_done = 7
        self.jobs_submitted = 12

    def latency_histogram(self):
        counts = [0] * 28
        counts[2], counts[5], counts[27] = 3, 1, 2
        return {"a": (counts, 6, 123.4567), "b\"x": ([0] * 27 + [1], 1,
                                                    9e9)}


class _FakeCtx:
    def __init__(self, service):
        self.service = service
        self.hbm = type("H", (), {"mem": type("M", (), {"total": 4096})(),
                                  "tenant_bytes": {"a": 1024, "b": 2048}})()
        self.tracer = type("Tr", (), {"lane_counts": {"service": 4}})()

    def overall_stats(self, **_):
        return {"jobs_submitted": 12, "serve_p50_ms": {"a": 4.0},
                "queue_depth_peak": 9}


@pytest.mark.parametrize("with_service", [True, False])
def test_render_prometheus_prints_the_reference_s_bytes(with_service):
    fake = _FakeCtx(_Svc() if with_service else None)
    text = metrics.render_prometheus(fake)
    assert text == jmetrics.render_prometheus(fake)
    if with_service:
        for series in ("thrill_tpu_queue_depth 5",
                       "thrill_tpu_jobs_in_flight 5",
                       'thrill_tpu_serve_latency_ms_bucket{tenant="a",le="4"} 3',
                       'thrill_tpu_serve_latency_ms_bucket{tenant="a",le="32"} 4',
                       'thrill_tpu_serve_latency_ms_bucket{tenant="a",le="+Inf"} 6',
                       'thrill_tpu_serve_latency_ms_sum{tenant="a"} 123.457',
                       'thrill_tpu_tenant_hbm_bytes{tenant="b"} 2048'):
            assert series in text.splitlines(), series


def test_a_scrape_of_a_serving_context_has_the_live_gauges():
    ctx = tt.Context(num_workers=2, device="cpu")
    try:
        ctx.submit(_job, tenant="a").result(120)
        ctx.submit(_job, tenant="b").result(120)
        lines = metrics.render_prometheus(ctx).splitlines()
    finally:
        ctx.close()
    assert "# TYPE thrill_tpu_queue_depth gauge" in lines
    assert "thrill_tpu_jobs_in_flight 0" in lines
    assert "# TYPE thrill_tpu_serve_latency_ms histogram" in lines
    for t in ("a", "b"):
        assert f'thrill_tpu_serve_latency_ms_count{{tenant="{t}"}} 1' in lines
        assert f'thrill_tpu_serve_latency_ms_bucket{{tenant="{t}",le="+Inf"}} 1' \
            in lines
    assert "thrill_tpu_jobs_submitted 2" in lines
