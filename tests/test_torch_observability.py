"""Live metrics, the profile thread, the fault latency mode and the stats
helpers (``thrill_tpu_torch/common/{metrics,profile,faults,stats}.py``)
against the reference package on the CPU.

Tolerance: exact. ``render_prometheus`` prints the reference's bytes for
the same stats; a real run's metric names are a subset of the
reference's and its values the reference's, but for host seconds (a
clock) and the counters the port keeps differently from the reference
since earlier slices (``bytes_wire_device``, ``_raw``,
``device_uploads``). With no port set no thread runs; with one, a scrape
parses and agrees with ``overall_stats()``. Profile samples carry the
reference's fields (no device fields on a CPU mesh). ``delay=`` sleeps
at the reference's sites as often, but ``mem.oom``, which the port also
checks for computes outside the dispatch choke point.
``common/stats.py`` matches the reference on a fixed sequence.
"""

import collections
import json
import math
import os
import socket
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from thrill_tpu.common import faults as jfaults
from thrill_tpu.common import metrics as jmetrics
from thrill_tpu.common import profile as jprofile
from thrill_tpu.common import stats as jstats
from thrill_tpu.common.logger import JsonLogger as JJsonLogger

from thrill_tpu_torch.common import faults, metrics, profile, stats
from thrill_tpu_torch.common.logger import JsonLogger

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace as T  # noqa: E402  (the jobs and their env)

JOBS = ("reduce", "sort", "q3")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in (faults.ENV_VAR, "THRILL_TPU_METRICS_PORT"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _parse(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = value
    return out


def _run(pkg, W=2):
    ctx = T._make(pkg, W)
    try:
        for name in JOBS:
            with T._Env(T._env(name)):
                T._job(name, ctx, pkg)
        mod = metrics if pkg == "port" else jmetrics
        return {"text": mod.render_prometheus(ctx),
                "stats": ctx.overall_stats(),
                "lanes": dict(ctx.tracer.lane_counts),
                "hbm": ctx.hbm.mem.total}
    finally:
        ctx.close()


@pytest.fixture(scope="module")
def scraped():
    mp = pytest.MonkeyPatch()
    mp.setenv("THRILL_TPU_HOST_RADIX", "0")
    try:
        return {pkg: _run(pkg) for pkg in ("port", "ref")}
    finally:
        mp.undo()


class _FakeCtx:
    """The same stats behind both packages' renderers."""

    def __init__(self, run):
        self._stats = run["stats"]
        self.hbm = type("H", (), {"mem": type("M", (), {
            "total": run["hbm"]})(), "tenant_bytes": {}})()
        self.tracer = type("Tr", (), {"lane_counts": run["lanes"]})()

    def overall_stats(self, **_):
        return dict(self._stats)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_render_prometheus_prints_the_reference_s_bytes(scraped, pkg):
    fake = _FakeCtx(scraped[pkg])
    assert metrics.render_prometheus(fake) == jmetrics.render_prometheus(fake)


_DIFFERENT = ("thrill_tpu_bytes_wire_device", "thrill_tpu_bytes_wire_device_raw",
              "thrill_tpu_device_uploads")


def test_a_real_scrape_has_the_reference_s_names_and_values(scraped):
    port, ref = _parse(scraped["port"]["text"]), _parse(scraped["ref"]["text"])
    assert set(port) <= set(ref)
    for name in sorted(set(port) & set(ref)):
        base = name.split("{")[0]
        if base.endswith("_s") or base in _DIFFERENT:
            continue
        assert port[name] == ref[name], name
    assert port["thrill_tpu_device_dispatches"] == \
        str(scraped["port"]["stats"]["device_dispatches"])
    assert 'thrill_tpu_trace_spans{lane="dispatch"}' in port


def _metrics_threads():
    return [t for t in threading.enumerate() if "metrics" in t.name]


def test_no_metrics_thread_without_a_port():
    before = len(_metrics_threads())
    ctx = T._make("port", 1)
    try:
        assert ctx._metrics is None
        assert len(_metrics_threads()) == before
    finally:
        ctx.close()


@pytest.mark.parametrize("raw", ["", "0", "-1", "bogus"])
def test_an_unset_or_bad_port_is_off(raw, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_METRICS_PORT", raw)
    assert metrics.maybe_start(object()) is None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_scrape_during_a_run_matches_overall_stats(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_METRICS_PORT", str(_free_port()))
    ctx = T._make("port", 2)
    try:
        assert ctx._metrics is not None and _metrics_threads()
        T._job("reduce", ctx, "port")
        url = f"http://127.0.0.1:{ctx._metrics.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        got = _parse(body)
        st = ctx.overall_stats()
        assert got["thrill_tpu_device_dispatches"] == \
            str(st["device_dispatches"])
        assert got["thrill_tpu_exchanges"] == str(st["exchanges"])
        for line in body.splitlines():
            assert line.startswith("# TYPE thrill_tpu_") or \
                line.startswith("thrill_tpu_")
    finally:
        ctx.close()
    assert ctx._metrics is None
    time.sleep(0.05)
    assert not _metrics_threads()


def _samples(mod, logger_cls, tmp_path, name):
    path = str(tmp_path / name)
    log = logger_cls(path)
    th = mod.ProfileThread(log, interval=0.02).start()
    time.sleep(0.2)
    th.stop()
    log.close()
    return [json.loads(l) for l in open(path)]


def test_profile_samples_carry_the_reference_s_fields(tmp_path):
    mine = _samples(profile, JsonLogger, tmp_path, "p.json")
    ref = _samples(jprofile, JJsonLogger, tmp_path, "r.json")
    assert len(mine) >= 2 and len(ref) >= 2
    assert {k for s in mine for k in s} == {k for s in ref for k in s}
    assert all(s["event"] == "profile" for s in mine)
    assert all(s["host_mem_total"] > 0 for s in mine)
    assert all(0.0 <= s["cpu_util"] <= 1.0 for s in mine[1:])


def test_device_memory_stats_are_empty_on_a_cpu_mesh():
    assert profile._device_memory_stats("cpu") == {}
    assert profile._device_memory_stats() == jprofile._device_memory_stats()


def test_a_profiled_context_logs_samples(tmp_path, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_PROFILE", "1")
    monkeypatch.setenv("THRILL_TPU_LOG", str(tmp_path / "l.json"))
    ctx = T._make("port", 1)
    try:
        assert ctx._profiler is not None
        time.sleep(0.7)
    finally:
        ctx.close()
    assert ctx._profiler is None
    evs = [json.loads(l) for l in open(tmp_path / "l-host0.json")]
    assert any(e["event"] == "profile" for e in evs)


def _delays(pkg):
    reg = (faults if pkg == "port" else jfaults).REGISTRY
    reg.reset()
    ctx = T._make(pkg, 2)
    try:
        for name in JOBS:
            with T._Env(T._env(name)):
                T._job(name, ctx, pkg)
        st = ctx.overall_stats()
    finally:
        ctx.close()
    sites = collections.Counter(e["site"] for e in reg.events
                                if e.get("kind") == "delay")
    return sites, st["faults_delayed"], reg.stats()


def test_delay_sleeps_and_counts_at_the_reference_s_sites(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "*:delay=0.0001s:n=0")
    port, port_n, port_st = _delays("port")
    ref, ref_n, ref_st = _delays("ref")
    assert port_n == sum(port.values()) == port_st["faults_delayed"]
    assert ref_n == sum(ref.values())
    assert port_st["faults_injected"] == ref_st["faults_injected"] == 0
    oom, joom = port.pop("mem.oom"), ref.pop("mem.oom")
    assert port == ref
    assert oom >= joom


def test_a_delay_sleeps_as_long_as_asked(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "s.slow:delay=50ms:n=2")
    for mod in (faults, jfaults):
        mod.REGISTRY.reset()
        t0 = time.perf_counter()
        for _ in range(3):
            mod.check("s.slow")
        dt = time.perf_counter() - t0
        assert 0.1 <= dt < 2.0
        assert mod.REGISTRY.stats()["faults_delayed"] == 2
        recs = [e for e in mod.REGISTRY.events if e["site"] == "s.slow"]
        assert [(e["kind"], e["delay_s"]) for e in recs] == \
            [("delay", 0.05)] * 2


def test_the_writeback_and_prefetch_sites_are_declared():
    from thrill_tpu_torch.data import writeback  # noqa: F401
    for site in ("data.spill.writeback", "vfs.prefetch"):
        assert site in faults.REGISTRY.sites


def test_a_writeback_fault_poisons_the_writer(monkeypatch):
    from thrill_tpu_torch.data.writeback import AsyncWriter
    monkeypatch.setenv(faults.ENV_VAR, "data.spill.writeback:n=1")
    w = AsyncWriter("t.spill", sync=False)
    w.submit(lambda: 4)
    with pytest.raises(faults.InjectedFault):
        w.flush()
    w.close(drain=False)


def test_a_prefetch_fault_degrades_to_the_demand_read(monkeypatch):
    from thrill_tpu_torch.data.writeback import (make_readahead,
                                                 overlapped_fetch)
    monkeypatch.setenv(faults.ENV_VAR, "vfs.prefetch:n=0")
    ra = make_readahead(2)
    try:
        got = [v for _, v in overlapped_fetch(range(4), lambda i: i * i,
                                              "t", ra)]
    finally:
        ra.shutdown(wait=True)
    assert got == [0, 1, 4, 9]
    assert faults.REGISTRY.stats()["recoveries"] >= 1


_SEQ = [3.5, -1.0, 2.25, 1e9, 7.0, 7.0, -4.5, 0.125]


def _agg_trace(mod):
    a, b = mod.Aggregate(), mod.Aggregate()
    for x in _SEQ[:5]:
        a.add(x)
    for x in _SEQ[5:]:
        b.add(x)
    out = [(a.count, a.total, a.min, a.max, a.mean, a.stdev)]
    a += b
    out.append((a.count, a.total, a.min, a.max, a.mean, a.stdev))
    e = mod.Aggregate()
    out.append((e.count, e.min, e.max, e.mean, e.stdev))
    e += mod.Aggregate()
    out.append((e.count, e.stdev))
    c = mod.StatsCounter()
    c.incr()
    c.incr(5)
    out.append(int(c))
    return out


def test_aggregate_and_counter_match_the_reference():
    mine, ref = _agg_trace(stats), _agg_trace(jstats)
    assert mine == ref
    assert math.isinf(mine[2][1])


def test_stats_timer_matches_the_reference():
    for mod in (stats, jstats):
        t = mod.StatsTimer()
        assert t.seconds == 0.0
        with t:
            time.sleep(0.01)
        assert t.seconds > 0.0 and t.ms == t.seconds * 1e3
        s = t.seconds
        t.stop()
        assert t.seconds == s
        t2 = mod.StatsTimer(start=True)
        assert t2._running


def test_stats_disabled_makes_no_op_timers(monkeypatch):
    monkeypatch.setattr(stats, "STATS_ENABLED", False)
    t = stats.StatsTimer(start=True)
    assert not t._running
    c = stats.StatsCounter()
    c.incr(3)
    assert int(c) == 0
    assert np.isfinite(stats.Aggregate().add(1.0).mean)
