"""The scheduler and ``Context.submit`` (``thrill_tpu_torch/service/
scheduler.py``) against the reference package's on the CPU.

The reference's ``tests/service/test_scheduler.py`` on both packages:
client threads submitting concurrently at W = 1 and 2 give every job's
result bit for bit as a serial run of the same job on the same
package, and the reference's serial run (the integer jobs bit for bit,
the f64 Sum within one ulp: ROADMAP.md queue C, C24); a failing job fails only its own future with a ``PipelineError``
whose generation is the one its future names, and the queue goes on;
``WfqQueue``'s order, ``take`` and the latency buckets and quantiles are
the reference's on the same seeded pushes; a submit after close, and a
first submit after the Context's close, resolve failed; the typed
sheds carry the reference's ``retry_after_s``; a fence runs between two
jobs on the dispatcher thread; an exception that ``sticky_cuda_error``
recognises poisons the scheduler, and every queued future fails with the
reference's message. The served job's spans (the ``service`` lane) and
the live gauges are checked in ``tests/test_torch_observability.py``.

Tolerance: exact, but the f64 Sum against the reference's (one ulp).
"""

import random
import threading
import time

import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.api import PipelineError as JPipelineError
from thrill_tpu.common import faults as jfaults
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
from thrill_tpu.service import scheduler as jsched

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.service import scheduler as tsched

_ENV = ("THRILL_TPU_SERVE_WEIGHTS", "THRILL_TPU_SERVE_HBM_BUDGETS",
        "THRILL_TPU_SERVE_QUEUE", "THRILL_TPU_SERVE_TENANT_QUEUE",
        "THRILL_TPU_SERVE_RATE", "THRILL_TPU_SERVE_PORT",
        "THRILL_TPU_AUTOSCALE_S")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in _ENV + (faults.ENV_VAR,):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _ctx(side, W):
    if side == "j":
        return JContext(JMeshExec(num_workers=W))
    return tt.Context(num_workers=W, device="cpu")


# module-level functors: stable identities keep the exchange sites' caches
def _kv7(x):
    return (x % 7, x)


def _kv5(x):
    return (x % 5, x * 2)


def _add(a, b):
    return a + b


def _mul17(x):
    return x * 1.7


def _reduce_job(ctx):
    return sorted((int(k), int(v)) for k, v in ctx.Distribute(
        np.arange(96, dtype=np.int64)).Map(_kv7).ReducePair(
            _add).AllGather())


def _reduce_job2(ctx):
    return sorted((int(k), int(v)) for k, v in ctx.Distribute(
        np.arange(64, dtype=np.int64)).Map(_kv5).ReducePair(
            _add).AllGather())


def _float_job(ctx):
    # order-sensitive float math: the bit-identity probe
    return float(ctx.Distribute(
        np.linspace(0.0, 1.0, 41)).Map(_mul17).Sum())


def _sort_job(ctx):
    rng = np.random.default_rng(23)
    return [int(x) for x in ctx.Distribute(
        rng.integers(0, 1 << 40, 300)).Sort().AllGather()]


_JOBS = [_reduce_job, _reduce_job2, _float_job, _sort_job]
_REDUCE_WANT = sorted((k, sum(x for x in range(96) if x % 7 == k))
                      for k in range(7))


def _midstream_boom(ctx):
    ctx.Distribute(np.arange(16, dtype=np.int64)).Map(_kv7).Size()
    raise RuntimeError("mid-stream failure")


def _serve(ctx, W):
    """Three client threads, each submitting every job under its own
    tenant, one failing job among them: (results by (client, job),
    the failing future, stats)."""
    futures, boom = {}, {}

    def client(i):
        for j, fn in enumerate(_JOBS):
            futures[(i, j)] = ctx.submit(fn, tenant=f"t{i}",
                                         name=f"c{i}-{fn.__name__}")
            if i == 1 and j == 1:
                boom["f"] = ctx.submit(_midstream_boom, tenant=f"t{i}",
                                       name="boom")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = {k: f.result(300) for k, f in futures.items()}
    err = boom["f"].exception(300)
    return got, err, boom["f"], ctx.overall_stats()


@pytest.mark.parametrize("W", [1, 2])
def test_concurrent_submission_bit_identical_to_reference_serial(W):
    want = {}
    for side in ("j", "t"):
        ref = _ctx(side, W)
        try:
            want[side] = [fn(ref) for fn in _JOBS]
        finally:
            ref.close()
    out = {}
    for side in ("j", "t"):
        ctx = _ctx(side, W)
        try:
            out[side] = _serve(ctx, W)
        finally:
            ctx.close()
    for side, (got, err, fut, stats) in out.items():
        # every served job bit for bit its package's serial run
        for (i, j), res in got.items():
            assert res == want[side][j], (side, i, j)
        perr = JPipelineError if side == "j" else tt.PipelineError
        assert isinstance(err, perr) and isinstance(err.root, RuntimeError)
        assert fut.generation == err.generation
        assert (stats["jobs_submitted"], stats["jobs_failed"],
                stats["pipeline_aborts"]) == (13, 1, 1)
    # and the reference's serial runs: the integer jobs exactly; the f64
    # Sum within one ulp (the port's device sum adds in another order
    # than XLA's at W = 1: ROADMAP.md queue C, C24)
    for j, fn in enumerate(_JOBS):
        if fn is _float_job:
            a, b = want["t"][j], want["j"][j]
            assert a == b or np.nextafter(a, b) == b, (W, a, b)
        else:
            assert want["t"][j] == want["j"][j], fn.__name__
    keys = ("jobs_submitted", "jobs_failed", "jobs_rejected",
            "jobs_rate_limited", "pipeline_aborts")
    assert {k: out["t"][3][k] for k in keys} == \
        {k: out["j"][3][k] for k in keys}
    assert set(out["t"][3]["serve_p50_ms"]) == \
        set(out["j"][3]["serve_p50_ms"]) == {"t0", "t1", "t2"}


def _boom_job(ctx):
    ctx.Distribute(np.arange(8, dtype=np.int64)).Map(_kv7).Size()
    raise ValueError("boom: user logic failed mid-pipeline")


@pytest.mark.parametrize("W", [1, 2])
def test_a_failing_job_heals_only_itself_as_the_reference(W):
    seen = {}
    for side in ("j", "t"):
        ctx = _ctx(side, W)
        try:
            f1 = ctx.submit(_reduce_job, tenant="a")
            f2 = ctx.submit(_boom_job, tenant="a", name="boom")
            f3 = ctx.submit(_float_job, tenant="b")
            err = f2.exception(300)
            r1, r3 = f1.result(300), f3.result(300)
            r4 = ctx.submit(_reduce_job, tenant="a").result(300)
            stats = ctx.overall_stats()
            # the f64 Sum against this package's serial run (C24)
            serial = _ctx(side, W)
            try:
                assert r3 == _float_job(serial)
            finally:
                serial.close()
            seen[side] = dict(
                r=(r1, r4), kind=type(err).__name__,
                root=type(err.root).__name__, boom="boom" in str(err),
                gens=(f1.generation, f2.generation, f3.generation),
                gen_err=err.generation, cause=err.cause,
                stats=(stats["jobs_submitted"], stats["jobs_failed"],
                       stats["pipeline_aborts"]))
        finally:
            ctx.close()
    j, t = seen["j"], seen["t"]
    assert t == j
    assert t["gens"][1] == t["gen_err"]
    assert t["kind"] == "PipelineError" and t["root"] == "ValueError"
    assert t["stats"] == (4, 1, 1)


def _pushes(seed):
    """A seeded sequence of (tenant, name) pushes and the weights."""
    rng = random.Random(seed)
    weights = {"a": 3.0, "b": 1.0, "c": 1.5, "d": 0.5}
    return weights, [(rng.choice("abcd"), f"j{i}") for i in range(60)]


def _wfq_order(mod, weights, pushes, takes=()):
    q = mod.WfqQueue(weights)
    jobs = []
    for i, (t, name) in enumerate(pushes):
        jobs.append(q.push(None, t, name, mod.JobFuture(i, t, name)))
    order = []
    for t, seq in takes:
        got = q.take(t, seq)
        order.append(("take", t, seq, got.name if got else None))
    while True:
        job = q.pop()
        if job is None:
            break
        order.append((job.name, job.tenant, job.tenant_seq, job.start_tag))
    return order, q.depth, q.depth_peak


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wfq_pop_order_and_take_equal_the_reference(seed):
    weights, pushes = _pushes(seed)
    takes = [("a", 2), ("b", 1), ("nope", 1), ("a", 2)]
    assert _wfq_order(tsched, weights, pushes, takes) == \
        _wfq_order(jsched, weights, pushes, takes)
    # the reference's own pinned order
    q = tsched.WfqQueue({"a": 2.0, "b": 1.0})
    for i in range(6):
        q.push(None, "a", f"a{i}", tsched.JobFuture(i, "a", f"a{i}"))
    for i in range(3):
        q.push(None, "b", f"b{i}", tsched.JobFuture(10 + i, "b", f"b{i}"))
    order = [q.pop().name for _ in range(9)]
    assert order == ["a0", "b0", "a1", "a2", "b1", "a3", "a4", "b2", "a5"]


def test_latency_buckets_and_quantiles_equal_the_reference():
    assert tsched._LAT_BUCKETS == jsched._LAT_BUCKETS
    for ms in (0.0, 0.4, 1.0, 1.5, 3.9, 4.0, 1e3, 123456.7, 1e12):
        assert tsched._lat_bucket(ms) == jsched._lat_bucket(ms), ms
    rng = np.random.default_rng(5)
    for _ in range(20):
        counts = [int(c) for c in rng.integers(0, 5, tsched._LAT_BUCKETS)]
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert tsched._lat_quantile(counts, q) == \
                jsched._lat_quantile(counts, q)
    assert tsched._lat_quantile([0] * tsched._LAT_BUCKETS, 0.5) == 0.0


def test_latency_histogram_and_stats_through_submit():
    ctx = _ctx("t", 1)
    try:
        ctx.submit(_reduce_job, tenant="a").result(300)
        ctx.submit(_reduce_job2, tenant="b").result(300)
        ctx.submit(_reduce_job, tenant="a").result(300)
        stats = ctx.overall_stats()
        assert set(stats["serve_p50_ms"]) == {"a", "b"}
        assert stats["serve_p99_ms"]["a"] >= stats["serve_p50_ms"]["a"] > 0
        counts_a, n_a, sum_a = ctx.service.latency_histogram()["a"]
        assert n_a == 2 and sum(counts_a) == 2 and sum_a > 0
    finally:
        ctx.close()


@pytest.mark.parametrize("side", ["j", "t"])
def test_submit_after_close_resolves_failed(side):
    ctx = _ctx(side, 1)
    assert ctx.submit(_reduce_job).result(300) == _REDUCE_WANT
    ctx.service.close()
    err = ctx.submit(_float_job).exception(5)
    assert isinstance(err, RuntimeError)
    assert str(err) == "scheduler is closed"
    ctx.close()
    # a Context that never served: its first submit after close
    ctx = _ctx(side, 1)
    ctx.close()
    f = ctx.submit(_float_job)
    assert isinstance(f.exception(5), RuntimeError)
    assert str(f.exception(5)) == "Context is closed"
    assert ctx.service is None


def _shed(side, monkeypatch, env, submits):
    """The typed verdicts of ``submits`` (tenant list) while the
    dispatcher holds one job: (kind, tenant, retry_after_s, str)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ctx = _ctx(side, 1)
    gate, started = threading.Event(), threading.Event()

    def blocker(c):
        started.set()
        assert gate.wait(120)
        return "done"

    out = []
    try:
        fb = ctx.submit(blocker, tenant="hold", name="blocker")
        assert started.wait(120)
        futs = [ctx.submit(_float_job, tenant=t) for t in submits]
        for f in futs:
            e = f.exception(0) if f.done() else None
            out.append(None if e is None else (
                e.kind, e.tenant, e.retry_after_s > 0, str(e)))
        gate.set()
        assert fb.result(300) == "done"
        for f, o in zip(futs, out):
            if o is None:
                f.result(300)
        s = ctx.service.stats()
        out.append((s["jobs_submitted"], s["jobs_rejected"],
                    s["jobs_rate_limited"], dict(ctx.service.rejected_by_tenant)))
    finally:
        gate.set()
        ctx.close()
    return out


def test_queue_full_and_tenant_queue_full_as_the_reference(monkeypatch):
    env = {"THRILL_TPU_SERVE_QUEUE": "3",
           "THRILL_TPU_SERVE_TENANT_QUEUE": "2"}
    submits = ["a", "a", "a", "b", "c", "c"]
    got = {side: _shed(side, monkeypatch, env, submits)
           for side in ("j", "t")}
    assert got["t"] == got["j"]
    kinds = [o[0] if o else None for o in got["t"][:-1]]
    assert kinds == [None, None, "tenant_queue_full", None,
                     "queue_full", "queue_full"]
    # a depth shed's hint before any job ran: depth times 0.05 s
    for o in got["t"][:-1]:
        if o:
            assert o[2]
    e = tsched.QueueFull("x", 3, 3, retry_after_s=0.15)
    assert (e.kind, e.depth, e.cap, e.retry_after_s) == ("queue_full", 3,
                                                         3, 0.15)
    assert str(e) == str(jsched.QueueFull("x", 3, 3, retry_after_s=0.15))


def test_rate_limited_carries_the_refill_time(monkeypatch):
    env = {"THRILL_TPU_SERVE_RATE": "a=0.5:1,default=100"}
    got = {side: _shed(side, monkeypatch, env, ["a", "a", "b"])
           for side in ("j", "t")}
    for side in ("j", "t"):
        first, second, third, stats = got[side]
        assert first is None and third is None
        assert second[:3] == ("rate_limited", "a", True)
        assert stats == (3, 1, 1, {"a": 1})
    # the refill time itself, on both packages' buckets
    for mod in (tsched, jsched):
        b = mod._TokenBucket(2.0, 1.0)
        assert b.try_take() == 0.0
        wait = b.try_take()
        assert 0.45 < wait <= 0.5
        e = mod.RateLimited("a", 2.0, wait)
        assert e.kind == "rate_limited" and e.retry_after_s == wait
    assert tsched._parse_rates("a=5,b=2:10,bad=x,c=0,default=50") == \
        jsched._parse_rates("a=5,b=2:10,bad=x,c=0,default=50")
    assert tsched._parse_weights("a=3,b=1.5,c=-1,d") == \
        jsched._parse_weights("a=3,b=1.5,c=-1,d")


def test_queue_cap_env_parsing(monkeypatch, capsys):
    for v, want in (("", 0), ("0", 0), ("7", 7), ("-3", 0), ("lots", 0)):
        monkeypatch.setenv("THRILL_TPU_SERVE_QUEUE", v)
        assert tsched._queue_cap() == jsched._queue_cap() == want
    assert "THRILL_TPU_SERVE_QUEUE" in capsys.readouterr().err


def test_a_fence_runs_between_two_jobs():
    ctx = _ctx("t", 2)
    order, gate, started = [], threading.Event(), threading.Event()

    def first(c):
        started.set()
        assert gate.wait(60)
        order.append(("job1", c.num_workers, threading.current_thread().name))
        return 1

    def second(c):
        order.append(("job2", c.num_workers, threading.current_thread().name))
        return 2

    try:
        f1 = ctx.submit(first)
        assert started.wait(60)
        f2 = ctx.submit(second)
        out = {}
        t = threading.Thread(target=lambda: out.update(
            r=ctx.service.fence(lambda: (order.append(
                ("fence", ctx.num_workers,
                 threading.current_thread().name)), "fenced")[1],
                timeout=60)))
        t.start()
        while not ctx.service._fences:
            time.sleep(0.005)
        gate.set()
        t.join(60)
        assert (f1.result(60), f2.result(60), out["r"]) == (1, 2, "fenced")
        # the fence ran after the job in flight and before the queued one
        assert [o[0] for o in order] == ["job1", "fence", "job2"]
        assert {o[2] for o in order} == {"thrill-serve-dispatch"}
        # a resize on a serving Context goes through the fence
        gen = ctx.generation
        ctx.resize(3)
        assert ctx.num_workers == 3 and ctx.generation > gen
        assert ctx.submit(_reduce_job).result(60) == tt.Run(
            _reduce_job, 3, device="cpu")
    finally:
        gate.set()
        ctx.close()


class _Sticky(RuntimeError):
    pass


@pytest.mark.parametrize("side", ["j", "t"])
def test_a_sticky_cuda_error_poisons_the_scheduler(side, monkeypatch):
    """The port classifies this text as a sticky CUDA error
    (``sticky_cuda_error``): ``pipeline()`` re-raises it, so the job's
    future gets it and the scheduler dies, failing every queued future
    with the reference's message. The reference does the same for its
    unrecoverable verdict, which the reference's side here stands in
    for with a dead peer's ``ClusterAbort``."""
    from thrill_tpu_torch.api.context import sticky_cuda_error
    text = ("CUDA error: an illegal memory access was encountered")
    assert sticky_cuda_error(_Sticky(text))
    if side == "j":
        from thrill_tpu.net.group import ClusterAbort

        def fail():
            raise ClusterAbort(0, text, recoverable=False)
    else:
        def fail():
            raise _Sticky(text)
    ctx = _ctx(side, 1)
    gate, started = threading.Event(), threading.Event()

    def hold_then_fail(c):
        started.set()
        assert gate.wait(60)
        c.Distribute(np.arange(8, dtype=np.int64)).Size()
        fail()

    try:
        f0 = ctx.submit(hold_then_fail, name="sticky")
        assert started.wait(60)
        queued = [ctx.submit(_reduce_job, tenant=t) for t in "abc"]
        gate.set()
        err = f0.exception(60)
        assert text in str(err)
        assert not isinstance(err, (tt.PipelineError, JPipelineError))
        for f in queued:
            e = f.exception(60)
            assert str(e).startswith(
                "job never ran: scheduler died after an unrecoverable "
                "abort: ")
        late = ctx.submit(_reduce_job).exception(5)
        assert str(late).startswith(
            "scheduler is dead after an unrecoverable abort: ")
        s = ctx.service.stats()
        assert (s["jobs_submitted"], s["jobs_failed"]) == (4, 4)
        assert not ctx.service.alive
        with pytest.raises(RuntimeError, match="scheduler is dead"):
            ctx.service.fence(lambda: None, timeout=5)
    finally:
        gate.set()
        ctx.close()


def test_submit_fault_site_fails_one_job_only():
    ctx = _ctx("t", 2)
    try:
        with faults.inject("service.submit", n=1, seed=3):
            f1 = ctx.submit(_reduce_job, tenant="a")
            assert isinstance(f1.exception(300), tt.PipelineError)
            got = ctx.submit(_reduce_job, tenant="a").result(300)
        assert ctx.overall_stats()["jobs_failed"] == 1
        assert got == tt.Run(_reduce_job, 2, device="cpu")
    finally:
        ctx.close()
