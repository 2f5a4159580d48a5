"""The port's write-behind and readahead (``data/writeback.py``), its
fault grammar (``common/faults.py``) and retry policy
(``common/retry.py``), against the reference package: AsyncWriter's
order and its errors at ``flush``/``close``, ``overlapped_fetch``'s order
and its fall back to the demand read, ``prefetch_depth``, and the
``THRILL_TPU_FAULTS`` parse on the grammar's examples."""

import os
import random
import threading
import time

import pytest

from thrill_tpu.common import faults as jfaults
from thrill_tpu.common import retry as jretry
from thrill_tpu.data import writeback as jwb
from thrill_tpu.vfs import file_io as jfio

from thrill_tpu_torch.common import faults, retry
from thrill_tpu_torch.data import writeback as wb
from thrill_tpu_torch.vfs import file_io as fio


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in (faults.ENV_VAR, "THRILL_TPU_WRITEBACK", "THRILL_TPU_OVERLAP",
                "THRILL_TPU_PREFETCH", "THRILL_TPU_WRITEBACK_QUEUE",
                "THRILL_TPU_RETRY", "THRILL_TPU_RETRY_ATTEMPTS",
                "THRILL_TPU_RETRY_BASE_S", "THRILL_TPU_RETRY_MAX_S"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _write_in_order(mod, n=40, **kw):
    done = []

    def job(i):
        time.sleep(random.random() * 1e-3)
        done.append(i)
        return i

    with mod.AsyncWriter("test", **kw) as w:
        for i in range(n):
            w.submit(lambda i=i: job(i), tag=i)
    return done, w.jobs_run, w.bytes_written


@pytest.mark.parametrize("sync", [False, True])
def test_async_writer_runs_jobs_in_submission_order(sync):
    got = _write_in_order(wb, sync=sync)
    assert got == _write_in_order(jwb, sync=sync)
    assert got == (list(range(40)), 40, sum(range(40)))


def test_the_queue_bounds_what_waits():
    gate = threading.Event()
    w = wb.AsyncWriter("test", depth=2)
    w.submit(gate.wait)                  # the writer blocks on this one
    w.submit(lambda: 0)
    w.submit(lambda: 0)
    t = threading.Thread(target=w.submit, args=(lambda: 0,))
    t.start()
    t.join(0.3)
    assert t.is_alive()                  # two wait already: it blocks
    gate.set()
    t.join(5)
    assert not t.is_alive()
    w.close()
    assert w.jobs_run == 4


@pytest.mark.parametrize("barrier", ["flush", "close", "submit"])
def test_a_writer_error_surfaces_at_the_next_barrier(barrier):
    for mod in (wb, jwb):
        w = mod.AsyncWriter("test")
        w.submit(lambda: 1)
        w.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
        if barrier == "submit":
            deadline = time.time() + 5
            with pytest.raises(OSError, match="disk full"):
                while time.time() < deadline:
                    w.submit(lambda: 0)
                    time.sleep(0.01)
        else:
            with pytest.raises(OSError, match="disk full"):
                getattr(w, barrier)()
        w.close(drain=False)


def test_a_degrading_writer_hands_errors_on_and_goes_on():
    seen = []
    for mod, flt in ((wb, faults), (jwb, jfaults)):
        errs = []
        w = mod.AsyncWriter("test", poison=False,
                            on_error=lambda e, tag: errs.append((tag, str(e))))
        w.submit(lambda: (_ for _ in ()).throw(OSError("bad")), tag=7)
        w.submit(lambda: 3, tag=8)
        w.close()
        assert errs == [(7, "bad")] and w.jobs_run == 1
        assert any(e.get("what") == "test.degraded"
                   for e in flt.REGISTRY.events)
        seen.append(w.bytes_written)
    assert seen == [3, 3]


def test_writeback_switches_match_the_reference(monkeypatch):
    for env in ("1", "0", "off", ""):
        monkeypatch.setenv("THRILL_TPU_WRITEBACK", env)
        assert wb.writeback_enabled() == jwb.writeback_enabled()
        assert wb.AsyncWriter("x").sync == jwb.AsyncWriter("x").sync
        assert wb.AsyncWriter("x").depth == jwb.AsyncWriter("x").depth \
            == wb.QUEUE_DEPTH


@pytest.mark.parametrize("env", [None, "0", "1", "9", "junk"])
def test_prefetch_depth_matches_reference(monkeypatch, env):
    if env is not None:
        monkeypatch.setenv("THRILL_TPU_PREFETCH", env)
    assert fio.prefetch_depth() == jfio.prefetch_depth()


def _fetch_all(mod, depth, fail=(), skip=None):
    """Every item through ``overlapped_fetch``. The background read of
    an item in ``fail`` raises; before the consumer asks for such an
    item, it waits until that read has started, so the pool cannot be
    beaten to it (a future no thread started yet is cancelled and read
    on the caller without a failure to note)."""
    calls = []
    started = {i: threading.Event() for i in fail}

    def fetch(i):
        calls.append((i, threading.current_thread().name))
        if i in fail and threading.current_thread().name != "MainThread":
            started[i].set()
            raise IOError(f"background read {i}")
        time.sleep(1e-3)
        return i * i

    ra = mod.make_readahead(depth)
    st = {}
    try:
        out = []
        for it, v in mod.overlapped_fetch(range(8), fetch, "test", ra,
                                          skip_fn=skip, stats=st):
            out.append((it, v))
            if ra is not None and it + 1 in started:
                # the next item's read was submitted before this yield
                assert started[it + 1].wait(timeout=60)
    finally:
        if ra is not None:
            ra.shutdown(wait=True)
    return out, st.get("prefetched", 0), calls


@pytest.mark.parametrize("depth", [0, 1, 4])
def test_overlapped_fetch_yields_in_order(depth):
    got, pre, calls = _fetch_all(wb, depth)
    ref, jpre, _ = _fetch_all(jwb, depth)
    assert got == ref == [(i, i * i) for i in range(8)]
    assert pre == jpre == (7 if depth else 0)
    if depth:
        assert any(name != "MainThread" for _, name in calls)


def test_overlapped_fetch_falls_back_to_the_demand_read():
    faults.REGISTRY.events.clear()
    got, _, calls = _fetch_all(wb, 4, fail={2, 5})
    assert got == [(i, i * i) for i in range(8)]
    # the failed background reads were read again on the caller
    assert (2, "MainThread") in calls and (5, "MainThread") in calls
    assert sum(e.get("what") == "test.prefetch_degraded"
               for e in faults.REGISTRY.events) == 2


def test_overlapped_fetch_reads_skipped_items_inline():
    got, pre, calls = _fetch_all(wb, 4, skip=lambda i: i % 2 == 0)
    assert got == [(i, i * i) for i in range(8)]
    assert pre == 4                       # items 1, 3, 5, 7
    assert all(name == "MainThread" for i, name in calls if i % 2 == 0)


SPECS = ["mem.oom", "mem.oom:n=1", "mem.hbm.*:p=0.5:n=2:seed=7",
         "net.tcp.send:p=0.5:n=2:seed=7;vfs.*:n=1",
         "mem.oom:n=0:after=3", "x:delay=50ms", "y:delay=2s:n=0",
         "z:delay=0.25", " a ; ;b:n=3 ", "bad:p=x;good:n=2", "q:zz=1",
         ":n=1", "mem.spill:after=2:seed=-4:p=1.0"]


def _arms(arms):
    return [(a.pattern, a.p, a.n, a.seed, a.after, a.delay) for a in arms]


@pytest.mark.parametrize("spec", SPECS)
def test_the_fault_grammar_parses_as_the_reference(spec):
    assert _arms(faults.parse_spec(spec)) == _arms(jfaults.parse_spec(spec))


@pytest.mark.parametrize("spec", ["s:n=3", "s:p=0.3:n=0:seed=5",
                                  "s*:after=2:n=2", "other:n=1",
                                  "s.site:delay=0:n=0"])
def test_an_armed_site_fires_as_in_the_reference(spec, monkeypatch):
    """A latency entry (``delay=``) raises in neither package."""
    monkeypatch.setenv(faults.ENV_VAR, spec)
    fired = []
    for mod in (faults, jfaults):
        mod.REGISTRY.declare("s.site")
        got = []
        for _ in range(20):
            try:
                mod.check("s.site")
                got.append(0)
            except mod.InjectedFault:
                got.append(1)
        fired.append(got)
    assert fired[0] == fired[1]


def test_inject_composes_and_restores(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "a:n=1")
    with faults.inject("mem.oom", n=2, seed=3):
        assert os.environ[faults.ENV_VAR] == \
            "a:n=1;mem.oom:p=1.0:n=2:seed=3:after=0"
    assert os.environ[faults.ENV_VAR] == "a:n=1"


@pytest.mark.parametrize("env", [{}, {"THRILL_TPU_RETRY_ATTEMPTS": "2",
                                      "THRILL_TPU_RETRY_BASE_S": "0.5",
                                      "THRILL_TPU_RETRY_MAX_S": "1"},
                                 {"THRILL_TPU_RETRY_ATTEMPTS": "junk"}])
def test_retry_policy_settings_and_backoff_match_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, ref = retry.default_policy(), jretry.default_policy()
    assert (mine.max_attempts, mine.base_delay_s, mine.max_delay_s) == \
        (ref.max_attempts, ref.base_delay_s, ref.max_delay_s)
    assert [mine.delay(k, random.Random(1)) for k in range(6)] == \
        [ref.delay(k, random.Random(1)) for k in range(6)]
    for exc in (ConnectionError(), TimeoutError(), OSError("x"),
                FileNotFoundError(), PermissionError(), ValueError(),
                RuntimeError()):
        assert mine.classify(exc) == ref.classify(exc)


def test_retry_policy_retries_transient_and_raises_permanent(monkeypatch):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("again")
        return "ok"

    pol = retry.RetryPolicy(max_attempts=4)
    assert pol.run(flaky, what="t", sleep=lambda s: None) == "ok"
    assert len(calls) == 3 and faults.REGISTRY.retries == 2
    with pytest.raises(ValueError):
        pol.run(lambda: (_ for _ in ()).throw(ValueError()), what="t",
                sleep=lambda s: None)
    monkeypatch.setenv("THRILL_TPU_RETRY", "0")
    calls.clear()
    with pytest.raises(ConnectionError):
        pol.run(flaky, what="t", sleep=lambda s: None)
    assert len(calls) == 1
