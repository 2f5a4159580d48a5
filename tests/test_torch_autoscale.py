"""The autoscaler (``thrill_tpu_torch/service/autoscale.py``) against the
reference package's on the CPU.

The deterministic core: both packages' ``Autoscaler``s are fed the same
metric traces (seeded random walks of queue depth, in-flight jobs,
cumulative rejects and p99, and the reference's pinned sequences) under
the same policies, and must return the same decision every tick, the
same ``last_decision`` and stats, and write the same ``autoscale``
records into their Contexts' decision ledgers. The fault site
``svc.autoscale.decide`` changes nothing, then the clean retry goes on.
The live side: ``maybe_start`` from ``THRILL_TPU_AUTOSCALE_S`` drives
fenced resizes of a serving Context in one process, a burst scaling it
up and idle ticks back down, and every job's result equals a fixed-W
Context's run of it at the W the job saw, which it saw whole.

Tolerance: exact.
"""

import threading
import time

import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
from thrill_tpu.service import autoscale as jas

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.service import autoscale as tas

_ENV = ("THRILL_TPU_AUTOSCALE_S", "THRILL_TPU_AUTOSCALE_MIN_W",
        "THRILL_TPU_AUTOSCALE_MAX_W", "THRILL_TPU_AUTOSCALE_UP_QUEUE",
        "THRILL_TPU_AUTOSCALE_UP_REJECTS", "THRILL_TPU_AUTOSCALE_UP_P99_MS",
        "THRILL_TPU_AUTOSCALE_CONFIRM", "THRILL_TPU_AUTOSCALE_IDLE_TICKS",
        "THRILL_TPU_AUTOSCALE_COOLDOWN", "THRILL_TPU_SERVE_PORT")


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


def _m(depth=0, rejected=0, inflight=0, p99=0.0):
    return {"queue_depth": depth, "jobs_rejected": rejected,
            "jobs_in_flight": inflight, "serve_p99_ms": p99}


def _trace(seed, n=80):
    """A seeded metric trace: bursts, idle stretches, reject spikes."""
    rng = np.random.default_rng(seed)
    out, rejected = [], 0
    for _ in range(n):
        mode = rng.integers(0, 4)
        if mode == 0:
            out.append(_m())
            continue
        rejected += int(rng.integers(0, 3)) if mode == 3 else 0
        out.append(_m(depth=int(rng.integers(0, 20)), rejected=rejected,
                      inflight=int(rng.integers(0, 3)),
                      p99=float(rng.choice([0.0, 40.0, 900.0]))))
    return out


POLICIES = [dict(min_w=1, max_w=4, up_queue=8, confirm_ticks=2,
                 idle_ticks=3, cooldown_ticks=2),
            dict(min_w=2, max_w=6, up_queue=4, up_rejects=2,
                 up_p99_ms=500.0, confirm_ticks=1, idle_ticks=2,
                 cooldown_ticks=0),
            dict(min_w=1, max_w=3, up_queue=10, confirm_ticks=3,
                 idle_ticks=5, cooldown_ticks=3)]

PINNED = [  # the reference's own pinned sequences
    (dict(confirm_ticks=3), [_m(99, 0, 3)] * 3, 2),
    (dict(confirm_ticks=2), [_m(99, 0, 3), _m(3, 0, 1)] * 3, 2),
    (dict(confirm_ticks=2, up_rejects=1),
     [_m(rejected=100, inflight=1), _m(rejected=101, inflight=1),
      _m(rejected=103, inflight=1)], 2),
    (dict(idle_ticks=3, cooldown_ticks=0), [_m()] * 6, 2),
    (dict(confirm_ticks=2, cooldown_ticks=2), [_m(99, 0, 3)] * 5, 2),
]


def _policy(mod, **kw):
    base = dict(min_w=1, max_w=4, up_queue=8, confirm_ticks=2,
                idle_ticks=3, cooldown_ticks=2)
    base.update(kw)
    return mod.AutoscalePolicy(**base)


def _drive(mod, ctx, policy_kw, trace, w0):
    """Feed ``trace``, following each decision's W; the ticks' returns,
    the last decision, the stats and the ledger's autoscale records."""
    a = mod.Autoscaler(ctx, policy=_policy(mod, **policy_kw))
    w, ticks = w0, []
    for sample in trace:
        target = a.observe(sample, w)
        ticks.append(target)
        if target is not None:
            w = target
    recs = [(r.kind, r.site, r.chosen, r.predicted, list(map(list, r.rejected)),
             r.reason, dict(r.inputs)) for r in ctx.decisions.records
            if r.kind == "autoscale"]
    return ticks, a.last_decision, a.stats(), recs


def _both(policy_kw, trace, w0):
    jctx = JContext(JMeshExec(num_workers=1))
    tctx = tt.Context(num_workers=1, device="cpu")
    try:
        return (_drive(tas, tctx, policy_kw, trace, w0),
                _drive(jas, jctx, policy_kw, trace, w0))
    finally:
        tctx.close()
        jctx.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decisions_and_ledger_records_equal_the_reference(seed):
    policy_kw = POLICIES[seed % len(POLICIES)]
    got, want = _both(policy_kw, _trace(seed), w0=2)
    assert got == want
    assert got[2]["autoscale_ticks"] == 80
    assert got[2]["autoscale_decisions"] == len(got[3]) >= 1


@pytest.mark.parametrize("case", range(len(PINNED)))
def test_the_reference_s_pinned_sequences(case):
    kw, trace, w0 = PINNED[case]
    got, want = _both(kw, trace, w0)
    assert got == want


def test_policy_knobs_from_the_environment(monkeypatch):
    for k, v in (("MIN_W", "2"), ("MAX_W", "5"), ("UP_QUEUE", "4"),
                 ("UP_REJECTS", "3"), ("UP_P99_MS", "250"),
                 ("CONFIRM", "4"), ("IDLE_TICKS", "7"), ("COOLDOWN", "1")):
        monkeypatch.setenv(f"THRILL_TPU_AUTOSCALE_{k}", v)
    t, j = tas.AutoscalePolicy(), jas.AutoscalePolicy()
    assert vars(t) == vars(j) == dict(
        min_w=2, max_w=5, up_queue=4, up_rejects=3, up_p99_ms=250.0,
        confirm_ticks=4, idle_ticks=7, cooldown_ticks=1)
    monkeypatch.setenv("THRILL_TPU_AUTOSCALE_MAX_W", "x")
    assert tas.AutoscalePolicy().max_w == jas.AutoscalePolicy().max_w == 4


def test_decide_fault_site_mutates_nothing_then_clean_retry():
    a = tas.Autoscaler(policy=_policy(tas, confirm_ticks=1))
    a.observe(_m(rejected=7, inflight=1), 2)
    before = (a._tick, a._hot, a._idle, a._cooldown, a._last_rejected,
              a.decisions_made)
    with faults.inject("svc.autoscale.decide", n=1):
        with pytest.raises(faults.InjectedFault):
            a.tick()
    assert (a._tick, a._hot, a._idle, a._cooldown, a._last_rejected,
            a.decisions_made) == before
    assert a.tick() is None
    assert a._tick == before[0] + 1


def test_decisions_land_in_explain():
    ctx = tt.Context(num_workers=2, device="cpu")
    try:
        a = tas.Autoscaler(ctx, policy=_policy(tas, confirm_ticks=1))
        assert a.observe(_m(99, 0, 3), 2) == 3
        assert ctx.decisions.kind_counts.get("autoscale") == 1
        assert "autoscale" in ctx.explain()
    finally:
        ctx.close()


def _wc_key(x):
    return (x % 13, 1)


def _add(a, b):
    return a + b


def _wc(seed):
    def job(ctx):
        w0 = ctx.num_workers
        vals = np.random.default_rng(seed).integers(0, 1000, 600)
        out = ctx.Distribute(vals).Map(_wc_key).ReducePair(_add)
        got = [(int(k), int(v)) for k, v in out.AllGather()]
        return w0, ctx.num_workers, got
    job.__name__ = f"wc{seed}"
    return job


def test_live_thread_drives_fenced_resizes(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_AUTOSCALE_S", "0.02")
    monkeypatch.setenv("THRILL_TPU_AUTOSCALE_MIN_W", "2")
    monkeypatch.setenv("THRILL_TPU_AUTOSCALE_MAX_W", "4")
    monkeypatch.setenv("THRILL_TPU_AUTOSCALE_UP_QUEUE", "4")
    monkeypatch.setenv("THRILL_TPU_AUTOSCALE_IDLE_TICKS", "3")
    monkeypatch.setenv("THRILL_TPU_AUTOSCALE_COOLDOWN", "1")
    ctx = tt.Context(num_workers=2, device="cpu")
    widths = []
    try:
        assert ctx.autoscaler is not None
        real = ctx._resize_now

        def resize_now(w):
            # the fence runs the swap on the dispatcher thread
            widths.append((ctx.num_workers, w,
                           threading.current_thread().name))
            return real(w)

        ctx._resize_now = resize_now
        gate, started = threading.Event(), threading.Event()

        def hold(c):
            started.set()
            assert gate.wait(60)
            return c.num_workers

        held = ctx.submit(hold, name="hold")
        assert started.wait(60)
        futs = [ctx.submit(_wc(i % 3), tenant=f"t{i % 2}") for i in range(12)]
        # the queue stays deep until the autoscaler asked for W = 3
        deadline = time.monotonic() + 60
        while not ctx.service._fences and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ctx.service._fences, "no fenced resize was requested"
        gate.set()
        assert held.result(60) == 2
        results = [f.result(120) for f in futs]
        deadline = time.monotonic() + 60
        while ctx.num_workers != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        stats = ctx.overall_stats()
    finally:
        ctx.close()
    assert widths[0][:2] == (2, 3)
    assert {w[2] for w in widths} == {"thrill-serve-dispatch"}
    assert max(w[1] for w in widths) >= 3 and widths[-1][1] == 2
    assert stats["autoscale_decisions"] == len(widths) >= 2
    assert stats["resizes"] == len(widths)
    seen = set()
    for i, (w0, w1, got) in enumerate(results):
        assert w0 == w1, "a job saw the mesh resize under it"
        seen.add(w0)
        want = tt.Run(_wc(i % 3), w0, device="cpu")[2]
        assert got == want, (i, w0)
    assert len(seen) >= 2


def test_maybe_start_off_by_default_and_refused_across_processes(
        monkeypatch, capsys):
    ctx = tt.Context(num_workers=2, device="cpu")
    try:
        assert ctx.autoscaler is None and tas.maybe_start(ctx) is None
    finally:
        ctx.close()
    from thrill_tpu_torch.parallel.mesh import MeshExec
    monkeypatch.setenv("THRILL_TPU_AUTOSCALE_S", "0.5")
    ctx = tt.Context(MeshExec(num_workers=4, device="cpu", process_index=0,
                              num_processes=2))
    try:
        assert ctx.autoscaler is None
        assert "THRILL_TPU_AUTOSCALE_S ignored on a multi-process mesh" in \
            capsys.readouterr().err
        assert ctx.overall_stats()["autoscale_ticks"] == 0
    finally:
        ctx.close()
