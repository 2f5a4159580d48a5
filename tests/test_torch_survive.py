"""Failure domains on the port's Context: one Context outlives many
pipeline failures (the cases of the reference's
``tests/api/test_survive.py``, at W = 1, 2 and 4).

* One Context survives three or more fault classes (an injected dispatch
  fault, an exchange chunk fault at W > 1, an exhausted OOM and a user
  error); each surfaces as a :class:`PipelineError` whose origin, cause
  and generation equal the reference's for the same sequence, and the
  next pipeline is bit-identical to a fresh Context's and to the
  reference's;
* nested blocks heal once, an inner abort caught in the outer block
  keeps the outer domain, cached nodes of successful pipelines survive,
  a dead-peer verdict escalates, a deferred check is scoped to its
  pipeline;
* the leak audit: fault-injected pipelines leave the HBM ledger, the
  memory grants, the LRU, the deferred checks, spill files and threads
  at their baseline (one cycle in tier, twenty pipelines in the slow
  tier, as in the reference);
* the host exchange's sender threads and the chaos survive sweep.

Tolerance: exact, but for the f64 sum of 33 floats, which is within
1e-12 relative of the reference's (XLA associates it differently, as in
ROADMAP.md's C15); a healed Context's results are bit-identical to a
fresh port Context's.
"""

import glob
import json
import os
import signal
import threading

import numpy as np
import pytest

from thrill_tpu_torch.api import Context, PipelineError
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.parallel.mesh import MeshExec

LIMIT_S = 420


@pytest.fixture(autouse=True, scope="module")
def _file_time_limit():
    """This file's own time limit: a test still running past it fails."""
    def expired(*_):
        raise TimeoutError(f"{__name__}: past its {LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _mex(num_workers):
    return MeshExec(num_workers=num_workers, device="cpu")


@pytest.fixture(autouse=True)
def _clean_registry(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()


def _result_pipeline(ctx):
    """Deterministic pipeline with a shuffle and order-sensitive float
    math — the bit-identity probe (a healed Context must produce
    EXACTLY what a fresh one does)."""
    pairs = sorted(
        (int(k), int(v)) for k, v in ctx.Distribute(
            np.arange(64, dtype=np.int64)).Map(
                lambda x: (x % 7, x)).ReducePair(
                    lambda a, b: a + b).AllGather())
    s = float(ctx.Distribute(
        np.linspace(0.0, 1.0, 33)).Map(lambda x: x * 1.7).Sum())
    return pairs, s


def _doomed_pipeline(ctx):
    """A pipeline every fault class below can kill (shuffle included
    so the exchange sites are reachable at W=2)."""
    return sorted(int(x) for x in ctx.Distribute(
        np.arange(48, dtype=np.int64)).Map(
            lambda x: (x % 5, x)).ReducePair(
                lambda a, b: a + b).Map(
                    lambda t: t[1]).AllGather())


class _UserLogicError(ValueError):
    pass


#: fault classes: (name, env overrides, armed spec entry or None for a
#: plain user error, substring the root cause must carry, min W).
#: n=0 = unbounded fires; the trimmed retry budget guarantees
#: exhaustion, so the failure always SURFACES (recovery would be the
#: wrong outcome here — test_chaos.py owns bounded-budget recovery)
_FAULT_CLASSES = [
    ("dispatch", {"THRILL_TPU_RETRY_ATTEMPTS": "2"},
     "api.mesh.dispatch:n=0:seed=3", "api.mesh.dispatch", 1),
    ("exchange-chunk", {"THRILL_TPU_RETRY_ATTEMPTS": "2",
                        "THRILL_TPU_XCHG_CHUNKS": "2"},
     "data.exchange.chunk:n=0:seed=5", "data.exchange.chunk", 2),
    ("oom-exhausted", {"THRILL_TPU_OOM_RETRY": "0"},
     "mem.oom:n=0:seed=7", "RESOURCE_EXHAUSTED", 1),
    ("user-error", {}, None, "user logic failed", 1),
]


def _fail_one_pipeline(ctx, fclass, monkeypatch):
    """Run one doomed pipeline under ``fclass``; returns the
    PipelineError it surfaced."""
    name, env, spec, needle, min_w = fclass
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if spec is not None:
        monkeypatch.setenv(faults.ENV_VAR, spec)
    seen = {}
    pre = ctx.generation
    with pytest.raises(PipelineError) as ei:
        with ctx.pipeline(name) as gen:   # entry = fresh generation
            seen["gen"] = gen
            if spec is None:
                raise _UserLogicError("user logic failed")
            _doomed_pipeline(ctx)
    # undo the arming/env before the next (healthy) pipeline
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    for k in env:
        monkeypatch.delenv(k, raising=False)
    e = ei.value
    assert e.generation == seen["gen"], (name, e.generation, seen)
    assert needle in e.cause, (name, e.cause)
    # node stamping resumes in the enclosing domain; the WIRE epoch
    # advanced past the failed generation (its frames read as stale)
    assert ctx.generation == pre
    assert ctx.net.group.generation > seen["gen"]
    return e


@pytest.mark.parametrize("w", [1, 2, 4])
def test_context_survives_distinct_fault_classes(w, monkeypatch):
    """THE pinned acceptance case: >= 3 distinct fault classes abort
    three pipelines on ONE Context; each surfaces as a catchable
    PipelineError with the correct root cause + generation, and the
    next pipeline is bit-identical to a fresh-Context run."""
    classes = [c for c in _FAULT_CLASSES if w >= c[4]]
    assert len(classes) >= 3
    ctx = Context(_mex(w))
    try:
        baseline_gen = ctx.generation
        # a healthy pipeline first: the survive contract is about a
        # LONG-LIVED context, not a fresh one
        with ctx.pipeline("warmup"):
            first = _result_pipeline(ctx)
        for fclass in classes:
            _fail_one_pipeline(ctx, fclass, monkeypatch)
            # the mesh stays usable IMMEDIATELY after each heal
            with ctx.pipeline("probe"):
                assert _result_pipeline(ctx) == first
        stats = ctx.overall_stats()
        assert stats["pipeline_aborts"] == len(classes)
        assert stats["generation"] == ctx.generation
        assert ctx._gen_counter > baseline_gen
        assert stats["heal_time_s"] >= 0.0
        healed = _result_pipeline(ctx)
    finally:
        ctx.close()
    fresh = Context(_mex(w))
    try:
        want = _result_pipeline(fresh)
    finally:
        fresh.close()
    assert healed == want, "healed Context diverged from a fresh one"


def test_pipeline_error_is_catchable_and_carries_root(monkeypatch):
    """PipelineError chains the original exception (__cause__ and
    .root) and is NOT a ClusterAbort/ConnectionError: retry policies
    classify it permanent and RunSupervised does not relaunch for it."""
    from thrill_tpu_torch.common.retry import default_policy
    monkeypatch.setenv("THRILL_TPU_RETRY_ATTEMPTS", "2")
    ctx = Context(_mex(1))
    try:
        monkeypatch.setenv(faults.ENV_VAR, "api.mesh.dispatch:n=0:seed=1")
        with pytest.raises(PipelineError) as ei:
            with ctx.pipeline():
                _doomed_pipeline(ctx)
        monkeypatch.delenv(faults.ENV_VAR)
        e = ei.value
        assert isinstance(e.root, faults.InjectedFault)
        assert e.__cause__ is e.root
        assert not isinstance(e, ConnectionError)
        assert default_policy().classify(e) == faults.PERMANENT
    finally:
        ctx.close()


def test_nested_pipeline_does_not_double_heal(monkeypatch):
    """A PipelineError from a nested ctx.pipeline() passes through the
    outer block unchanged: one abort counted, one heal run, and the
    error names the generation that actually failed."""
    monkeypatch.setenv("THRILL_TPU_RETRY_ATTEMPTS", "2")
    ctx = Context(_mex(1))
    try:
        gens = {}
        monkeypatch.setenv(faults.ENV_VAR, "api.mesh.dispatch:n=0:seed=2")
        with pytest.raises(PipelineError) as ei:
            with ctx.pipeline("outer") as og:
                gens["outer"] = og
                with ctx.pipeline("inner") as ig:
                    gens["inner"] = ig
                    _doomed_pipeline(ctx)
        monkeypatch.delenv(faults.ENV_VAR)
        # the INNER block is the failure domain that aborted; after
        # the single heal, stamping is back at the pre-outer domain
        assert ei.value.generation == gens["inner"] == gens["outer"] + 1
        assert ctx.generation == 1
        assert ctx.net.group.generation > gens["inner"]
        assert ctx.stats_pipeline_aborts == 1   # ONE heal, not two
    finally:
        ctx.close()


def test_inner_abort_caught_in_outer_block_keeps_outer_domain(
        monkeypatch):
    """The documented retry use-case: catching a nested block's
    PipelineError INSIDE the outer block resumes the OUTER failure
    domain — so when the outer block later aborts, its pre-inner nodes
    are healed too and the error names the outer generation."""
    monkeypatch.setenv("THRILL_TPU_RETRY_ATTEMPTS", "2")
    ctx = Context(_mex(1))
    try:
        holders = {}
        with pytest.raises(PipelineError) as ei:
            with ctx.pipeline("outer") as og:
                holders["og"] = og
                holders["a"] = ctx.Distribute(
                    np.arange(6, dtype=np.int64)).Cache().Keep(2)
                assert int(holders["a"].Sum()) == 15
                try:
                    monkeypatch.setenv(faults.ENV_VAR,
                                       "api.mesh.dispatch:n=0:seed=6")
                    with ctx.pipeline("inner"):
                        _doomed_pipeline(ctx)
                except PipelineError:
                    monkeypatch.delenv(faults.ENV_VAR)
                # execution resumed in the OUTER domain
                assert ctx.generation == og
                raise _UserLogicError("outer failed after inner retry")
        assert ei.value.generation == holders["og"]
        # the outer run's PRE-inner node was healed with the outer
        # domain (no leaked ledger entry, no stale partial shards)
        with pytest.raises(RuntimeError, match="consumed/disposed"):
            holders["a"].AllGather()
        assert ctx.stats_pipeline_aborts == 2
    finally:
        ctx.close()


def test_outer_failure_after_clean_nested_block_heals_outer_domain():
    """A nested block's CLEAN exit restores the enclosing failure
    domain: when the outer block later aborts, the heal disposes the
    OUTER run's nodes and the nested survivor's cache stays intact —
    and the PipelineError names the outer generation."""
    ctx = Context(_mex(1))
    try:
        holders = {}
        with pytest.raises(PipelineError) as ei:
            with ctx.pipeline("outer") as og:
                holders["outer_gen"] = og
                with ctx.pipeline("inner"):
                    holders["inner"] = ctx.Distribute(
                        np.arange(8, dtype=np.int64)).Cache().Keep(2)
                    assert int(holders["inner"].Sum()) == 28
                holders["outer"] = ctx.Distribute(
                    np.arange(4, dtype=np.int64)).Cache().Keep(2)
                assert int(holders["outer"].Sum()) == 6
                raise _UserLogicError("outer failed")
        assert ei.value.generation == holders["outer_gen"]
        # the nested block's cached node survived the outer heal
        got = sorted(int(x) for x in holders["inner"].AllGather())
        assert got == list(range(8))
        # the outer run's own node was disposed by the heal
        with pytest.raises(RuntimeError, match="consumed/disposed"):
            holders["outer"].AllGather()
    finally:
        ctx.close()


def test_cached_nodes_of_successful_pipelines_survive_aborts(
        monkeypatch):
    """Entering pipeline() starts a fresh generation, so a DIA cached
    by an earlier SUCCESSFUL run belongs to an older generation and
    survives a later pipeline's abort — the persistent-cache story of
    a long-lived Context."""
    monkeypatch.setenv("THRILL_TPU_RETRY_ATTEMPTS", "2")
    ctx = Context(_mex(2))
    try:
        with ctx.pipeline("build-cache"):
            base = ctx.Distribute(
                np.arange(32, dtype=np.int64)).Cache().Keep(2)
            assert int(base.Sum()) == int(np.arange(32).sum())
        monkeypatch.setenv(faults.ENV_VAR, "api.mesh.dispatch:n=0:seed=4")
        with pytest.raises(PipelineError):
            with ctx.pipeline("doomed"):
                _doomed_pipeline(ctx)
        monkeypatch.delenv(faults.ENV_VAR)
        # the cached DIA from the successful run is still consumable
        with ctx.pipeline("reuse"):
            got = sorted(int(x) for x in base.AllGather())
        assert got == list(range(32))
    finally:
        ctx.close()


def test_unrecoverable_dead_peer_verdict_escalates():
    """A heartbeat dead-peer verdict (ClusterAbort recoverable=False)
    must NOT heal: _pipeline_failed returns the ORIGINAL abort and the
    Context shuts down aborted — the supervised relaunch + resume path
    (RunSupervised / supervise.sh) owns that recovery."""
    from thrill_tpu_torch.net.group import ClusterAbort
    ctx = Context(_mex(1))
    dead = ClusterAbort(0, "heartbeat: rank 1 is unreachable — worker "
                           "presumed dead", generation=1,
                        recoverable=False)
    with pytest.raises(ClusterAbort) as ei:
        with ctx.pipeline():
            raise dead
    assert ei.value is dead
    assert ctx._aborted
    # RunSupervised's relaunch filter still catches the escalation
    assert isinstance(dead, (ConnectionError, TimeoutError))
    ctx.close()


def test_deferred_check_failure_is_scoped_to_its_pipeline():
    """A deferred device check crossing the pipeline boundary drains
    INSIDE the failure domain (pipeline() drains on success), and the
    heal cancels the aborted generation's remaining checks so none
    fires into the next pipeline."""
    ctx = Context(_mex(1))
    mex = ctx.mesh_exec
    try:
        fired = []

        def boom():
            fired.append(True)
            raise RuntimeError("deferred check failed")

        mex._pending_checks.append(boom)
        with pytest.raises(PipelineError) as ei:
            with ctx.pipeline("deferred"):
                pass        # the success-path drain runs the check
        assert fired and "deferred check failed" in ei.value.cause
        # the heal cancelled the aborted run's queue: the next
        # pipeline starts with no leftover checks and runs clean
        assert not mex._pending_checks
        with ctx.pipeline("next"):
            _ = _doomed_pipeline(ctx)
    finally:
        ctx.close()


# ----------------------------------------------------------------------
# leak audit
# ----------------------------------------------------------------------

def _leak_audit(n_pipelines, monkeypatch):
    threads_before = {t.name for t in threading.enumerate()}
    ctx = Context(_mex(2))
    classes = [c for c in _FAULT_CLASSES]
    try:
        hbm_baseline = ctx.hbm.mem.total
        reserved_baseline = ctx._mem_reserved
        for i in range(n_pipelines):
            _fail_one_pipeline(ctx, classes[i % len(classes)],
                               monkeypatch)
        # ledgers return to baseline: no reservation, pin, or cached
        # shard of any aborted generation survives its heal
        assert ctx.hbm.mem.total == hbm_baseline
        assert ctx._mem_reserved == reserved_baseline
        assert not ctx.hbm._lru, "aborted nodes left LRU entries"
        assert not ctx.mesh_exec._pending_checks
        assert ctx.overall_stats()["pipeline_aborts"] == n_pipelines
        # no stale spill files for THIS process (dead-pid files are
        # purge_stale_spills' job; live-pid files here would be a leak)
        leaked = glob.glob(os.path.join(
            ctx.config.spill_dir, f"ttpu-blk-{os.getpid()}-*.spill"))
        assert not leaked, leaked
        # one more healthy pipeline proves the mesh still works
        with ctx.pipeline("final"):
            got = _doomed_pipeline(ctx)
        want = sorted(
            v for k in range(5)
            for v in [sum(x for x in range(48) if x % 5 == k)])
        assert got == want
    finally:
        ctx.close()
    # no stranded framework threads (async mux senders, heal helpers)
    lingering = {t.name for t in threading.enumerate()} - threads_before
    lingering = {n for n in lingering if n.startswith("thrill-tpu")}
    assert not lingering, lingering


def test_leak_audit_fault_injected_pipelines(monkeypatch):
    """Tier-1 representative: one full cycle of the fault classes on
    one Context leaves every ledger at baseline (the full ~20-pipeline
    audit rides the slow tier)."""
    _leak_audit(len(_FAULT_CLASSES), monkeypatch)


@pytest.mark.slow
def test_leak_audit_twenty_pipelines(monkeypatch):
    """The full ~20-pipeline audit of the issue spec (slow tier)."""
    _leak_audit(20, monkeypatch)


def test_async_sender_thread_not_stranded_on_recv_failure(monkeypatch):
    """Regression for the sender-thread leak: a RECEIVE-side failure
    mid host_exchange used to leave the background sender blocked on
    its queue forever. The finally path now always posts the stop
    sentinel."""
    from thrill_tpu_torch.data.multiplexer import host_exchange
    from thrill_tpu_torch.data.shards import HostShards
    from thrill_tpu_torch.net import FlowControlChannel
    from thrill_tpu_torch.net.mock import MockNetwork

    W, P = 4, 2

    class _Stub:
        def __init__(self, pidx, group):
            self.num_workers = W
            self.num_processes = P
            self.process_index = pidx
            self.worker_process = np.repeat(np.arange(P), W // P)
            self.host_net = FlowControlChannel(group)
            self.stats_exchanges = 0
            self.stats_items_moved = 0
            self.logger = None

        @property
        def local_workers(self):
            return [w for w in range(W)
                    if self.worker_process[w] == self.process_index]

    groups = MockNetwork.construct(P)
    threads_before = {t for t in threading.enumerate()}
    errors = [None] * P

    def job(p):
        try:
            mex = _Stub(p, groups[p])
            local = set(mex.local_workers)
            shards = HostShards(W, [[(w, i) for i in range(3)]
                                    if w in local else []
                                    for w in range(W)])
            host_exchange(mex, shards, lambda it: it[1] % W)
        except BaseException as e:
            errors[p] = e

    monkeypatch.setenv("THRILL_TPU_RETRY_ATTEMPTS", "2")
    # unbounded RECEIVE faults: the exchange must fail on the main
    # thread while the sender thread still exits cleanly
    with faults.inject("net.multiplexer.frame_recv", n=0, seed=11):
        threads = [threading.Thread(target=job, args=(p,), daemon=True)
                   for p in range(P)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert all(not t.is_alive() for t in threads)
    assert any(e is not None for e in errors), \
        "the injected receive fault never surfaced"
    # give daemon senders a moment to see the sentinel, then audit
    import time
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        senders = [t for t in threading.enumerate()
                   if t.name == "thrill-tpu-mux-send"
                   and t not in threads_before and t.is_alive()]
        if not senders:
            break
        time.sleep(0.05)
    assert not senders, "async sender threads stranded after abort"


def test_dead_async_sender_poisons_instead_of_mutual_hang(monkeypatch):
    """Both ranks' async senders die mid-exchange with the watchdog
    OFF: the dying sender poisons the scope, so every main thread —
    blocked in a recv its peer will never satisfy — converts to a fast
    attributable ClusterAbort instead of a mutual hang."""
    import time

    from thrill_tpu_torch.data.multiplexer import host_exchange
    from thrill_tpu_torch.data.shards import HostShards
    from thrill_tpu_torch.net import FlowControlChannel
    from thrill_tpu_torch.net.group import ClusterAbort
    from thrill_tpu_torch.net.mock import MockNetwork

    W, P = 4, 2

    class _Stub:
        def __init__(self, pidx, group):
            self.num_workers = W
            self.num_processes = P
            self.process_index = pidx
            self.worker_process = np.repeat(np.arange(P), W // P)
            self.host_net = FlowControlChannel(group)
            self.stats_exchanges = 0
            self.stats_items_moved = 0
            self.logger = None

        @property
        def local_workers(self):
            return [w for w in range(W)
                    if self.worker_process[w] == self.process_index]

    monkeypatch.setenv("THRILL_TPU_RETRY_ATTEMPTS", "2")
    monkeypatch.delenv("THRILL_TPU_HANG_TIMEOUT_S", raising=False)
    groups = MockNetwork.construct(P)
    errors = [None] * P

    def job(p):
        try:
            mex = _Stub(p, groups[p])
            local = set(mex.local_workers)
            shards = HostShards(W, [[(w, i) for i in range(3)]
                                    if w in local else []
                                    for w in range(W)])
            host_exchange(mex, shards, lambda it: it[1] % W)
        except BaseException as e:
            errors[p] = e

    with faults.inject("net.multiplexer.async_send", n=0, seed=5):
        threads = [threading.Thread(target=job, args=(p,), daemon=True)
                   for p in range(P)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert all(not t.is_alive() for t in threads), \
        "host_exchange hung on a dead sender (mutual recv deadlock)"
    assert all(e is not None for e in errors)
    assert any(isinstance(e, (ClusterAbort, faults.InjectedFault))
               for e in errors), errors
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate()
                if t.name == "thrill-tpu-mux-send" and t.is_alive()]:
            break
        time.sleep(0.05)


# ----------------------------------------------------------------------
# chaos survive sweep (run-scripts/chaos_sweep.sh CHAOS_SURVIVE=1)
# ----------------------------------------------------------------------

N_SURVIVE_SEEDS = int(os.environ.get("THRILL_TPU_SURVIVE_SEEDS", "3"))


def _survive_params():
    """(fault-class, seed) grid: seed 0 of every class rides tier-1
    (one representative per fault class — the tier-budget guard); the
    seed tail runs only in the unfiltered / chaos sweeps."""
    out = []
    for name, _, _, _, _ in _FAULT_CLASSES:
        for s in range(N_SURVIVE_SEEDS):
            p = (name, s)
            out.append(p if s == 0
                       else pytest.param(*p, marks=pytest.mark.slow))
    return out


@pytest.mark.chaos
@pytest.mark.parametrize("fclass,seed", _survive_params())
def test_chaos_survive_sweep(fclass, seed, monkeypatch):
    """One Context outlives repeated seeded failures of one fault
    class, healing between them, and ends bit-exact."""
    spec = {c[0]: c for c in _FAULT_CLASSES}[fclass]
    name, env, arm, needle, min_w = spec
    w = 2 if min_w > 1 else (int(np.random.default_rng(
        41_000 + seed).integers(1, 3)) if seed else 1)
    ctx = Context(_mex(w))
    # tier-budget guard: the in-tier representative (seed 0) runs ONE
    # failure round at the cheap worker count — the >=3-failure
    # contract is pinned by
    # test_context_survives_distinct_fault_classes; the full-depth
    # rounds ride the slow/chaos sweeps
    rounds = 3 if seed else 1
    try:
        with ctx.pipeline():
            first = _result_pipeline(ctx)
        for k in range(rounds):
            # vary the injection seed so the fire pattern differs per
            # round while staying reproducible
            salted = (name, env,
                      (arm.split(":seed=")[0]
                       + f":seed={seed * 101 + k}") if arm else None,
                      needle, min_w)
            _fail_one_pipeline(ctx, salted, monkeypatch)
        with ctx.pipeline():
            assert _result_pipeline(ctx) == first
        assert ctx.overall_stats()["pipeline_aborts"] == rounds
    finally:
        ctx.close()


# ----------------------------------------------------------------------
# against the reference package
# ----------------------------------------------------------------------

def _survive_sequence(ctx, PE, fmod, w, monkeypatch):
    """The fault classes of width ``w`` on one Context: each error's
    (origin, cause, generation), then the healed result."""
    errors = []
    with ctx.pipeline("warmup"):
        first = _result_pipeline(ctx)
    for name, env, spec, needle, min_w in _FAULT_CLASSES:
        if w < min_w:
            continue
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if spec is not None:
            monkeypatch.setenv(fmod.ENV_VAR, spec)
        with pytest.raises(PE) as ei:
            with ctx.pipeline(name):
                if spec is None:
                    raise _UserLogicError("user logic failed")
                _doomed_pipeline(ctx)
        monkeypatch.delenv(fmod.ENV_VAR, raising=False)
        for k in env:
            monkeypatch.delenv(k, raising=False)
        e = ei.value
        errors.append((e.origin, e.cause, e.generation))
    return first, errors, _result_pipeline(ctx), ctx.generation


@pytest.mark.parametrize("w", [1, 2, 4])
def test_pipeline_errors_and_healed_results_are_the_reference_s(
        w, monkeypatch):
    import jax

    from thrill_tpu.api import Context as JContext
    from thrill_tpu.api import PipelineError as JPipelineError
    from thrill_tpu.common import faults as jfaults
    from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
    ctx = Context(_mex(w))
    try:
        port = _survive_sequence(ctx, PipelineError, faults, w,
                                 monkeypatch)
    finally:
        ctx.close()
    jfaults.REGISTRY.reset()
    rctx = JContext(JMeshExec(devices=jax.devices("cpu")[:w]))
    try:
        ref = _survive_sequence(rctx, JPipelineError, jfaults, w,
                                monkeypatch)
    finally:
        rctx.close()
        jfaults.REGISTRY.reset()
    fresh = Context(_mex(w))
    try:
        want = _result_pipeline(fresh)
    finally:
        fresh.close()
    assert port[1] == ref[1]              # origin, cause, generation
    assert port[0] == port[2] == want     # bit-identical to a fresh one
    # the reference's: the pairs exactly; the f64 sum of 33 floats within
    # 1e-12 relative (XLA associates the sum differently, as in C15)
    assert port[2][0] == ref[2][0]
    assert abs(port[2][1] - ref[2][1]) <= 1e-12 * abs(ref[2][1])
    assert port[3] == ref[3]


# ----------------------------------------------------------------------
# two real processes (gloo between them for the device data plane)
# ----------------------------------------------------------------------

def _two_process_job(mode):
    def job(ctx):
        import time
        rank = ctx.host_rank
        out = {"rank": rank}
        vals = np.arange(400, dtype=np.int64)[::-1].copy()
        with ctx.pipeline("warm"):
            out["first"] = [int(x) for x in ctx.Distribute(vals).Sort()
                            .AllGather()]
        t0 = time.monotonic()
        try:
            with ctx.pipeline("doomed"):
                if mode == "same" or rank == 1:
                    raise _UserLogicError(f"user logic failed on {rank}")
                # the peer never enters this Sort's exchange
                ctx.Distribute(vals).Sort().AllGather()
            out["way"] = "no error"
        except PipelineError as e:
            out["way"] = "healed"
            out["error"] = [e.origin, e.cause, e.generation]
        except Exception as e:
            out["way"] = "escalated"
            out["error"] = repr(e)[:300]
            out["seconds"] = time.monotonic() - t0
            return out
        out["seconds"] = time.monotonic() - t0
        with ctx.pipeline("after"):
            out["after"] = [int(x) for x in ctx.Distribute(vals).Sort()
                            .AllGather()]
        return out
    return job


def _launch_two(mode, tmp):
    import socket
    import subprocess
    import sys

    socks, ports = [], []
    for _ in range(3):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ,
                   THRILL_TPU_HOSTLIST=" ".join(f"127.0.0.1:{p}"
                                                for p in ports[1:]),
                   THRILL_TPU_RANK=str(rank),
                   THRILL_TPU_SECRET="test-cluster-secret",
                   THRILL_TPU_HEAL_TIMEOUT_S="5",
                   THRILL_TPU_HANG_TIMEOUT_S="10",
                   PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             f"127.0.0.1:{ports[0]}", str(rank), mode, str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = []
    for rank, (p, (_o, err)) in enumerate(zip(procs, outs)):
        path = os.path.join(str(tmp), f"survive-{rank}.json")
        assert os.path.exists(path), err[-3000:]
        with open(path) as f:
            res.append(json.load(f))
    return res


def test_a_failure_every_process_meets_heals_on_every_process(tmp_path):
    res = _launch_two("same", tmp_path)
    for r in res:
        assert r["way"] == "healed", r
        assert r["after"] == r["first"] == list(range(400))
    assert res[0]["error"][2] == res[1]["error"][2]


def test_a_failure_of_one_process_ends_in_bounded_time(tmp_path):
    """Process 1 fails alone while process 0 waits in the Sort's gloo
    exchange: process 1's heal times out (THRILL_TPU_HEAL_TIMEOUT_S=5)
    and escalates, closing its side of the device plane; process 0's
    collective then fails at once and it escalates too. Neither waits
    out gloo's timeout."""
    res = _launch_two("local", tmp_path)
    for r in res:
        assert r["way"] == "escalated", r
        assert r["seconds"] < 60, r


if __name__ == "__main__":
    import json as _json
    import sys as _sys

    import thrill_tpu_torch as tt
    coord, rank, mode, tmp = _sys.argv[1:5]
    try:
        res = tt.RunDistributed(_two_process_job(mode),
                                coordinator_address=coord, num_processes=2,
                                process_id=int(rank), workers_per_process=2,
                                device="cpu")
    except Exception as e:
        res = {"rank": int(rank), "way": "escalated", "outer": repr(e)}
    with open(os.path.join(tmp, f"survive-{rank}.json"), "w") as f:
        _json.dump(res, f)
