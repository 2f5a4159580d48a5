"""Generation-scoped failure domains at the transport layer: the 13
cases of the reference's ``tests/net/test_generation.py``, over the
port's mock and TCP groups (``thrill_tpu_torch/net``) and, as the same
cases, over the reference package's.

Stale prior-generation frames are dropped instead of poisoning a healed
group, ``begin_generation()`` drains every channel up to the
fresh-generation barrier, a dropped TCP link heals by reconnecting with
backoff and the session handshake, and a heartbeat-confirmed dead peer
stays unrecoverable. Tolerance: exact (frame counts, generations,
collective values). Every rank runs on a daemon thread joined with a
timeout.
"""

import importlib
import signal
import socket
import threading
import time
import types

import pytest

LIMIT_S = 240


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


def _pkg(name):
    """The net layer of one package as a namespace."""
    g = importlib.import_module(f"{name}.net.group")
    return types.SimpleNamespace(
        faults=importlib.import_module(f"{name}.common.faults"),
        GENERATION_KEY=g.GENERATION_KEY, POISON_KEY=g.POISON_KEY,
        ClusterAbort=g.ClusterAbort,
        CollectiveHangTimeout=g.CollectiveHangTimeout,
        MockNetwork=importlib.import_module(f"{name}.net.mock").MockNetwork,
        tcp=importlib.import_module(f"{name}.net.tcp"),
        heartbeat=importlib.import_module(f"{name}.net.heartbeat"))


@pytest.fixture(params=["thrill_tpu_torch", "thrill_tpu"],
                ids=["port", "ref"])
def P(request, monkeypatch):
    p = _pkg(request.param)
    monkeypatch.delenv(p.faults.ENV_VAR, raising=False)
    p.faults.REGISTRY.reset()
    yield p
    p.faults.REGISTRY.reset()


def free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _run_ranks(groups, job, timeout=30):
    res = [None] * len(groups)
    errs = [None] * len(groups)

    def target(r):
        try:
            res[r] = job(groups[r], r)
        except BaseException as e:
            errs[r] = e

    ts = [threading.Thread(target=target, args=(r,), daemon=True)
          for r in range(len(groups))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert all(not t.is_alive() for t in ts), "rank hung"
    for e in errs:
        if e is not None:
            raise e
    return res


# ----------------------------------------------------------------------
# generation tagging + stale-frame filtering (mock transport)
# ----------------------------------------------------------------------

def test_stale_poison_frame_is_dropped(P):
    """A poison frame tagged with an already-healed generation must be
    discarded: the payload behind it is delivered and the group does
    not abort."""
    gs = P.MockNetwork.construct(2)
    for g in gs:
        g.generation = 2
    # replay a gen-1 poison ahead of a real payload on rank0's channel
    gs[1].connection(0)._out.put(
        {P.POISON_KEY: {"origin": 1, "cause": "old pipeline", "gen": 1}})
    gs[1].connection(0)._out.put("payload")
    assert gs[0].recv_from(1) == "payload"
    assert gs[0].stats_stale_dropped == 1


def test_current_generation_poison_still_aborts(P):
    gs = P.MockNetwork.construct(2)
    for g in gs:
        g.generation = 2
    gs[1].poison_peers("fresh failure")
    with pytest.raises(P.ClusterAbort) as ei:
        gs[0].recv_from(1)
    assert ei.value.generation == 2
    assert ei.value.recoverable
    assert "fresh failure" in ei.value.cause


def test_untagged_poison_treated_as_current(P):
    """Back-compat: a poison frame without a gen tag aborts (never
    silently dropped)."""
    gs = P.MockNetwork.construct(2)
    for g in gs:
        g.generation = 3
    gs[1].connection(0)._out.put(
        {P.POISON_KEY: {"origin": 1, "cause": "untagged"}})
    with pytest.raises(P.ClusterAbort):
        gs[0].recv_from(1)


def test_begin_generation_drains_stale_frames_and_heals(P):
    """After an abort mid-collective, begin_generation discards
    everything queued before the peers' barrier markers — junk bulk
    frames, late poison — and the next collective runs clean."""
    gs = P.MockNetwork.construct(3)
    # rank 0 aborts a collective: poison everywhere, plus a stray bulk
    # frame rank 2 never consumed
    gs[0].poison_peers("boom")
    gs[0].connection(2)._out.put({"bulk": list(range(8))})
    with pytest.raises(P.ClusterAbort):
        gs[1].recv_from(0)

    def heal(g, r):
        return g.begin_generation(1)

    dropped = _run_ranks(gs, heal)
    assert sum(dropped) >= 2       # the poison relays + the bulk frame
    assert all(g.generation == 1 for g in gs)

    def collective(g, r):
        return g.all_reduce(r + 1)

    assert _run_ranks(gs, collective) == [6, 6, 6]


def test_begin_generation_clears_recoverable_latch_only(P):
    g = P.MockNetwork.construct(1)[0]
    g._pending_abort = P.ClusterAbort(0, "hang at all_reduce",
                                    generation=0, recoverable=True)
    g.begin_generation(1)            # clears the pipeline-scoped latch
    assert g._pending_abort is None
    g._pending_abort = P.ClusterAbort(0, "worker presumed dead",
                                    generation=1, recoverable=False)
    with pytest.raises(P.ClusterAbort, match="presumed dead"):
        g.begin_generation(2)


def test_begin_generation_times_out_on_silent_peer(P, monkeypatch):
    """A peer that never enters the heal fails the barrier within
    THRILL_TPU_HEAL_TIMEOUT_S instead of hanging it."""
    monkeypatch.setenv("THRILL_TPU_HEAL_TIMEOUT_S", "0.5")
    gs = P.MockNetwork.construct(2)
    t0 = time.monotonic()
    with pytest.raises(P.CollectiveHangTimeout):
        gs[0].begin_generation(1)    # rank 1 never heals
    assert time.monotonic() - t0 < 5.0


def test_missed_abort_rank_heals_on_future_generation_marker(P):
    """A rank whose poison frame was LOST (watchdog off) sits blocked
    in a payload recv; the peer's newer-generation barrier marker must
    abort that collective (not be silently swallowed), and the missed
    rank's own barrier then completes off the stashed marker — both
    ranks settle on the same generation."""
    gs = P.MockNetwork.construct(2)
    out = {}

    def rank1():
        try:
            gs[1].recv_from(0)       # blocked: the payload never comes
        except P.ClusterAbort as e:
            out["abort"] = e
            out[1] = gs[1].begin_generation(gs[1].generation + 1)

    t1 = threading.Thread(target=rank1, daemon=True)
    t1.start()
    time.sleep(0.1)                  # rank 1 is inside the recv
    out[0] = gs[0].begin_generation(1)   # rank 0 already healed
    t1.join(timeout=15)
    assert not t1.is_alive(), "missed-abort rank wedged"
    e = out["abort"]
    assert "healed to generation 1" in e.cause and e.recoverable
    assert gs[0].generation == gs[1].generation == 1
    # both channels are quiet: a follow-up collective runs clean
    res = [None, None]

    def job(r):
        res[r] = gs[r].all_reduce(r + 1)

    ts = [threading.Thread(target=job, args=(r,), daemon=True)
          for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert res == [3, 3]


def test_mock_link_drop_heals_through_generation_barrier(P):
    gs = P.MockNetwork.construct(2)
    gs[0].drop_link(1)
    with pytest.raises(ConnectionError):
        gs[0].send_to(1, "x")

    def heal(g, r):
        return g.begin_generation(1)

    _run_ranks(gs, heal)
    assert gs[0].stats_reconnects == 1

    def collective(g, r):
        return g.all_reduce(r + 1)

    assert _run_ranks(gs, collective) == [3, 3]


# ----------------------------------------------------------------------
# TCP reconnect-with-backoff + session handshake
# ----------------------------------------------------------------------

def _boot_tcp_pair(P, timeout=20):
    ports = free_ports(2)
    hosts = [("127.0.0.1", p) for p in ports]
    gs = [None, None]
    errs = [None, None]

    def boot(r):
        try:
            gs[r] = P.tcp.construct_tcp_group(r, hosts, timeout=timeout)
        except BaseException as e:
            errs[r] = e

    ts = [threading.Thread(target=boot, args=(r,), daemon=True)
          for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout + 20)
    for e in errs:
        if e is not None:
            raise e
    return gs


def test_tcp_dropped_link_heals_via_reconnect(P):
    """ACCEPTANCE: a dropped TCP link aborts traffic immediately but
    heals through the generation barrier — reconnect with backoff,
    mutual handshake carrying (rank, generation, seq 0) — and
    collectives resume bit-exact; both sides count the repair."""
    gs = _boot_tcp_pair(P)
    try:
        def collective(g, r):
            return g.all_reduce(r + 1)

        assert _run_ranks(gs, collective) == [3, 3]
        # the link dies mid-exchange (rank 1's side drops the socket)
        gs[1].connection(0)._drop_link()
        with pytest.raises(ConnectionError):
            gs[1].send_to(0, "x")

        def heal(g, r):
            return g.begin_generation(1)

        _run_ranks(gs, heal, timeout=45)
        assert [g.stats_reconnects for g in gs] == [1, 1]
        assert [g.generation for g in gs] == [1, 1]
        assert _run_ranks(gs, collective) == [3, 3]
        # the fresh stream authenticated + MAC-resumed from seq 0: a
        # larger payload round-trips exactly
        def payload(g, r):
            if r == 0:
                g.send_to(1, {"data": list(range(500))})
                return None
            return g.recv_from(0)

        out = _run_ranks(gs, payload)
        assert out[1] == {"data": list(range(500))}
    finally:
        for g in gs:
            g.close()


def test_tcp_reconnect_disabled_fails_heal(P, monkeypatch):
    """THRILL_TPU_RECONNECT=0: the dropped link stays fatal — the heal
    raises instead of reconnecting (pre-reconnect behavior)."""
    gs = _boot_tcp_pair(P)
    try:
        monkeypatch.setenv("THRILL_TPU_RECONNECT", "0")
        gs[1].connection(0)._drop_link()
        with pytest.raises((ConnectionError, OSError)):
            gs[1].begin_generation(1)
    finally:
        monkeypatch.delenv("THRILL_TPU_RECONNECT", raising=False)
        for g in gs:
            g.close()


def test_tcp_reconnect_to_dead_peer_fails_within_budget(P, monkeypatch):
    """A peer PROCESS that is gone (nothing listening) exhausts the
    dial budget and fails the heal — a dead process is not a dropped
    link, and the verdict must arrive in bounded time."""
    monkeypatch.setenv("THRILL_TPU_RECONNECT_TRIES", "3")
    monkeypatch.setenv("THRILL_TPU_HEAL_TIMEOUT_S", "5")
    gs = _boot_tcp_pair(P)
    try:
        # rank 0 dies completely: close every socket it owns
        gs[0].close()
        gs[1].connection(0)._drop_link()
        t0 = time.monotonic()
        with pytest.raises((ConnectionError, OSError, TimeoutError)):
            gs[1].begin_generation(1)
        assert time.monotonic() - t0 < 30.0
    finally:
        for g in gs:
            g.close()


def test_heartbeat_skips_repairable_broken_link(P):
    """A dropped-but-reconnectable link must NOT draw the prober's
    dead-process verdict: the monitor skips links the heal can repair
    (Group.link_repairable), so the pipeline-scoped recovery owns
    them."""
    gs = P.MockNetwork.construct(2)
    gs[0].drop_link(1)               # down but repairable (mock)
    assert gs[0].link_repairable(1)
    mon = P.heartbeat.HeartbeatMonitor(gs[0], 0.05).start()
    time.sleep(0.4)                  # several probe rounds
    mon.stop()
    assert gs[0]._pending_abort is None, \
        "prober misruled a repairable link drop as a dead process"


def test_heartbeat_dead_peer_verdict_is_unrecoverable(P):
    """A heartbeat-confirmed dead peer latches an UNRECOVERABLE abort:
    begin_generation refuses to heal it (the supervised relaunch +
    resume path owns that recovery)."""
    a, b = socket.socketpair()
    g0 = P.tcp.TcpGroup(0, 2, {1: P.tcp.TcpConnection(a)})
    try:
        mon = P.heartbeat.HeartbeatMonitor(g0, 0.05).start()
        time.sleep(0.15)
        b.close()                    # the peer dies, no goodbye
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and g0._pending_abort is None:
            time.sleep(0.05)
        mon.stop()
        ab = g0._pending_abort
        assert ab is not None and not ab.recoverable
        with pytest.raises(P.ClusterAbort, match="presumed dead"):
            g0.begin_generation(1)
    finally:
        a.close()
