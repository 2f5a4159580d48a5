"""The port's liveness heartbeats (``thrill_tpu_torch/net/heartbeat.py``)
and the fault sites around them: the heartbeat cases of the reference's
``tests/net/test_fault_injection.py`` and ``tests/net/test_generation.py``,
and a peer process killed with SIGKILL.

A monitor probes every peer over the group's own connections; the
frames never reach a consumer (the transports filter them). A transient
``net.heartbeat`` fire is absorbed by the retry policy; a peer whose
socket the kernel reports dead becomes an unrecoverable
``ClusterAbort`` on the group, naming its rank, raised at the next group
operation; a link the heal could repair is left to it. Without
``THRILL_TPU_HEARTBEAT_S`` no monitor starts and the frame stream is
byte-equal to the one without heartbeats (the reference's). Tolerance:
exact; every wait is bounded.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from thrill_tpu_torch.common import faults
from thrill_tpu_torch.net import heartbeat
from thrill_tpu_torch.net.group import HEARTBEAT_KEY, ClusterAbort
from thrill_tpu_torch.net.heartbeat import HeartbeatMonitor
from thrill_tpu_torch.net.mock import MockNetwork
from thrill_tpu_torch.net.tcp import (TcpConnection, TcpGroup,
                                      construct_tcp_group)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    monkeypatch.delenv("THRILL_TPU_HEARTBEAT_S", raising=False)
    faults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()


def _socketpair_group_pair():
    a, b = socket.socketpair()
    return (TcpGroup(0, 2, {1: TcpConnection(a)}),
            TcpGroup(1, 2, {0: TcpConnection(b)}), a, b)


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def test_the_site_is_declared_and_the_interval_read(monkeypatch):
    assert "net.heartbeat" in faults.REGISTRY.sites
    assert heartbeat.heartbeat_interval_s() is None
    for v, want in (("0.5", 0.5), ("0", None), ("-1", None), ("x", None)):
        monkeypatch.setenv("THRILL_TPU_HEARTBEAT_S", v)
        assert heartbeat.heartbeat_interval_s() == want


def test_injected_heartbeat_transient_recovers():
    """net.heartbeat: a transient probe fault is absorbed by the shared
    retry policy; no peer is declared dead."""
    g0, g1, a, b = _socketpair_group_pair()
    try:
        with faults.inject("net.heartbeat", n=1, seed=29):
            mon = HeartbeatMonitor(g0, 0.05).start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and \
                    faults.REGISTRY.injected < 1:
                time.sleep(0.02)
            time.sleep(0.2)          # the retry lands
            mon.stop()
        assert faults.REGISTRY.injected >= 1
        assert faults.REGISTRY.stats()["retries"] >= 1
        assert g0._pending_abort is None, \
            "a transient heartbeat fault declared the peer dead"
    finally:
        a.close()
        b.close()


def test_heartbeat_detects_dead_peer_and_poisons():
    """A peer dying between collectives: the monitor's send fails at
    the kernel, the peer is declared dead, the group latches a
    ClusterAbort naming the rank, unrecoverable, and the main thread
    meets it at its next group operation."""
    g0, g1, a, b = _socketpair_group_pair()
    try:
        mon = HeartbeatMonitor(g0, 0.05).start()
        time.sleep(0.15)
        b.close()                    # rank 1 dies, no goodbye
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and g0._pending_abort is None:
            time.sleep(0.05)
        mon.stop()
        ab = g0._pending_abort
        assert ab is not None, "the monitor never noticed the dead peer"
        assert "rank 1" in ab.cause and "presumed dead" in ab.cause
        assert not ab.recoverable
        with pytest.raises(ClusterAbort):
            g0.send_to(1, "next-collective-frame")
    finally:
        a.close()


def test_heartbeat_skips_repairable_broken_link():
    """A dropped but reconnectable link draws no dead-process verdict:
    the monitor leaves links the heal can repair to it."""
    gs = MockNetwork.construct(2)
    gs[0].drop_link(1)
    assert gs[0].link_repairable(1)
    mon = HeartbeatMonitor(gs[0], 0.05).start()
    time.sleep(0.4)                  # several probe rounds
    mon.stop()
    assert gs[0]._pending_abort is None


def test_heartbeat_frames_never_reach_a_consumer():
    """The peer's data frames arrive in order between heartbeats, and
    the transport stamps the last heartbeat it filtered."""
    g0, g1, a, b = _socketpair_group_pair()
    try:
        mon = HeartbeatMonitor(g0, 0.02).start()
        got = []
        for i in range(5):
            time.sleep(0.05)
            g0.send_to(1, {"data": i})
            got.append(g1.recv_from(0))
        mon.stop()
        assert got == [{"data": i} for i in range(5)]
        assert g1.connection(0).last_heartbeat > 0
    finally:
        a.close()
        b.close()


def test_the_group_starts_and_stops_the_monitor(monkeypatch):
    """``construct_tcp_group`` starts a monitor under
    THRILL_TPU_HEARTBEAT_S and ``close()`` stops it; without it no
    monitor starts and the peer reads exactly the frames sent (no
    heartbeat bytes on the wire)."""
    for interval in (None, "0.05"):
        if interval:
            monkeypatch.setenv("THRILL_TPU_HEARTBEAT_S", interval)
        hosts = [("127.0.0.1", p) for p in _free_ports(2)]
        out = [None, None]

        def rank(r):
            g = construct_tcp_group(r, hosts, timeout=20)
            try:
                started = g._heartbeat is not None
                if r == 0:
                    g.send_to(1, "x")
                    time.sleep(0.5)      # the monitor probes meanwhile
                    out[r] = (started, None)
                else:
                    got = g.recv_from(0)
                    # the raw bytes pending after the frame: heartbeats
                    # (filtered by recv, but on the wire) or none
                    time.sleep(0.3)
                    sock = g.connection(0).sock
                    sock.setblocking(False)
                    try:
                        extra = len(sock.recv(1 << 16))
                    except BlockingIOError:
                        extra = 0
                    sock.setblocking(True)
                    out[r] = (started, got, extra)
                mon = g._heartbeat
            finally:
                g.close()
            assert g._heartbeat is None
            if mon is not None:
                assert mon._thread is None

        ts = [threading.Thread(target=rank, args=(r,), daemon=True)
              for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
            assert not t.is_alive()
        on = interval is not None
        assert out[0] == (on, None)
        assert out[1][:2] == (on, "x")
        assert (out[1][2] > 0) == on


_KILL_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from thrill_tpu_torch.net.tcp import construct_tcp_group, parse_hostlist
g = construct_tcp_group(1, parse_hostlist(sys.argv[2]), timeout=60)
print("READY", flush=True)
time.sleep(120)
"""


def test_a_killed_peer_is_named_in_the_cluster_abort(monkeypatch):
    """A real peer process killed with SIGKILL between collectives: the
    survivor's monitor (THRILL_TPU_HEARTBEAT_S=0.1) latches a
    ClusterAbort that names rank 1, and the next collective raises it
    instead of waiting. The group knows its hosts, so the broken link
    counts as repairable and the monitor first leaves it to a heal for
    twice THRILL_TPU_HEAL_TIMEOUT_S (1 s here), as the reference's."""
    monkeypatch.setenv("THRILL_TPU_HEARTBEAT_S", "0.1")
    monkeypatch.setenv("THRILL_TPU_HEAL_TIMEOUT_S", "1")
    hosts = [("127.0.0.1", p) for p in _free_ports(2)]
    hostlist = " ".join(f"{h}:{p}" for h, p in hosts)
    env = dict(os.environ)
    env.pop("THRILL_TPU_HEARTBEAT_S")
    child = subprocess.Popen([sys.executable, "-c", _KILL_CHILD, REPO,
                              hostlist], stdout=subprocess.PIPE, env=env,
                             text=True)
    g = None
    try:
        g = construct_tcp_group(0, hosts, timeout=60)
        assert child.stdout.readline().strip() == "READY"
        assert g._heartbeat is not None
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and g._pending_abort is None:
            time.sleep(0.05)
        ab = g._pending_abort
        assert ab is not None, "the monitor never noticed the killed peer"
        assert "rank 1 is unreachable" in ab.cause
        with pytest.raises(ClusterAbort, match="rank 1"):
            g.all_reduce(1)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        if g is not None:
            g.close()


def test_injected_timer_fault_keeps_timer_armed():
    """net.dispatcher.timer: a transient fault in the periodic callback
    skips one tick; the timer keeps firing."""
    from thrill_tpu_torch.net.dispatcher import Dispatcher

    disp = Dispatcher(force_py=True)
    fired = threading.Event()
    count = [0]

    def cb():
        count[0] += 1
        if count[0] >= 3:
            fired.set()
        return True

    try:
        with faults.inject("net.dispatcher.timer", n=1, seed=19):
            disp.add_timer(0.02, cb)
            assert fired.wait(timeout=20), \
                "the timer died after a transient fault"
        assert any(e.get("event") == "recovery"
                   and e.get("what") == "dispatcher.timer"
                   for e in faults.REGISTRY.events)
    finally:
        disp.close()


def test_heartbeat_key_is_the_reference_s():
    from thrill_tpu.net.group import HEARTBEAT_KEY as JKEY
    assert HEARTBEAT_KEY == JKEY
