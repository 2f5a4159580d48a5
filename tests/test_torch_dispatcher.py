"""The port's asynchronous engine (``thrill_tpu_torch/net/dispatcher.py``
over ``native/dispatcher.cpp``, and its ``selectors`` engine) and the
TCP transport's use of it: the cases of the reference's
``tests/net/test_dispatcher.py``, each engine in turn.

Thrill's AsyncRead/AsyncWrite queue semantics
(thrill/net/dispatcher.hpp:510: FIFO per fd per direction, completion
after exactly the requested bytes) over socketpairs, the engine-driven
``TcpConnection`` framing, the TCP group's collectives with the lazy
engine, the escape of a stalled blocking send, and the timer facility.
Tolerance: exact (bytes). Every wait is bounded; a deadlock fails its
test.
"""

import os
import socket
import threading

import pytest

from thrill_tpu_torch.net.dispatcher import (Dispatcher, DispatcherError,
                                             _NativeDispatcher, _load_native)
from thrill_tpu_torch.net.tcp import TcpConnection, construct_tcp_group


@pytest.fixture(params=["py", "native"])
def disp(request):
    d = Dispatcher(force_py=request.param == "py")
    if request.param == "native":
        # the host compiler builds native/dispatcher.cpp at first use
        assert isinstance(d, _NativeDispatcher), "the native build failed"
    yield d
    d.close()


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


def run_tcp(num_hosts, job, timeout=60):
    """``job(group)`` on one daemon thread a rank of a loopback TCP
    group (the lazy engine on, as by default); results by rank."""
    hosts = [("127.0.0.1", p) for p in free_ports(num_hosts)]
    results = [None] * num_hosts
    errors = [None] * num_hosts

    def target(r):
        try:
            g = construct_tcp_group(r, hosts, timeout=20)
            try:
                results[r] = job(g)
            finally:
                g.close()
        except BaseException as e:
            errors[r] = e

    threads = [threading.Thread(target=target, args=(r,), daemon=True)
               for r in range(num_hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "a rank deadlocked"
    for e in errors:
        if e is not None:
            raise e
    return results


def test_write_read_roundtrip(disp):
    a, b = socket.socketpair()
    try:
        disp.register(a)
        disp.register(b)
        w = disp.async_write(a, b"hello world")
        r = disp.async_read(b, 11)
        assert disp.wait(w, timeout=5) == 1
        assert disp.wait(r, timeout=5) == 1
        assert disp.fetch(r) == b"hello world"
        assert disp.fetch(w) == b""
    finally:
        disp.unregister(a)
        disp.unregister(b)
        a.close()
        b.close()


def test_fifo_order_and_split_reads(disp):
    """Many queued writes retire in order; reads may cut the byte
    stream at different boundaries than the writes."""
    a, b = socket.socketpair()
    try:
        disp.register(a)
        disp.register(b)
        msgs = [bytes([i]) * (100 + i) for i in range(20)]
        wids = [disp.async_write(a, m) for m in msgs]
        whole = b"".join(msgs)
        # read in unrelated chunk sizes
        rids, sizes, off = [], [], 0
        step = 333
        while off < len(whole):
            n = min(step, len(whole) - off)
            rids.append(disp.async_read(b, n))
            sizes.append(n)
            off += n
        got = b""
        for rid in rids:
            assert disp.wait(rid, timeout=10) == 1
            got += disp.fetch(rid)
        assert got == whole
        for w in wids:
            assert disp.wait(w, timeout=5) == 1
            disp.fetch(w)
    finally:
        disp.unregister(a)
        disp.unregister(b)
        a.close()
        b.close()


def test_large_transfer_no_deadlock(disp):
    """Both sides write 8 MB before either reads, far beyond the kernel's
    socket buffers: a blocking sendall would deadlock; the engine
    interleaves."""
    a, b = socket.socketpair()
    try:
        disp.register(a)
        disp.register(b)
        big_a = os.urandom(8 << 20)
        big_b = os.urandom(8 << 20)
        wa = disp.async_write(a, big_a)
        wb = disp.async_write(b, big_b)
        ra = disp.async_read(a, len(big_b))
        rb = disp.async_read(b, len(big_a))
        for rid in (wa, wb):
            assert disp.wait(rid, timeout=30) == 1
            disp.fetch(rid)
        assert disp.wait(ra, timeout=30) == 1
        assert disp.fetch(ra) == big_b
        assert disp.wait(rb, timeout=30) == 1
        assert disp.fetch(rb) == big_a
    finally:
        disp.unregister(a)
        disp.unregister(b)
        a.close()
        b.close()


def test_zero_length_read_completes(disp):
    a, b = socket.socketpair()
    try:
        disp.register(b)
        r = disp.async_read(b, 0)
        assert disp.wait(r, timeout=5) == 1
        assert disp.fetch(r) == b""
    finally:
        disp.unregister(b)
        a.close()
        b.close()


def test_peer_close_fails_pending_read(disp):
    a, b = socket.socketpair()
    try:
        disp.register(b)
        r = disp.async_read(b, 10)
        a.close()
        st = disp.wait(r, timeout=5)
        assert st < 0
        with pytest.raises(DispatcherError):
            disp.fetch(r)
    finally:
        disp.unregister(b)
        b.close()


def test_final_bytes_readable_after_peer_close(disp):
    """A peer's last frame must survive its close: the engine sees the
    hangup while the fd is idle, parks it (no busy-spin), and a read
    posted afterwards still drains the kernel buffer before EOF."""
    import time

    a, b = socket.socketpair()
    try:
        disp.register(b)
        a.sendall(b"final")
        a.close()
        time.sleep(0.3)            # engine observes HUP with no request
        r = disp.async_read(b, 5)
        assert disp.wait(r, timeout=5) == 1
        assert disp.fetch(r) == b"final"
        r2 = disp.async_read(b, 1)  # now at EOF
        assert disp.wait(r2, timeout=5) < 0
        with pytest.raises(DispatcherError):
            disp.fetch(r2)
    finally:
        disp.unregister(b)
        b.close()


def test_zero_length_write_completes(disp):
    a, b = socket.socketpair()
    try:
        disp.register(a)
        w = disp.async_write(a, b"")
        assert disp.wait(w, timeout=5) == 1
        assert disp.fetch(w) == b""
    finally:
        disp.unregister(a)
        a.close()
        b.close()


def test_unregister_restores_blocking(disp):
    a, b = socket.socketpair()
    try:
        disp.register(a)
        disp.unregister(a)
        assert a.getblocking()
        # socket is usable with plain blocking ops again
        a.sendall(b"x")
        assert b.recv(1) == b"x"
    finally:
        a.close()
        b.close()


def test_async_tcp_connection_framing(disp):
    """TcpConnection with the engine attached: sends enqueue (bounded
    in-flight), frames arrive intact and in order — including an empty
    payload (zero-byte read path)."""
    a, b = socket.socketpair()
    ca, cb = TcpConnection(a), TcpConnection(b)
    ca.attach_dispatcher(disp, max_inflight_bytes=256)
    cb.attach_dispatcher(disp)
    try:
        msgs = [b"", b"x" * 5, b"y" * 70000, b"z"]
        for m in msgs:
            ca.send(m)
        got = [cb.recv() for _ in msgs]
        assert got == msgs
        ca.flush()
    finally:
        ca.close()
        cb.close()


def test_pending_count(disp):
    a, b = socket.socketpair()
    try:
        disp.register(b)
        assert disp.pending() == 0
        rid = disp.async_read(b, 4)
        assert disp.pending() == 1
        a.sendall(b"abcd")
        assert disp.wait(rid, timeout=5) == 1
        assert disp.fetch(rid) == b"abcd"
        assert disp.pending() == 0
    finally:
        disp.unregister(b)
        a.close()
        b.close()


def test_many_fds_interleaved(disp):
    """8 socketpairs with concurrent traffic through one engine."""
    pairs = [socket.socketpair() for _ in range(8)]
    try:
        for a, b in pairs:
            disp.register(a)
            disp.register(b)
        wids = []
        rids = []
        for i, (a, b) in enumerate(pairs):
            payload = bytes([i]) * (1000 * (i + 1))
            wids.append((disp.async_write(a, payload), payload))
            rids.append(disp.async_read(b, len(payload)))
        for (w, payload), r in zip(wids, rids):
            assert disp.wait(r, timeout=10) == 1
            assert disp.fetch(r) == payload
            assert disp.wait(w, timeout=10) == 1
            disp.fetch(w)
    finally:
        for a, b in pairs:
            disp.unregister(a)
            disp.unregister(b)
            a.close()
            b.close()


def test_native_engine_selected(monkeypatch):
    assert _load_native() is not None
    d = Dispatcher()
    try:
        assert isinstance(d, _NativeDispatcher)
    finally:
        d.close()
    monkeypatch.setenv("THRILL_TPU_NATIVE", "0")
    d = Dispatcher()
    try:
        assert not isinstance(d, _NativeDispatcher)
    finally:
        d.close()


def test_tcp_group_async_collectives():
    """The TCP group with the dispatcher attached runs the shared
    collectives."""

    def job(g):
        g.attach_dispatcher()
        total = g.all_reduce(g.my_rank + 1)
        gathered = g.all_gather(g.my_rank * 10)
        ps = g.prefix_sum(1)
        return total, gathered, ps

    results = run_tcp(4, job)
    for r, (total, gathered, ps) in enumerate(results):
        assert total == 10
        assert gathered == [0, 10, 20, 30]
        assert ps == r + 1


def test_symmetric_subthreshold_storm_no_deadlock():
    """Frames below the async threshold stay on the blocking fast path
    — but a stalled blocking send (both sides sending, nobody
    receiving, kernel buffers full) must escape to the engine instead
    of deadlocking."""
    blob = b"s" * (200 << 10)           # < 256 KiB threshold
    rounds = 40                          # ~8 MB each way, >> buffers

    def job(g):
        peer = 1 - g.my_rank
        for _ in range(rounds):
            g.send_to(peer, blob)
        got = [g.recv_from(peer) for _ in range(rounds)]
        assert all(len(x) == len(blob) for x in got)
        return True

    assert run_tcp(2, job) == [True, True]


def test_a_large_frame_attaches_the_group_engine():
    """A frame past the threshold hands the connection to the group's
    engine, which the group closes with itself."""

    def job(g):
        peer = 1 - g.my_rank
        g.send_to(peer, b"small")
        small = g.recv_from(peer)
        before = g._disp is None
        g.send_to(peer, b"b" * (1 << 19))
        big = g.recv_from(peer)
        return (small, len(big), before,
                type(g._disp).__name__, g.connection(peer)._disp is g._disp)

    for r in run_tcp(2, job):
        assert r == (b"small", 1 << 19, True, "_NativeDispatcher", True)


def test_tcp_group_async_large_symmetric():
    """Symmetric hypercube exchange of ~4 MB values: with blocking
    sends both sides of a pair can deadlock on full kernel buffers;
    the dispatcher must carry it."""
    blob = b"z" * (4 << 20)

    def job(g):
        out = g.all_gather(bytes([g.my_rank]) + blob)
        return [o[0] for o in out]

    results = run_tcp(2, job)
    for r in results:
        assert r == [0, 1]


def test_concurrent_stress_many_threads(disp):
    """Several threads drive distinct socketpairs through one engine
    with random frame sizes in both directions; every byte arrives
    intact and in FIFO order."""
    import hashlib
    import random

    NPAIRS = 4
    NMSG = 30
    pairs = [socket.socketpair() for _ in range(NPAIRS)]
    for a, b in pairs:
        disp.register(a)
        disp.register(b)
    errors = []

    def pump(sock_tx, sock_rx, seed):
        try:
            rng = random.Random(seed)
            sizes = [rng.randrange(1, 1 << rng.randrange(1, 18))
                     for _ in range(NMSG)]
            payloads = [bytes(hashlib.sha256(
                f"{seed}:{i}".encode()).digest() * ((s + 31) // 32))[:s]
                for i, s in enumerate(sizes)]
            wids = [disp.async_write(sock_tx, p) for p in payloads]
            rids = [disp.async_read(sock_rx, s) for s in sizes]
            for i, (w, r) in enumerate(zip(wids, rids)):
                assert disp.wait(w, timeout=30) == 1, f"write {i}"
                assert disp.wait(r, timeout=30) == 1, f"read {i}"
                got = disp.fetch(r)
                assert got == payloads[i], \
                    f"payload {i} corrupt ({len(got)} vs {sizes[i]})"
        except Exception as e:  # surfaced by the main thread
            errors.append(e)

    threads = []
    for k, (a, b) in enumerate(pairs):
        # full duplex: one pumper per direction per pair
        threads.append(threading.Thread(
            target=pump, args=(a, b, 1000 + k), daemon=True))
        threads.append(threading.Thread(
            target=pump, args=(b, a, 2000 + k), daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "stress deadlocked"
    try:
        if errors:
            raise errors[0]
    finally:
        for a, b in pairs:
            disp.unregister(a)
            disp.unregister(b)
            a.close()
            b.close()


def test_timer_facility_oneshot_recurring_cancel():
    """AddTimer (Thrill: net/dispatcher.hpp:42-62): recurring while the
    callback returns True, one-shot by returning False, cancel_timer
    drops a pending timer."""
    import time
    disp = Dispatcher(force_py=True)
    try:
        fired = []
        done = threading.Event()

        def recurring():
            fired.append(time.monotonic())
            if len(fired) >= 3:
                done.set()
                return False            # disarm after 3 firings
            return True

        disp.add_timer(0.02, recurring)
        assert done.wait(timeout=10), "recurring timer starved"
        n_after = len(fired)
        time.sleep(0.1)
        assert len(fired) == n_after    # returning False disarmed it

        never = threading.Event()
        tid = disp.add_timer(5.0, lambda: never.set() or True)
        disp.cancel_timer(tid)
        oneshot = threading.Event()
        disp.add_timer(0.02, lambda: oneshot.set() and False)
        assert oneshot.wait(timeout=10)
        assert not never.is_set()
    finally:
        disp.close()


def test_timer_on_native_engine():
    """The native engine exposes the same timer surface."""
    disp = Dispatcher()
    try:
        assert isinstance(disp, _NativeDispatcher)
        ev = threading.Event()
        disp.add_timer(0.02, lambda: ev.set() and False)
        assert ev.wait(timeout=10)
    finally:
        disp.close()


def test_close_from_timer_callback_does_not_raise():
    """close() called from a timer callback (the watchdog pattern) does
    not join its own thread; resources still release."""
    disp = Dispatcher(force_py=True)
    closed = threading.Event()

    def watchdog():
        disp.close()                 # runs ON the timer thread
        closed.set()
        return False

    disp.add_timer(0.02, watchdog)
    assert closed.wait(timeout=10), "close() from timer callback hung"
