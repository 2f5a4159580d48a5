"""Async I/O engine: the net layer's dispatcher and its thread
(counterpart of the reference package's ``net/dispatcher.py``).

Thrill's net::Dispatcher / DispatcherThread (thrill/net/dispatcher.hpp:
510, per-connection queues of AsyncRead/AsyncWrite buffers driven by an
event loop on a dedicated thread; dispatcher_thread.hpp:60). The engine
is native C++ (``native/dispatcher.cpp``: epoll on a dedicated thread,
built with ``g++`` at first use by ``common/native_build.py``
``load_host``, as the spill store is); this wrapper exposes request
handles Python can wait on. A pure-Python ``selectors`` engine takes
its place under ``THRILL_TPU_NATIVE=0`` or when the build fails.

Semantics shared by both engines:
  * ``async_write(sock, bytes)`` copies the buffer in and returns a
    request id immediately; the engine writes when the socket is
    writable. Per-fd writes retire FIFO, so framing order is preserved.
  * ``async_read(sock, n)`` completes once exactly n bytes arrived.
  * ``wait(id)`` blocks until completion; ``fetch(id)`` returns a
    read's payload (b"" for writes) and frees the slot.
Registered fds are switched to non-blocking and owned by the engine —
all traffic on them must flow through it until ``unregister``.
"""

from __future__ import annotations

import ctypes
import os
import selectors
import socket
import threading
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from ..common import faults

# fires inside the periodic-callback dispatch: a transient fault skips
# ONE tick and keeps the timer armed (a heartbeat must survive a flaky
# beat); any other exception still disarms loudly below
_F_TIMER = faults.declare("net.dispatcher.timer",
                          exc=faults.InjectedIOError)

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _load_native() -> Optional[ctypes.CDLL]:
    """The engine's library, built from ``native/dispatcher.cpp`` at
    first use (common/native_build.py); None when it cannot be built."""
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        from ..common.native_build import load_host
        lib = load_host("dispatcher")
        if lib is None:
            _LIB_FAILED = True
            return None
        try:
            lib.disp_create.restype = ctypes.c_void_p
            lib.disp_destroy.argtypes = [ctypes.c_void_p]
            lib.disp_register.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.disp_register.restype = ctypes.c_int
            lib.disp_unregister.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.disp_unregister.restype = ctypes.c_int
            lib.disp_async_write.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64]
            lib.disp_async_write.restype = ctypes.c_int64
            lib.disp_async_read.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64]
            lib.disp_async_read.restype = ctypes.c_int64
            lib.disp_poll.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.disp_poll.restype = ctypes.c_int64
            lib.disp_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_double]
            lib.disp_wait.restype = ctypes.c_int64
            lib.disp_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_char_p, ctypes.c_int64]
            lib.disp_fetch.restype = ctypes.c_int64
            lib.disp_pending.argtypes = [ctypes.c_void_p]
            lib.disp_pending.restype = ctypes.c_int64
            _LIB = lib
        except Exception:
            _LIB_FAILED = True
    return _LIB


class _TimerFacility:
    """Timer service shared by both engines (Thrill:
    net/dispatcher.hpp:42-62 ``AddTimer``): ``add_timer(period,
    callback)`` fires ``callback()`` every ``period`` seconds for as
    long as it returns True; returning False (or ``cancel_timer``)
    drops it. Thrill dispatches timer callbacks on its event
    loop thread; the native engine's loop is C++, so callbacks here run
    on ONE dedicated daemon thread per dispatcher — the same
    serialization guarantee (no two callbacks of one dispatcher run
    concurrently), started lazily on the first add_timer."""

    def _timer_init(self) -> None:
        self._tlock = threading.Lock()
        self._tcv = threading.Condition(self._tlock)
        self._theap: list = []            # (deadline, tid)
        self._tcb: Dict[int, Tuple[float, object]] = {}
        self._tnext = 0
        self._tstop = False
        self._tthread: Optional[threading.Thread] = None

    def add_timer(self, period_s: float, callback) -> int:
        """Schedule ``callback`` every ``period_s`` seconds; returns a
        timer id for cancel_timer. Re-arms while callback() is true."""
        import heapq
        import time
        with self._tcv:
            if self._tstop:
                raise DispatcherError("add_timer on closed dispatcher")
            tid = self._tnext
            self._tnext += 1
            self._tcb[tid] = (float(period_s), callback)
            heapq.heappush(self._theap,
                           (time.monotonic() + period_s, tid))
            if self._tthread is None:
                self._tthread = threading.Thread(
                    target=self._timer_run, daemon=True,
                    name="thrill-tpu-torch-timers")
                self._tthread.start()
            self._tcv.notify()
        return tid

    def cancel_timer(self, tid: int) -> None:
        with self._tcv:
            self._tcb.pop(tid, None)
            self._tcv.notify()

    def _timer_run(self) -> None:
        import heapq
        import time
        while True:
            with self._tcv:
                while True:
                    if self._tstop:
                        return
                    now = time.monotonic()
                    # drop heap entries for cancelled timers
                    while self._theap and \
                            self._theap[0][1] not in self._tcb:
                        heapq.heappop(self._theap)
                    if self._theap and self._theap[0][0] <= now:
                        _, tid = heapq.heappop(self._theap)
                        period, cb = self._tcb[tid]
                        break
                    delay = (self._theap[0][0] - now
                             if self._theap else None)
                    self._tcv.wait(timeout=delay)
            # fire OUTSIDE the lock: callbacks may add/cancel timers
            try:
                faults.check(_F_TIMER, timer=tid)
                again = bool(cb())
            except Exception as exc:
                if (isinstance(exc, faults.InjectedFault)
                        and exc.kind == faults.TRANSIENT):
                    # skip this tick, stay armed: periodic services
                    # (heartbeats, spill flushes) ride out one glitch
                    faults.note("recovery", what="dispatcher.timer",
                                timer=tid)
                    again = True
                else:
                    # any other raising timer disarms — LOUDLY, or a
                    # dead periodic task (heartbeat, flush) degrades
                    # the system silently
                    import sys
                    import traceback
                    print(f"thrill_tpu_torch: timer {tid} raised and was "
                          f"disarmed:\n{traceback.format_exc()}",
                          file=sys.stderr)
                    again = False
            with self._tcv:
                if tid not in self._tcb:
                    continue              # cancelled while firing
                if again:
                    heapq.heappush(self._theap,
                                   (time.monotonic() + period, tid))
                else:
                    del self._tcb[tid]

    def _timer_close(self) -> None:
        with self._tcv:
            self._tstop = True
            self._tcv.notify_all()
        if (self._tthread is not None
                and self._tthread is not threading.current_thread()):
            # join, unless close() was called FROM a timer callback
            # (the run loop sees _tstop and exits on its own)
            self._tthread.join(timeout=5)


class DispatcherError(ConnectionError):
    pass


class _NativeDispatcher(_TimerFacility):
    """ctypes front for the epoll engine."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._timer_init()
        self._lib = lib
        self._h = lib.disp_create()
        if not self._h:
            raise OSError("disp_create failed")
        self._sizes: Dict[int, int] = {}   # read req id -> want bytes
        # write buffers are BORROWED by the engine (zero-copy enqueue):
        # pin the buffer objects here until the request is fetched.
        # Callers must not mutate a pinned buffer before completion.
        self._pins: Dict[int, tuple] = {}
        self._by_fd: Dict[int, set] = {}   # fd -> outstanding req ids
        self._lock = threading.Lock()

    def register(self, sock: socket.socket) -> None:
        if self._lib.disp_register(self._h, sock.fileno()) != 0:
            raise OSError("disp_register failed")
        with self._lock:
            self._by_fd.setdefault(sock.fileno(), set())

    def unregister(self, sock: socket.socket) -> None:
        fd = sock.fileno()
        # the engine retires every outstanding request with an error
        # status before returning...
        self._lib.disp_unregister(self._h, fd)
        # ...then drain those completions so pins/sizes/native slots
        # don't leak in the group-shared engine
        with self._lock:
            rids = self._by_fd.pop(fd, set())
        for rid in rids:
            self._lib.disp_fetch(self._h, rid, None, 0)
            with self._lock:
                self._pins.pop(rid, None)
                self._sizes.pop(rid, None)

    @staticmethod
    def _pinnable(data):
        """(address, length, pin_objects) for a contiguous read view of
        ``data`` — zero-copy for bytes/memoryview/contiguous buffers."""
        import numpy as np
        mv = memoryview(data)
        if not mv.contiguous:
            mv = memoryview(bytes(mv))
        mv = mv.cast("B")
        if len(mv) == 0:
            return 0, 0, (mv,)
        arr = np.frombuffer(mv, dtype=np.uint8)
        return int(arr.ctypes.data), len(mv), (mv, arr)

    def async_write(self, sock: socket.socket, data) -> int:
        addr, n, pins = self._pinnable(data)
        fd = sock.fileno()
        rid = self._lib.disp_async_write(self._h, fd,
                                         ctypes.c_void_p(addr), n)
        if rid < 0:
            raise DispatcherError("async_write on unregistered/failed fd")
        with self._lock:
            self._pins[rid] = pins    # engine borrows; release at fetch
            self._by_fd.setdefault(fd, set()).add(rid)
        return rid

    def async_read(self, sock: socket.socket, n: int) -> int:
        fd = sock.fileno()
        rid = self._lib.disp_async_read(self._h, fd, n)
        if rid < 0:
            raise DispatcherError("async_read on unregistered/failed fd")
        with self._lock:
            self._sizes[rid] = n
            self._by_fd.setdefault(fd, set()).add(rid)
        return rid

    def poll(self, rid: int) -> int:
        return int(self._lib.disp_poll(self._h, rid))

    def wait(self, rid: int, timeout: Optional[float] = None) -> int:
        return int(self._lib.disp_wait(
            self._h, rid, -1.0 if timeout is None else timeout))

    _NOT_DONE = -(1 << 62)

    def fetch(self, rid: int) -> bytes:
        with self._lock:
            cap = self._sizes.get(rid, 0)
        buf = ctypes.create_string_buffer(cap) if cap else None
        n = self._lib.disp_fetch(self._h, rid, buf, cap)
        if n == self._NOT_DONE:
            # still pending — the engine may still borrow the write
            # buffer, so the pin MUST stay
            raise DispatcherError(
                f"async request {rid} fetched before completion")
        with self._lock:
            self._pins.pop(rid, None)  # request retired: unpin buffer
            self._sizes.pop(rid, None)
            for rids in self._by_fd.values():
                rids.discard(rid)
        if n < 0:
            raise DispatcherError(
                f"async request {rid} failed (status {n})")
        return buf.raw[:n] if buf is not None else b""

    def pending(self) -> int:
        return int(self._lib.disp_pending(self._h))

    def close(self) -> None:
        self._timer_close()
        if self._h:
            self._lib.disp_destroy(self._h)
            self._h = None


class _PyDispatcher(_TimerFacility):
    """Pure-Python fallback: ``selectors`` loop on a daemon thread."""

    def __init__(self) -> None:
        self._timer_init()
        self._sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._writes: Dict[int, Deque[Tuple[int, memoryview]]] = {}
        self._reads: Dict[int, Deque[Tuple[int, int, bytearray]]] = {}
        self._socks: Dict[int, socket.socket] = {}
        self._done: Dict[int, Tuple[int, bytes]] = {}  # id -> (status, data)
        self._fd_rids: Dict[int, set] = {}  # fd -> requests ever issued
        self._errored: set = set()  # fds with a failed send/recv
        self._next_id = 1
        self._stop = False
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._sel.register(self._waker_r, selectors.EVENT_READ, None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="thrill-tpu-torch-dispatcher")
        self._thread.start()

    def _wake(self) -> None:
        try:
            self._waker_w.send(b"\x01")
        except OSError:
            pass

    def register(self, sock: socket.socket) -> None:
        sock.setblocking(False)
        with self._lock:
            fd = sock.fileno()
            self._writes[fd] = deque()
            self._reads[fd] = deque()
            self._socks[fd] = sock
            self._errored.discard(fd)   # fd number may be recycled
            # no selector registration yet: selectors reject an empty
            # interest set, so the fd joins the loop on first request

    def unregister(self, sock: socket.socket) -> None:
        with self._cv:
            fd = sock.fileno()
            # queued requests complete with an error so waiters wake;
            # completed-but-unfetched slots are dropped with the fd so
            # nothing outlives the registration (no leak in a shared
            # engine — mirrors the native wrapper's drain)
            pending = ({rid for rid, _ in self._writes.get(fd, ())}
                       | {rid for rid, _, _ in self._reads.get(fd, ())})
            for rid in pending:
                self._done[rid] = (-32, b"")
            self._writes.pop(fd, None)
            self._reads.pop(fd, None)
            for rid in self._fd_rids.pop(fd, set()) - pending:
                self._done.pop(rid, None)
            self._socks.pop(fd, None)
            self._errored.discard(fd)
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError):
                pass
            self._cv.notify_all()
        sock.setblocking(True)

    def async_write(self, sock: socket.socket, data: bytes) -> int:
        with self._cv:
            fd = sock.fileno()
            if fd not in self._writes:
                raise DispatcherError("async_write on unregistered fd")
            if fd in self._errored:
                # match the native engine: once a send/recv failed, the
                # fd stays rejected (no engine-dependent semantics)
                raise DispatcherError("async_write on failed fd")
            rid = self._next_id
            self._next_id += 1
            self._fd_rids.setdefault(fd, set()).add(rid)
            mv = memoryview(data)          # zero-copy for bytes/views
            if not mv.contiguous:
                mv = memoryview(bytes(mv))
            mv = mv.cast("B")
            if not self._writes[fd]:
                # opportunistic inline send while the queue is empty
                # (FIFO-safe); the attempt cap bounds enqueue latency —
                # only the unsent tail rides the loop
                for _ in range(4):
                    if not len(mv):
                        break
                    try:
                        n = sock.send(mv)
                    except (BlockingIOError, InterruptedError):
                        break
                    except OSError:
                        self._done[rid] = (-32, b"")
                        self._fail_fd(fd, -32)
                        return rid
                    mv = mv[n:]
                if not len(mv):
                    self._done[rid] = (1, b"")
                    self._cv.notify_all()
                    return rid
            self._writes[fd].append((rid, mv))
            self._update(fd)
        self._wake()
        return rid

    def async_read(self, sock: socket.socket, n: int) -> int:
        with self._cv:
            fd = sock.fileno()
            if fd not in self._reads:
                raise DispatcherError("async_read on unregistered fd")
            if fd in self._errored:
                raise DispatcherError("async_read on failed fd")
            rid = self._next_id
            self._next_id += 1
            self._fd_rids.setdefault(fd, set()).add(rid)
            if n == 0 and not self._reads[fd]:
                # zero-byte read with nothing queued ahead completes
                # right away (select never fires for it)
                self._done[rid] = (1, b"")
                self._cv.notify_all()
                return rid
            self._reads[fd].append((rid, n, bytearray()))
            self._update(fd)
        self._wake()
        return rid

    def poll(self, rid: int) -> int:
        with self._lock:
            if rid not in self._done:
                return 0
            status, _ = self._done[rid]
            return 1 if status >= 0 else status

    def wait(self, rid: int, timeout: Optional[float] = None) -> int:
        with self._cv:
            ok = self._cv.wait_for(lambda: rid in self._done, timeout)
            if not ok:
                return 0
            status, _ = self._done[rid]
            return 1 if status >= 0 else status

    def fetch(self, rid: int) -> bytes:
        with self._lock:
            entry = self._done.pop(rid, None)
            if entry is not None:
                for rids in self._fd_rids.values():
                    rids.discard(rid)
        if entry is None:
            # still pending (or already drained) — match the native
            # engine's kNotDone semantics, keep state untouched
            raise DispatcherError(
                f"async request {rid} fetched before completion")
        status, data = entry
        if status < 0:
            raise DispatcherError(
                f"async request {rid} failed (status {status})")
        return data

    def pending(self) -> int:
        with self._lock:
            return (sum(len(q) for q in self._writes.values())
                    + sum(len(q) for q in self._reads.values()))

    def close(self) -> None:
        self._timer_close()
        self._stop = True
        self._wake()
        self._thread.join(timeout=5)
        try:
            self._sel.close()
        except OSError:
            pass
        self._waker_r.close()
        self._waker_w.close()

    # -- loop ----------------------------------------------------------
    def _update(self, fd: int) -> None:
        """Recompute the interest set; caller holds the lock."""
        sock = self._socks.get(fd)
        if sock is None:
            return
        ev = 0
        if self._reads.get(fd):
            ev |= selectors.EVENT_READ
        if self._writes.get(fd):
            ev |= selectors.EVENT_WRITE
        try:
            if ev == 0:
                self._sel.unregister(sock)
            else:
                self._sel.modify(sock, ev, fd)
        except KeyError:
            if ev:
                self._sel.register(sock, ev, fd)
        except ValueError:
            pass

    def _fail_fd(self, fd: int, status: int) -> None:
        self._errored.add(fd)
        for rid, _ in self._writes.get(fd, ()):
            self._done[rid] = (status, b"")
        for rid, _, _ in self._reads.get(fd, ()):
            self._done[rid] = (status, b"")
        if fd in self._writes:
            self._writes[fd].clear()
        if fd in self._reads:
            self._reads[fd].clear()
        self._update(fd)
        self._cv.notify_all()

    def _run(self) -> None:
        while not self._stop:
            events = self._sel.select(timeout=0.2)
            with self._cv:
                for key, mask in events:
                    if key.data is None:          # waker
                        try:
                            while self._waker_r.recv(256):
                                pass
                        except OSError:
                            pass
                        continue
                    fd = key.data
                    sock = self._socks.get(fd)
                    if sock is None:
                        continue
                    if mask & selectors.EVENT_WRITE:
                        self._drain_writes(fd, sock)
                    if mask & selectors.EVENT_READ:
                        self._drain_reads(fd, sock)
                    self._update(fd)

    def _drain_writes(self, fd: int, sock: socket.socket) -> None:
        q = self._writes.get(fd)
        while q:
            rid, mv = q[0]
            try:
                n = sock.send(mv)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._fail_fd(fd, -32)
                return
            if n < len(mv):
                q[0] = (rid, mv[n:])
                return
            q.popleft()
            self._done[rid] = (1, b"")
            self._cv.notify_all()

    def _drain_reads(self, fd: int, sock: socket.socket) -> None:
        q = self._reads.get(fd)
        while q:
            rid, want, buf = q[0]
            if want == 0:
                q.popleft()
                self._done[rid] = (1, b"")
                self._cv.notify_all()
                continue
            try:
                chunk = sock.recv(want - len(buf))
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._fail_fd(fd, -32)
                return
            if not chunk:
                self._fail_fd(fd, -1)
                return
            buf.extend(chunk)
            if len(buf) < want:
                return
            q.popleft()
            self._done[rid] = (1, bytes(buf))
            self._cv.notify_all()


def Dispatcher(force_py: bool = False):
    """Engine factory: native epoll when buildable, selectors fallback.

    THRILL_TPU_NATIVE=0 forces the fallback."""
    use_native = (not force_py
                  and os.environ.get("THRILL_TPU_NATIVE", "1") != "0")
    if use_native:
        lib = _load_native()
        if lib is not None:
            try:
                return _NativeDispatcher(lib)
            except OSError:
                pass
    return _PyDispatcher()


# NOTE: the length-framed channel over this engine lives in
# tcp.TcpConnection (attach_dispatcher) — one implementation of the
# bounded-in-flight reap/flush logic, in the product path.
