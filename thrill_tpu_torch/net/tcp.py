"""TCP network backend: a real-socket Group with a full-mesh bootstrap
(counterpart of the reference package's ``net/tcp.py``).

Equivalent of the reference's net/tcp backend (reference:
thrill/net/tcp/construct.cpp full-mesh bootstrap with retry rounds,
socket.hpp:50, group.hpp): the control plane between the Python
controllers of a multi-process mesh, and the transport of the
host-storage multiplexer's frames (data/multiplexer.py). The bulk device
data plane rides ``torch.distributed`` (parallel/mesh.py).

Wire format: 4-byte little-endian length + a non-executing typed codec
(net/wire.py) per message; decoding never runs code. With a shared
secret (THRILL_TPU_SECRET) every connection runs a mutual HMAC-SHA256
challenge-response at bootstrap, every later frame carries a MAC, and
pickled payloads are allowed; without one, pickle frames are refused in
both directions. Bootstrap: rank j dials every rank i < j (i listens);
each side announces its rank (validated: in range, not self, not taken).
Retries cover staggered process starts. A dropped link is repaired by
:meth:`TcpGroup._heal_transport` (same roles as the bootstrap, the same
authentication, then a session handshake).

Small control frames are written by the caller's thread. A connection
of a bootstrapped group hands its socket to the group's asynchronous
engine (net/dispatcher.py, the epoll loop of ``native/dispatcher.cpp``
on its own thread) at its first frame of 256 KiB or when a blocking
send stalls, so bulk frames to many peers progress together and two
peers that both send first cannot wait on each other's kernel buffers.
Sends through the engine borrow the caller's buffers until ``flush()``.
``THRILL_TPU_HEARTBEAT_S`` starts the liveness monitor
(net/heartbeat.py) with the group. ``join_tcp_group`` admits a rank
into a live group mid-resize (``Group.resize`` on the members' side).

Env (reference: THRILL_RANK/THRILL_HOSTLIST, api/context.cpp:204-272):
THRILL_TPU_RANK, THRILL_TPU_HOSTLIST="host0:port0 host1:port1 ...",
THRILL_TPU_SECRET=<shared cluster secret>.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..common import faults
from ..common.retry import default_policy
from . import wire
from .group import (F_RESIZE, HEARTBEAT_KEY, CollectiveHangTimeout,
                    Connection, Group, hang_timeout_s, resize_timeout_s)


# Injection sites fire BEFORE any bytes hit the wire, so the internal
# retry (shared backoff policy) is safe: nothing was transmitted. Real
# transport errors on an established stream classify PERMANENT at this
# layer — a partially sent frame leaves the stream unrecoverable, and
# resynchronizing would accept corrupt framing.
_F_CONNECT = faults.declare("net.tcp.connect",
                            exc=faults.InjectedConnectionError)
_F_SEND = faults.declare("net.tcp.send",
                         exc=faults.InjectedConnectionError)
_F_FLUSH = faults.declare("net.tcp.flush",
                          exc=faults.InjectedConnectionError)
_FRAME_TRANSIENT = (faults.InjectedConnectionError,)

# link-drop injection: an armed fire REALLY closes the socket
# mid-exchange (kind="permanent" at the frame layer — nothing can
# resynchronize a torn stream), surfacing as a plain ConnectionError so
# no per-frame retry absorbs it. The current pipeline aborts; the
# generation heal (Group.begin_generation -> _repair_connection)
# reconnects the link for the next one.
_F_DISCONNECT = faults.declare("net.tcp.disconnect", kind="permanent")

# an external client vanishing mid-session (SIGKILL, network
# partition) as seen from the serving edge: fired in the front door's
# per-connection reader (service/front_door.py), an armed fire drops
# exactly that client's connection. Permanent by nature: its in-flight
# jobs still complete and other tenants never notice.
F_CLIENT_DISCONNECT = faults.declare("net.tcp.client_disconnect",
                                     kind="permanent")


def _reconnect_enabled() -> bool:
    """THRILL_TPU_RECONNECT=0 disables link repair: a dropped socket
    then stays fatal for the Context (pre-reconnect behavior)."""
    return os.environ.get("THRILL_TPU_RECONNECT", "1") != "0"


def _reconnect_tries() -> int:
    """UNANSWERED dial attempts per link repair
    (THRILL_TPU_RECONNECT_TRIES, default 25; backoff rides the shared
    full-jitter policy). Generous by design: during a multi-link heal
    a live peer repairs its links sequentially, so early dials land on
    a port nobody is listening on yet — the budget must outlast that
    window, and the heal deadline stays the hard bound."""
    try:
        return max(1, int(os.environ.get("THRILL_TPU_RECONNECT_TRIES",
                                         "25")))
    except ValueError:
        return 25


def _frame_site_check(site: str) -> None:
    """Per-frame injection gate. Only injected faults are retryable at
    this layer (real stream errors are permanent), so with no
    injection active the policy machinery is skipped entirely — the
    disarmed hot path costs one env read."""
    if faults.REGISTRY.active():
        default_policy(transient=_FRAME_TRANSIENT).run(
            lambda: faults.check(site), what=site)


def _wait_fd(sock: socket.socket, write: bool, timeout: float) -> bool:
    """poll()-based readiness wait. select.select raises ValueError for
    fds >= FD_SETSIZE (1024), which a large full-mesh with many open
    files can hit — poll has no such limit."""
    import select as _select
    p = _select.poll()
    p.register(sock.fileno(),
               _select.POLLOUT if write else _select.POLLIN)
    try:
        return bool(p.poll(timeout * 1000.0))
    finally:
        p.unregister(sock.fileno())




class TcpConnection(Connection):
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # e.g. AF_UNIX socketpair in tests
        self.authenticated = False
        self._session_key: Optional[bytes] = None
        self._send_dir = b""
        self._recv_dir = b""
        self._send_seq = 0
        self._recv_seq = 0
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        # the async engine (net/dispatcher.py); None: blocking socket
        # ops. Small control frames stay on the blocking path; the
        # engine attaches at the first frame of _ASYNC_THRESHOLD bytes
        # when a supplier is set, and owns the fd from then on
        self._disp = None
        # in-flight async sends: (rid, nbytes), bounded by
        # bytes (a few giant borrowed frames pin more than many small)
        self._disp_inflight: "deque" = None
        self._inflight_bytes = 0
        self._max_inflight_bytes = _ASYNC_INFLIGHT_BYTES
        self._reap_stalled_rid = None
        self._disp_supplier = None
        # an async send failure seen outside send() (the reap in recv),
        # raised at the next send or flush
        self._send_error = None
        # monotonic timestamp of the last heartbeat frame seen on this
        # connection (net/heartbeat.py liveness chatter)
        self.last_heartbeat = 0.0
        # link verdict: set when the stream died (peer closed, torn
        # frame, injected disconnect). A broken connection refuses
        # traffic fast; TcpGroup._heal_transport replaces it
        self.broken = False

    def _drop_link(self) -> None:
        """Tear this link down for real: detach from the async engine,
        close the fd, mark broken. The peer sees EOF on its next read."""
        self.broken = True
        if self._disp is not None:
            try:
                self._disp.unregister(self.sock)
            except Exception:
                pass
            self._disp = None
        try:
            self.sock.close()
        except OSError:
            pass

    def _check_link(self) -> None:
        """Fail fast on a known-dead link; fire the injected
        mid-exchange socket drop when armed."""
        if self.broken:
            raise ConnectionError(
                "tcp link is down (awaiting generation heal/reconnect)")
        if faults.REGISTRY.active():
            try:
                faults.check(_F_DISCONNECT)
            except faults.InjectedFault as e:
                self._drop_link()
                raise ConnectionError(
                    "injected link drop (net.tcp.disconnect)") from e

    def _mark_broken(self, exc: BaseException) -> None:
        """A real transport error tore the stream: remember the verdict.
        Injected RETRYABLE faults fire before any byte hits the wire,
        and timeouts (TimeoutError is an OSError subclass — the
        watchdog's CollectiveHangTimeout, send_bounded's nothing-sent
        expiry) leave the stream intact: neither condemns the link."""
        if not isinstance(exc, (faults.InjectedFault, TimeoutError)):
            self.broken = True


    def set_dispatcher_supplier(self, supplier) -> None:
        """Enable the lazy attach: ``supplier()`` returns the shared
        engine the first time a large frame (or a stalled send) needs
        it."""
        self._disp_supplier = supplier

    def attach_dispatcher(self, disp,
                          max_inflight_bytes: Optional[int] = None) -> None:
        """Route all traffic through the async engine from now on: sends
        enqueue and return (in-flight bytes bounded), receives complete
        on the engine's thread. Safe while a blocking recv runs on
        another thread: the direct receive path tolerates the fd turning
        non-blocking mid-frame, finishes its frame with direct reads
        under ``_recv_lock``, and the next recv goes through the
        engine."""
        with self._send_lock:
            if self._disp is not None:
                return
            self._attach_locked(disp, max_inflight_bytes)

    def _attach_locked(self, disp,
                       max_inflight_bytes: Optional[int] = None) -> None:
        disp.register(self.sock)
        self._disp = disp
        from collections import deque
        self._disp_inflight = deque()
        self._inflight_bytes = 0
        if max_inflight_bytes is not None:
            self._max_inflight_bytes = max_inflight_bytes

    # bounded wait when over the in-flight byte cap: when both peers
    # enqueue past the cap before either reads, the head write retires
    # only once the peer reads; past this wait sends queue past the cap
    # (memory over deadlock: Thrill's dispatcher queues writes unbounded)
    _REAP_TIMEOUT_S = 0.5

    def _enqueue_send(self, rid: int, nbytes: int) -> None:
        self._disp_inflight.append((rid, nbytes))
        self._inflight_bytes += nbytes

    def _retire_head(self) -> None:
        """Caller holds _send_lock; the head request is complete."""
        rid, nb = self._disp_inflight.popleft()
        self._inflight_bytes -= nb
        self._reap_stalled_rid = None
        self._disp.fetch(rid)         # raises if the write failed

    def _reap_sends(self, block: bool) -> None:
        """Caller holds _send_lock. Retire completed async sends; with
        ``block``, wait (bounded) until back under the in-flight byte
        cap. A head that timed out once is not waited on again: the
        peer is stalled, so an over-cap burst queues at enqueue speed
        after the first stall."""
        q = self._disp_inflight
        while q:
            rid = q[0][0]
            if self._disp.poll(rid) == 0:
                if not (block
                        and self._inflight_bytes > self._max_inflight_bytes):
                    return
                if rid == self._reap_stalled_rid:
                    return
                if self._disp.wait(rid, self._REAP_TIMEOUT_S) == 0:
                    self._reap_stalled_rid = rid
                    return
            self._retire_head()

    def flush(self) -> None:
        """Block until every queued async send has hit the socket."""
        _frame_site_check(_F_FLUSH)
        if self._disp is None:
            return
        with self._send_lock:
            if self._send_error is not None:
                e, self._send_error = self._send_error, None
                raise e
            q = self._disp_inflight
            while q:
                self._disp.wait(q[0][0])
                self._retire_head()

    def send(self, obj: Any) -> int:
        """Send one message; returns the serialized payload byte count
        (the wire truth, measured here where the frame is encoded: the
        multiplexer's byte accounting reads it). Large bytes and ndarray
        payloads are borrowed (scatter-gather, no copy): on a connection
        with the engine attached the buffer must not change until the
        send completes, and ``flush()`` is the point where it has."""
        _frame_site_check(_F_SEND)
        self._check_link()
        parts = wire.dumps_parts(obj, allow_pickle=self.authenticated)
        total = sum(len(p) for p in parts)
        bufs = [struct.pack("<I", total), *parts]
        try:
            with self._send_lock:
                if self._send_error is not None:
                    e, self._send_error = self._send_error, None
                    raise e
                if self._session_key is not None:
                    # per-frame MAC: the handshake alone does not protect
                    # the stream from on-path frame injection
                    bufs.append(wire.frame_mac_parts(
                        self._session_key, self._send_dir, self._send_seq,
                        parts))
                    self._send_seq += 1
                if (self._disp is None and self._disp_supplier is not None
                        and total >= _ASYNC_THRESHOLD):
                    # the first bulk frame hands the fd to the engine
                    self._attach_locked(self._disp_supplier())
                if self._disp is not None:
                    self._reap_sends(block=True)
                    for b in bufs:
                        self._enqueue_send(
                            self._disp.async_write(self.sock, b), len(b))
                else:
                    self._sendall_parts(bufs)
        except (ConnectionError, OSError) as e:
            self._mark_broken(e)
            raise
        return total

    def send_bounded(self, obj: Any, deadline_s: float) -> None:
        """Send one message with a hard bound on blocking time (the
        abort protocol, net/group.py ``poison_peers``, and the heartbeat
        probes: writing to a peer whose socket buffer is full must not
        hang the caller). A deadline that fires before any byte hit the
        wire raises TimeoutError and leaves the stream (and the MAC
        sequence) as before the call; one that fires mid-frame raises
        ConnectionError (the stream is torn). A sender already holding
        the send lock counts against the deadline. With the engine
        attached the frame is enqueued, never waited on, after a reap
        that raises a dead peer's failed write (the prober's verdict)."""
        if self.broken:
            raise ConnectionError(
                "tcp link is down (awaiting reconnect)")
        deadline_at = time.monotonic() + float(deadline_s)
        if not self._send_lock.acquire(timeout=deadline_s):
            raise TimeoutError("send_bounded: send lock busy past the "
                               "deadline")
        try:
            if self._send_error is not None:
                e, self._send_error = self._send_error, None
                raise e
            parts = wire.dumps_parts(obj,
                                     allow_pickle=self.authenticated)
            total = sum(len(p) for p in parts)
            bufs = [struct.pack("<I", total), *parts]
            if self._session_key is not None:
                # MAC under the CURRENT seq; the counter only advances
                # once the frame is fully written, so a nothing-sent
                # timeout leaves the stream resumable
                bufs.append(wire.frame_mac_parts(
                    self._session_key, self._send_dir, self._send_seq,
                    parts))
            if self._disp is not None:
                self._reap_sends(block=False)
                for b in bufs:
                    self._enqueue_send(
                        self._disp.async_write(self.sock, b), len(b))
                if self._session_key is not None:
                    self._send_seq += 1
                return
            mvs = [memoryview(b).cast("B") for b in bufs]
            frame_bytes = sum(len(m) for m in mvs)
            sent = 0
            self.sock.setblocking(False)
            try:
                while mvs:
                    remaining = deadline_at - time.monotonic()
                    if remaining <= 0:
                        if sent == 0:
                            raise TimeoutError(
                                "send_bounded: peer not draining "
                                "(no bytes written)")
                        raise ConnectionError(
                            f"send_bounded: frame torn mid-write "
                            f"({sent}/{frame_bytes} bytes) — "
                            f"connection unusable")
                    if not _wait_fd(self.sock, write=True,
                                    timeout=min(remaining, 0.5)):
                        continue
                    try:
                        nb = self.sock.sendmsg(mvs)
                    except (BlockingIOError, InterruptedError):
                        continue
                    sent += nb
                    while mvs and nb >= len(mvs[0]):
                        nb -= len(mvs[0])
                        mvs.pop(0)
                    if mvs and nb:
                        mvs[0] = mvs[0][nb:]
                if self._session_key is not None:
                    self._send_seq += 1
            finally:
                if self._disp is None:
                    try:
                        self.sock.setblocking(True)
                    except OSError:
                        pass
        except (ConnectionError, OSError) as e:
            self._mark_broken(e)
            raise
        finally:
            self._send_lock.release()

    # a blocking send making no progress for this long escapes to the
    # async engine, whatever the frame size
    _BLOCKING_SEND_STALL_S = 2.0

    def _sendall_parts(self, bufs) -> None:
        """sendmsg-based sendall over a list of buffers (zero-copy
        scatter-gather; handles partial sends). Caller holds
        _send_lock. With a dispatcher supplier, a stalled send (a peer
        not draining, as when both sides of a pair send first) hands
        its unsent tail to the engine instead of blocking on kernel
        buffers; the socket runs non-blocking under the poll loop
        meanwhile, since a blocking ``sendmsg`` could park in the kernel
        mid-frame where no stall check runs. The concurrent reader
        tolerates the mode flip (:meth:`_recv_exact`)."""
        mvs = [memoryview(b).cast("B") for b in bufs]
        can_escape = self._disp_supplier is not None
        if can_escape:
            self.sock.setblocking(False)
        try:
            while mvs:
                if can_escape and not _wait_fd(
                        self.sock, write=True,
                        timeout=self._BLOCKING_SEND_STALL_S):
                    # no progress: switch this connection to the engine
                    # and enqueue a copy of the tail (the caller may
                    # reuse its buffer once a blocking send returns)
                    self._attach_locked(self._disp_supplier())
                    for mv in mvs:
                        b = bytes(mv)
                        self._enqueue_send(
                            self._disp.async_write(self.sock, b), len(b))
                    return
                try:
                    n = self.sock.sendmsg(mvs)
                except (BlockingIOError, InterruptedError):
                    continue
                while mvs and n >= len(mvs[0]):
                    n -= len(mvs[0])
                    mvs.pop(0)
                if mvs and n:
                    mvs[0] = mvs[0][n:]
        finally:
            # blocking again unless the engine took the fd
            if can_escape and self._disp is None:
                self.sock.setblocking(True)

    def recv(self) -> Any:
        return self._recv_msg(None)

    def recv_deadline(self, deadline_s: float) -> Any:
        """Timed receive for the collective watchdog (net/group.py):
        raises :class:`CollectiveHangTimeout` when no complete frame
        lands within ``deadline_s``. The deadline is ABSOLUTE across
        the call — heartbeat chatter proves the peer process is alive
        but does not excuse a wedged collective."""
        return self._recv_msg(time.monotonic() + float(deadline_s))

    def _recv_msg(self, deadline_at: Optional[float]) -> Any:
        self._check_link()
        try:
            return self._recv_msg_inner(deadline_at)
        except (ConnectionError, OSError) as e:
            self._mark_broken(e)
            raise

    def _recv_msg_inner(self, deadline_at: Optional[float]) -> Any:
        while True:   # heartbeat frames are liveness chatter, not data
            with self._recv_lock:
                header = self._recv_exact(4, deadline_at)
                try:
                    (size,) = struct.unpack("<I", header)
                    payload = self._recv_exact(size, deadline_at)
                    if self._session_key is not None:
                        mac = self._recv_exact(wire._MAC_LEN,
                                               deadline_at)
                        want = wire.frame_mac(self._session_key,
                                              self._recv_dir,
                                              self._recv_seq, payload)
                        import hmac as _hmac
                        if not _hmac.compare_digest(mac, want):
                            raise wire.AuthError(
                                "wire: frame MAC mismatch")
                        self._recv_seq += 1
                except CollectiveHangTimeout:
                    # the deadline fired MID-FRAME: the header (and
                    # possibly part of the payload) is already
                    # consumed, so the stream is desynchronized — a
                    # later read would parse payload bytes as a frame
                    # length. Condemn the link; the generation heal
                    # reconnects it instead of reusing garbage.
                    self.broken = True
                    raise
                obj = wire.loads(payload,
                                 allow_pickle=self.authenticated)
            # retire completed async sends (send and recv alternate in
            # every collective, so the pins last one phase); a send
            # failure found here is raised at the next send or flush,
            # never in place of the received message
            if self._disp is not None and self._send_lock.acquire(
                    blocking=False):
                try:
                    self._reap_sends(block=False)
                except ConnectionError as e:
                    self._send_error = e
                finally:
                    self._send_lock.release()
            if isinstance(obj, dict) and HEARTBEAT_KEY in obj:
                # filtered at the TRANSPORT so every consumer —
                # collectives, multiplexer bulk frames — stays
                # oblivious to liveness chatter
                self.last_heartbeat = time.monotonic()
                continue
            return obj

    def authenticate(self, secret: bytes, role: str) -> None:
        """Mutual role-bound HMAC challenge-response; raises on
        mismatch. ``role`` is "client" for the dialing side, "server"
        for the accepting side. On success every subsequent frame is
        MACed under the derived session key."""
        with self._send_lock, self._recv_lock:
            key = wire.mutual_auth(secret, role, self.sock.sendall,
                                   self._recv_exact)
            self._session_key = key
            self._send_dir = b"c>" if role == "client" else b"s>"
            self._recv_dir = b"s>" if role == "client" else b"c>"
        self.authenticated = True

    def _recv_exact(self, n: int,
                    deadline_at: Optional[float] = None) -> bytes:
        if self._disp is not None:
            rid = self._disp.async_read(self.sock, n)
            if deadline_at is None:
                self._disp.wait(rid)
            else:
                remaining = deadline_at - time.monotonic()
                if remaining <= 0 or self._disp.wait(
                        rid, remaining) == 0:
                    # the orphaned read stays queued and would take the
                    # next bytes: the stream cannot resynchronize
                    self.broken = True
                    raise CollectiveHangTimeout(
                        f"no frame within the recv deadline "
                        f"({n} bytes outstanding)")
            return self._disp.fetch(rid)
        chunks = []
        while n > 0:
            if deadline_at is not None:
                remaining = deadline_at - time.monotonic()
                if remaining <= 0:
                    if chunks:
                        # partial read: later reads would misparse the
                        # remaining bytes — the stream is torn
                        self.broken = True
                    raise CollectiveHangTimeout(
                        f"no frame within the recv deadline "
                        f"({n} bytes outstanding)")
                if not _wait_fd(self.sock, write=False,
                                timeout=min(remaining, 0.5)):
                    continue
            try:
                b = self.sock.recv(n)
            except (BlockingIOError, InterruptedError):
                # a concurrent send_bounded or engine attach flipped the
                # fd to non-blocking mid-frame; finish this frame with
                # direct reads (we hold _recv_lock, so the engine has no
                # read racing us)
                _wait_fd(self.sock, write=False, timeout=0.2)
                continue
            if not b:
                raise ConnectionError("peer closed connection")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self.flush()
        except (ConnectionError, OSError) as e:
            # close() must not raise in clean-up paths, but queued
            # messages were lost: say so (a caller that needs the
            # guarantee calls flush() itself)
            import sys
            print(f"thrill_tpu_torch.net.tcp: async sends lost at close: "
                  f"{e}", file=sys.stderr)
        if self._disp is not None:
            try:
                self._disp.unregister(self.sock)
            except OSError:
                pass
            self._disp = None
        try:
            self.sock.close()
        except OSError:
            pass


class TcpGroup(Group):
    def __init__(self, my_rank: int, num_hosts: int,
                 conns: Dict[int, TcpConnection]) -> None:
        super().__init__(my_rank, num_hosts)
        self._conns = conns
        # the group's shared async engine, made at the first bulk frame
        self._disp = None
        self._disp_owned = False
        self._disp_lock = threading.Lock()
        # the liveness monitor (net/heartbeat.py); None unless
        # THRILL_TPU_HEARTBEAT_S is set
        self._heartbeat = None
        # reconnect endpoints: construct_tcp_group stores the hostlist
        # + shared secret so a dropped link can be re-dialed with the
        # same session-handshake guarantees as bootstrap. None
        # (socketpair-built test groups) = reconnect unavailable.
        self._hosts: Optional[List[Tuple[str, int]]] = None
        self._secret: Optional[bytes] = None

    def connection(self, peer: int) -> TcpConnection:
        if peer == self.my_rank:
            raise ValueError("no connection to self")
        return self._conns[peer]

    @property
    def supports_recv_any(self) -> bool:
        return True

    def _pick_ready_peer(self, peers) -> int:
        """Any-source readiness probe: poll the peer sockets and return
        the first with bytes pending (the connection reads straight
        from the socket, so fd readability == a frame is landing).
        Bounded by the collective-watchdog deadline; on expiry returns
        the first peer so recv_from's watchdog raises the attributable
        abort."""
        import select as _select
        conns = [self._conns[p] for p in peers]
        deadline = hang_timeout_s()
        deadline_at = (None if deadline is None
                       else time.monotonic() + deadline)
        p = _select.poll()
        by_fd = {}
        try:
            for peer, c in zip(peers, conns):
                fd = c.sock.fileno()
                p.register(fd, _select.POLLIN)
                by_fd[fd] = peer
            while True:
                if deadline_at is not None:
                    remaining = deadline_at - time.monotonic()
                    if remaining <= 0:
                        return peers[0]
                    timeout_ms = min(remaining, 0.5) * 1000.0
                else:
                    timeout_ms = 500.0
                events = p.poll(timeout_ms)
                if events:
                    return by_fd[events[0][0]]
        finally:
            for fd in by_fd:
                try:
                    p.unregister(fd)
                except (KeyError, OSError):
                    pass

    # ------------------------------------------------------------------
    # reconnect-with-backoff (generation heal, net/group.py)
    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # link repair: reconnect with backoff
    # ------------------------------------------------------------------

    def _heal_transport(self, deadline_at: float) -> None:
        """Repair every link already KNOWN broken before the generation
        barrier runs; a link that cannot be repaired fails the heal
        (the Context then escalates to the unrecoverable path)."""
        # ASCENDING peer order on every rank: with lower-listens /
        # higher-dials roles this is ordered resource acquisition —
        # concurrent multi-link heals cannot form a cyclic
        # accept/dial wait (dict insertion order is bootstrap accept
        # completion order, which CAN cycle)
        for peer in sorted(self._conns):
            conn = self._conns[peer]
            if getattr(conn, "broken", False):
                if not self._repair_connection(peer, deadline_at):
                    raise ConnectionError(
                        f"rank {self.my_rank}: link to rank {peer} is "
                        f"down and could not be reconnected "
                        f"(THRILL_TPU_RECONNECT/"
                        f"THRILL_TPU_RECONNECT_TRIES)")

    def _repair_connection(self, peer: int, deadline_at: float,
                           cause: Optional[BaseException] = None) -> bool:
        """Re-establish the link to ``peer``: same roles as bootstrap
        (lower rank listens, higher rank dials), mutual auth when a
        secret is configured, then a session handshake exchanging
        (rank, generation, frame seq) so both sides agree which failure
        domain the fresh stream belongs to. Returns False when
        reconnect is disabled/unavailable or the peer never answers
        (a dead PROCESS, not a dropped link — that verdict escalates)."""
        old = self._conns.get(peer)
        if old is not None:
            # idempotent: closes the fd even when an earlier recv
            # error already marked the link broken (a peer-closed
            # socket stays open on OUR side until dropped)
            old._drop_link()
        if self._hosts is None or not _reconnect_enabled():
            return False
        try:
            if peer > self.my_rank:
                conn = self._reconnect_accept(peer, deadline_at)
            else:
                conn = self._reconnect_dial(peer, deadline_at)
        except wire.AuthError:
            raise                   # definitive: never degrade auth
        except (ConnectionError, OSError, TimeoutError) as e:
            faults.note("recovery", what="net.reconnect_failed",
                        peer=peer, gen=self.generation, error=repr(e))
            return False
        if old is not None and old._disp_supplier is not None:
            conn.set_dispatcher_supplier(self._shared_dispatcher)
        self._conns[peer] = conn
        self.stats_reconnects += 1
        faults.note("recovery", what="net.reconnect", peer=peer,
                    gen=self.generation, transport="tcp")
        from ..common.trace import instant_of
        instant_of(getattr(self, "tracer", None), "net", "reconnect",
                   peer=peer, gen=self.generation)
        return True

    def link_repairable(self, peer: int) -> bool:
        conn = self._conns.get(peer)
        return (conn is not None and getattr(conn, "broken", False)
                and self._hosts is not None and _reconnect_enabled())

    def _handshake_frame(self) -> dict:
        # a FRESH stream restarts the MAC sequence: seq announces (and
        # the peer validates) where frame numbering resumes
        return {"reconnect": self.my_rank, "gen": self.generation,
                "seq": 0}

    def _validate_handshake(self, obj: Any, want_rank: int) -> int:
        if not (isinstance(obj, dict) and "reconnect" in obj):
            raise ConnectionError(f"bad reconnect handshake {obj!r}")
        if int(obj["reconnect"]) != want_rank:
            raise ConnectionError(
                f"reconnect handshake from unexpected rank "
                f"{obj['reconnect']!r} (awaiting {want_rank})")
        if int(obj.get("seq", 0)) != 0:
            raise ConnectionError(
                f"reconnect handshake with nonzero frame seq "
                f"{obj.get('seq')!r} — peer expects a resumed stream, "
                f"only fresh sessions are supported")
        gen = int(obj.get("gen", self.generation))
        if gen != self.generation:
            # both sides must be healing the SAME failure domain; a
            # cross-generation stream (one rank aborted again while
            # the other was still dialing) is rejected LOUDLY here —
            # the dialer retries and converges, instead of the
            # mismatch surfacing as an opaque barrier timeout
            raise ConnectionError(
                f"reconnect handshake generation mismatch: peer is "
                f"healing gen {gen}, this rank gen {self.generation}")
        return gen

    def _reconnect_dial(self, peer: int,
                        deadline_at: float) -> TcpConnection:
        import random
        policy = default_policy(max_attempts=1 << 30,
                                base_delay_s=0.05, max_delay_s=1.0)
        rng = random.Random(f"reconnect:{self.my_rank}:{peer}")
        tries = _reconnect_tries()
        attempt = 0             # dead-process budget: UNANSWERED dials
        rounds = 0              # backoff progression across all errors
        while True:
            connected = False
            try:
                s = socket.create_connection(self._hosts[peer],
                                             timeout=2.0)
                connected = True
                s.settimeout(min(10.0, max(
                    deadline_at - time.monotonic(), 1.0)))
                conn = TcpConnection(s)
                try:
                    _exchange_auth_flag(conn, self._secret is not None)
                    if self._secret is not None:
                        conn.authenticate(self._secret, role="client")
                    conn.send(self._handshake_frame())
                    self._validate_handshake(conn.recv(), peer)
                except Exception:
                    conn.close()
                    raise
                s.settimeout(None)
                return conn
            except wire.AuthError:
                raise
            except OSError as e:
                # only UNANSWERED dials spend the dead-process budget
                # (THRILL_TPU_RECONNECT_TRIES): a rejection after the
                # connect succeeded means the peer PROCESS is alive —
                # e.g. its one-port acceptor is mid-repair of another
                # link, or a cross-generation handshake — and must not
                # burn the budget toward a false dead verdict. The
                # heal deadline stays the overall bound.
                rounds += 1
                if not connected:
                    attempt += 1
                if (attempt >= tries
                        or time.monotonic() >= deadline_at):
                    raise ConnectionError(
                        f"rank {self.my_rank}: reconnect to rank "
                        f"{peer} failed after {attempt} unanswered "
                        f"dials / {rounds} rounds") from e
                d = policy.delay(min(rounds, 6), rng)
                faults.note("retry", _quiet=rounds > 3,
                            what="tcp.reconnect_dial", peer=peer,
                            attempt=rounds, delay_s=round(d, 4),
                            error=repr(e))
                time.sleep(min(d, max(
                    deadline_at - time.monotonic(), 0.0)))

    def _reconnect_accept(self, peer: int,
                          deadline_at: float) -> TcpConnection:
        host, port = self._hosts[self.my_rank]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((host if host != "localhost" else "127.0.0.1",
                      port))
            srv.listen(4)
            srv.settimeout(0.5)
            while time.monotonic() < deadline_at:
                try:
                    s, addr = srv.accept()
                except socket.timeout:
                    continue
                s.settimeout(min(10.0, max(
                    deadline_at - time.monotonic(), 1.0)))
                conn = TcpConnection(s)
                try:
                    _exchange_auth_flag(conn, self._secret is not None)
                    if self._secret is not None:
                        conn.authenticate(self._secret, role="server")
                    self._validate_handshake(conn.recv(), peer)
                    conn.send(self._handshake_frame())
                except Exception as e:
                    # a different rank's dialer (several links healing
                    # at once) or a rogue connection: reject, keep
                    # listening — the rejected dialer retries
                    conn.close()
                    import sys
                    print(f"thrill_tpu_torch.net.tcp: rank {self.my_rank} "
                          f"rejected reconnect from {addr}: {e}",
                          file=sys.stderr)
                    continue
                s.settimeout(None)
                return conn
            raise ConnectionError(
                f"rank {self.my_rank}: reconnect accept from rank "
                f"{peer} timed out")
        finally:
            srv.close()

    # ------------------------------------------------------------------
    # elastic membership (Group.resize transport hooks)
    # ------------------------------------------------------------------

    def _grow_transport(self, new_num_hosts: int, gen: int,
                        deadline_at: float) -> None:
        """Admit joining ranks ``[num_hosts, new_num_hosts)``: each
        joiner dials this rank's own hostlist port (the same
        lower-listens role as bootstrap and reconnect) and runs the
        authenticated ``resize_join`` handshake — rank, target
        generation, new W — before its link is trusted. The joiner's
        announced endpoint is appended to the hostlist so later link
        repairs can re-dial it."""
        if self._hosts is None:
            raise ConnectionError(
                f"rank {self.my_rank}: no hostlist endpoints (this "
                f"group was not built by construct_tcp_group); cannot "
                f"admit ranks")
        expect = set(range(self.num_hosts, new_num_hosts))
        got = _accept_resize_joins(
            self._hosts[self.my_rank], self.my_rank, expect, gen,
            new_num_hosts, self._secret, deadline_at)
        lazy = any(c._disp_supplier is not None
                   for c in self._conns.values())
        for j in sorted(got):
            conn, endpoint = got[j]
            if lazy:
                conn.set_dispatcher_supplier(self._shared_dispatcher)
            self._conns[j] = conn
            while len(self._hosts) <= j:
                self._hosts.append(("127.0.0.1", 0))
            if endpoint is not None:
                self._hosts[j] = endpoint

    def _shrink_transport(self, new_num_hosts: int) -> None:
        """Close and forget links to ranks ``>= new_num_hosts`` (they
        drained and left, or were dead already)."""
        for peer in sorted(p for p in self._conns
                           if p >= new_num_hosts):
            try:
                self._conns[peer].close()
            except OSError:
                pass
            del self._conns[peer]
        if self._hosts is not None:
            del self._hosts[new_num_hosts:]

    # ------------------------------------------------------------------
    # the async engine
    # ------------------------------------------------------------------
    def _shared_dispatcher(self):
        """One async engine per group, made at the first bulk frame (a
        DispatcherThread per host, Thrill: net/dispatcher_thread.hpp:
        60)."""
        with self._disp_lock:
            if self._disp is None:
                from .dispatcher import Dispatcher
                self._disp = Dispatcher()
                self._disp_owned = True
            return self._disp

    def enable_lazy_async(self) -> None:
        """Connections keep the blocking path for control frames and
        hand their fd to the shared engine at the first frame past the
        async threshold (or a stalled send)."""
        for c in self._conns.values():
            c.set_dispatcher_supplier(self._shared_dispatcher)

    def attach_dispatcher(self, disp=None) -> None:
        """Drive every frame through one async engine from now on. An
        engine the caller passes stays the caller's (``close()`` does
        not close it). Once an engine is active for this group it cannot
        be replaced: attach before any bulk traffic, or pass none to use
        the group's own."""
        if disp is None:
            disp = self._shared_dispatcher()
        else:
            with self._disp_lock:
                if self._disp is not None and self._disp is not disp:
                    raise ValueError(
                        "group already has an active dispatcher; "
                        "attach before any bulk traffic or pass no "
                        "engine to reuse the group's own")
                self._disp = disp
                self._disp_owned = False
        for c in self._conns.values():
            c.attach_dispatcher(disp)

    def flush(self) -> None:
        for c in self._conns.values():
            c.flush()

    def close(self) -> None:
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        for c in self._conns.values():
            c.close()
        if self._disp is not None and self._disp_owned:
            self._disp.close()
        self._disp = None


# a connection hands its fd to the async engine at its first frame of
# this many bytes: control frames keep the blocking path (Thrill's flow
# group is synchronous), bulk frames ride the engine
_ASYNC_THRESHOLD = 1 << 18
# a connection's unretired async send bytes past which send() waits,
# bounded, for the engine to drain (pinned borrowed buffers)
_ASYNC_INFLIGHT_BYTES = 64 << 20


def _exchange_auth_flag(conn: TcpConnection, have_secret: bool) -> None:
    """1-byte preamble so an asymmetric THRILL_TPU_SECRET configuration
    fails fast with the real cause instead of a generic bootstrap
    timeout (one side waiting for a challenge that never comes)."""
    conn.sock.sendall(b"\x01" if have_secret else b"\x00")
    peer = conn._recv_exact(1)
    if peer not in (b"\x00", b"\x01"):
        raise ConnectionError(f"tcp: bad auth preamble {peer!r}")
    if (peer == b"\x01") != have_secret:
        raise wire.AuthError(
            "tcp: THRILL_TPU_SECRET is configured on one side of the "
            "connection but not the other — set the same secret on "
            "every host (or on none)")




def _resize_frame(rank: int, gen: int, new_w: int,
                  endpoint: Optional[Tuple[str, int]] = None) -> dict:
    """The ``resize_join`` handshake frame: like the reconnect
    handshake (rank, generation, fresh frame seq) plus the NEW group
    width, so both sides prove they are executing the SAME membership
    change, not a reconnect or a different resize."""
    f = {"resize_join": int(rank), "gen": int(gen),
         "num_hosts": int(new_w), "seq": 0}
    if endpoint is not None:
        f["host"], f["port"] = str(endpoint[0]), int(endpoint[1])
    return f


def _validate_resize_frame(obj: Any, gen: int, new_w: int,
                           want_ranks) -> int:
    if not (isinstance(obj, dict) and "resize_join" in obj):
        raise ConnectionError(f"bad resize handshake {obj!r}")
    j = int(obj["resize_join"])
    if j not in want_ranks:
        raise ConnectionError(
            f"resize handshake from unexpected rank {j} "
            f"(awaiting {sorted(want_ranks)})")
    if int(obj.get("seq", 0)) != 0:
        raise ConnectionError(
            f"resize handshake with nonzero frame seq "
            f"{obj.get('seq')!r} — only fresh sessions join a group")
    if int(obj.get("gen", -1)) != int(gen):
        raise ConnectionError(
            f"resize handshake generation mismatch: peer targets gen "
            f"{obj.get('gen')!r}, this rank gen {gen}")
    if int(obj.get("num_hosts", -1)) != int(new_w):
        raise ConnectionError(
            f"resize handshake width mismatch: peer targets W="
            f"{obj.get('num_hosts')!r}, this rank W={new_w}")
    return j


def _accept_resize_joins(endpoint: Tuple[str, int], my_rank: int,
                         expect, gen: int, new_w: int,
                         secret: Optional[bytes],
                         deadline_at: float) -> dict:
    """Accept ``resize_join`` dials from every rank in ``expect`` on
    ``endpoint`` (this rank's own hostlist port — the reconnect
    role). Returns ``{rank: (conn, joiner_endpoint_or_None)}``.
    Rogue/mismatched connections are rejected and the listener keeps
    going, exactly like the reconnect acceptor."""
    expect = set(expect)
    got: dict = {}
    if not expect:
        return got
    host, port = endpoint
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        srv.bind((host if host != "localhost" else "127.0.0.1", port))
        srv.listen(4)
        srv.settimeout(0.5)
        while expect - set(got):
            if time.monotonic() >= deadline_at:
                raise ConnectionError(
                    f"rank {my_rank}: resize accept timed out awaiting "
                    f"ranks {sorted(expect - set(got))} "
                    f"(THRILL_TPU_RESIZE_TIMEOUT_S)")
            try:
                s, addr = srv.accept()
            except socket.timeout:
                continue
            s.settimeout(min(10.0, max(
                deadline_at - time.monotonic(), 1.0)))
            conn = TcpConnection(s)
            try:
                _exchange_auth_flag(conn, secret is not None)
                if secret is not None:
                    conn.authenticate(secret, role="server")
                obj = conn.recv()
                j = _validate_resize_frame(obj, gen, new_w,
                                           expect - set(got))
                conn.send(_resize_frame(my_rank, gen, new_w))
            except wire.AuthError:
                conn.close()
                raise               # definitive: never degrade auth
            except Exception as e:
                conn.close()
                import sys
                print(f"thrill_tpu_torch.net.tcp: rank {my_rank} rejected "
                      f"resize join from {addr}: {e}", file=sys.stderr)
                continue
            s.settimeout(None)
            ep = None
            if obj.get("host") is not None and obj.get("port"):
                ep = (str(obj["host"]), int(obj["port"]))
            got[j] = (conn, ep)
        return got
    finally:
        srv.close()


def _dial_resize_join(endpoint: Tuple[str, int], my_rank: int,
                      peer: int, gen: int, new_w: int,
                      my_endpoint: Tuple[str, int],
                      secret: Optional[bytes],
                      deadline_at: float) -> TcpConnection:
    """One joiner->member dial with the authenticated ``resize_join``
    handshake, retried under the shared full-jitter backoff until the
    resize deadline (the member may still be draining its current
    generation when the joiner starts dialing)."""
    import random
    policy = default_policy(max_attempts=1 << 30,
                            base_delay_s=0.05, max_delay_s=1.0)
    rng = random.Random(f"resize:{my_rank}:{peer}")
    rounds = 0
    while True:
        try:
            s = socket.create_connection(endpoint, timeout=2.0)
            s.settimeout(min(10.0, max(
                deadline_at - time.monotonic(), 1.0)))
            conn = TcpConnection(s)
            try:
                _exchange_auth_flag(conn, secret is not None)
                if secret is not None:
                    conn.authenticate(secret, role="client")
                conn.send(_resize_frame(my_rank, gen, new_w,
                                        my_endpoint))
                _validate_resize_frame(conn.recv(), gen, new_w,
                                       (peer,))
            except Exception:
                conn.close()
                raise
            s.settimeout(None)
            return conn
        except wire.AuthError:
            raise
        except OSError as e:
            rounds += 1
            if time.monotonic() >= deadline_at:
                raise ConnectionError(
                    f"rank {my_rank}: resize join to rank {peer} at "
                    f"{endpoint} failed after {rounds} rounds") from e
            d = policy.delay(min(rounds, 6), rng)
            faults.note("retry", _quiet=rounds > 3,
                        what="tcp.resize_dial", peer=peer,
                        attempt=rounds, delay_s=round(d, 4),
                        error=repr(e))
            time.sleep(min(d, max(
                deadline_at - time.monotonic(), 0.0)))


def join_tcp_group(rank: int, hosts: List[Tuple[str, int]],
                   generation: int,
                   timeout: Optional[float] = None,
                   secret: Optional[bytes] = None) -> TcpGroup:
    """Bootstrap of a JOINING rank into a live group mid-resize.

    ``hosts`` is the NEW full hostlist (width W'); this process takes
    rank ``rank`` (>= the old width). It dials every lower rank — the
    live members, which are inside ``Group.resize`` accepting on their
    own hostlist ports, plus any lower-ranked fellow joiner — and
    accepts dials from higher-ranked fellow joiners, so a multi-rank
    grow wires the same full mesh bootstrap does. The caller then runs
    ``begin_generation(generation)``: the joiner's first collective is
    the generation barrier that commits the new membership everywhere.
    """
    p = len(hosts)
    if not (0 <= rank < p):
        raise ValueError(f"joining rank {rank} outside hostlist "
                         f"of {p}")
    faults.check(F_RESIZE, new=p, gen=int(generation), rank=rank,
                 side="join")
    deadline_at = time.monotonic() + (resize_timeout_s()
                                      if timeout is None
                                      else float(timeout))
    conns: Dict[int, TcpConnection] = {}
    try:
        for peer in range(rank):
            conns[peer] = _dial_resize_join(
                hosts[peer], rank, peer, generation, p, hosts[rank],
                secret, deadline_at)
        for j, (conn, _) in _accept_resize_joins(
                hosts[rank], rank, range(rank + 1, p), generation, p,
                secret, deadline_at).items():
            conns[j] = conn
    except BaseException:
        for c in conns.values():
            try:
                c.close()
            except OSError:
                pass
        raise
    group = TcpGroup(rank, p, conns)
    group._hosts = list(hosts)
    group._secret = secret
    group.enable_lazy_async()
    from . import heartbeat
    group._heartbeat = heartbeat.maybe_start(group)
    # orphan-run adoption: a joiner in a departed rank's place claims
    # that rank's committed runs of the external Sort (core/em_runs.py),
    # so its first Sort loads them; best effort, a failure only means
    # the runs are formed again
    ckpt_dir = os.environ.get("THRILL_TPU_CKPT_DIR", "")
    if ckpt_dir:
        try:
            from ..core.em_runs import adopt_orphan_runs
            adopt_orphan_runs(ckpt_dir, rank)
        except Exception as e:
            faults.note("recovery", what="em_runs.adopt_failed",
                        error=repr(e)[:200])
    return group


def parse_hostlist(s: str) -> List[Tuple[str, int]]:
    out = []
    for part in s.replace(",", " ").split():
        host, _, port = part.rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def construct_tcp_group(rank: int, hosts: List[Tuple[str, int]],
                        timeout: Optional[float] = None,
                        secret: Optional[bytes] = None) -> TcpGroup:
    """Full-mesh bootstrap: rank j dials every i < j; i accepts j..p-1.

    With ``secret`` every connection is mutually HMAC-authenticated
    before the rank announcement is trusted (and pickled payloads are
    enabled); without it the non-executing codec is the only format.
    """
    p = len(hosts)
    if p == 1:
        return TcpGroup(0, 1, {})
    # bootstrap deadline is dead-peer DIAGNOSTIC, load-scaled and
    # RE-evaluated as loops progress (fixed when the caller passed an
    # explicit timeout): under contention peer processes legitimately
    # take minutes to even reach their connect loop (imports + torch
    # init), and a load spike arriving mid-bootstrap must stretch an
    # already-started wait. The per-connection HANDSHAKE cap guards
    # against a silent/rogue connection parking the accept thread —
    # it scales too (a healthy peer can be descheduled >10 s at 6x).
    from ..common.timeouts import budget_fn
    budget = budget_fn(timeout, 60.0)
    hs_cap = (budget_fn(None, 10.0) if timeout is None
              else (lambda: min(10.0, float(timeout))))
    conns: Dict[int, TcpConnection] = {}
    lock = threading.Lock()
    errors: List[BaseException] = []

    def accept_side():
        try:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((hosts[rank][0] if hosts[rank][0] != "localhost"
                      else "127.0.0.1", hosts[rank][1]))
            srv.listen(p)
            srv.settimeout(1.0)              # poll slice; budget below
            expected = p - 1 - rank          # ranks > mine dial in
            accepted = 0
            accept_start = time.time()
            while accepted < expected:
                if time.time() - accept_start > budget():
                    raise TimeoutError(
                        f"rank {rank}: bootstrap accept timed out")
                try:
                    s, addr = srv.accept()
                except socket.timeout:
                    continue
                # accepted sockets do NOT inherit the listener timeout;
                # without one, a silent connection would park this
                # thread in recv forever and wedge the whole bootstrap
                s.settimeout(hs_cap())
                conn = TcpConnection(s)
                try:
                    _exchange_auth_flag(conn, secret is not None)
                    if secret is not None:
                        conn.authenticate(secret, role="server")
                    peer = conn.recv()       # rank announcement
                    with lock:
                        if (type(peer) is not int or not rank < peer < p
                                or peer in conns):
                            raise ConnectionError(
                                f"invalid rank announcement {peer!r}")
                        conns[peer] = conn
                except Exception as e:
                    # reject the rogue/failed peer, keep accepting
                    conn.close()
                    import sys
                    print(f"thrill_tpu_torch.net.tcp: rank {rank} rejected "
                          f"peer {addr}: {e}", file=sys.stderr)
                    continue
                s.settimeout(None)           # handshake done: blocking
                accepted += 1
            srv.close()
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    acceptor = threading.Thread(target=accept_side, daemon=True)
    acceptor.start()

    # dials retry under the shared backoff policy (full jitter spreads
    # a whole cluster's simultaneous restarts instead of herding them);
    # the load-scaled budget stays the overall deadline, so attempts
    # continue until the budget expires, not a fixed count.
    dial_policy = default_policy(max_attempts=1 << 30,
                                 base_delay_s=0.05, max_delay_s=1.0)
    dial_start = time.time()
    for peer in range(rank):                 # dial every lower rank
        attempt = 0
        rng = None
        while True:
            try:
                faults.check(_F_CONNECT, peer=peer)
                s = socket.create_connection(hosts[peer], timeout=2.0)
                s.settimeout(hs_cap())
                conn = TcpConnection(s)
                _exchange_auth_flag(conn, secret is not None)
                if secret is not None:
                    conn.authenticate(secret, role="client")
                conn.send(rank)
                s.settimeout(None)           # handshake done: blocking
                with lock:
                    conns[peer] = conn
                break
            except wire.AuthError:
                # auth failure is definitive (secret mismatch), not a
                # transient dial error — fail fast with the real cause
                raise
            except OSError as e:
                if (isinstance(e, faults.InjectedFault)
                        and os.environ.get("THRILL_TPU_RETRY",
                                           "1") == "0"):
                    # detection-only runs: injected dial faults must
                    # SURFACE. (Plain connection-refused keeps the
                    # budgeted loop — waiting for peers that haven't
                    # started listening is bootstrap, not retry.)
                    raise
                if time.time() - dial_start > budget():
                    raise TimeoutError(
                        f"rank {rank}: cannot reach rank {peer} at "
                        f"{hosts[peer]}") from e
                if rng is None:
                    import random
                    rng = random.Random(f"dial:{rank}:{peer}")
                d = dial_policy.delay(min(attempt, 6), rng)
                # staggered starts make many dial retries NORMAL at
                # bootstrap: count every one, log only sparsely
                faults.note("retry",
                            _quiet=not (attempt < 3
                                        or attempt % 32 == 0),
                            what="tcp.bootstrap_dial",
                            attempt=attempt + 1, peer=peer,
                            delay_s=round(d, 4), error=repr(e))
                attempt += 1
                time.sleep(d)

    join_start = time.time()
    while acceptor.is_alive() and time.time() - join_start <= budget():
        acceptor.join(timeout=1.0)
    if acceptor.is_alive():
        raise TimeoutError(f"rank {rank}: bootstrap accept timed out")
    if errors:
        raise errors[0]
    assert len(conns) == p - 1
    group = TcpGroup(rank, p, conns)
    # remember the endpoints + secret: a link repair re-dials a dropped
    # link through the same authenticated handshake
    group._hosts = list(hosts)
    group._secret = secret
    # the lazy async engine
    group.enable_lazy_async()
    # liveness heartbeats (THRILL_TPU_HEARTBEAT_S): a killed peer
    # becomes an attributable ClusterAbort between collectives too
    from . import heartbeat
    group._heartbeat = heartbeat.maybe_start(group)
    return group


def construct_from_env() -> Optional[TcpGroup]:
    """THRILL_TPU_RANK/HOSTLIST -> TcpGroup (None when unset)."""
    hostlist = os.environ.get("THRILL_TPU_HOSTLIST")
    if not hostlist:
        return None
    rank = int(os.environ.get("THRILL_TPU_RANK", "0"))
    secret = wire.secret_from_env()
    if secret is None:
        import sys
        print("thrill_tpu_torch.net.tcp: THRILL_TPU_SECRET unset — "
              "connections are unauthenticated and restricted to the "
              "non-executing wire codec", file=sys.stderr)
    return construct_tcp_group(rank, parse_hostlist(hostlist),
                               secret=secret)
