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

Sends are synchronous: every frame is written by the caller's thread.
The reference's asynchronous dispatcher (``net/dispatcher.py`` with
``native/dispatcher.cpp``), its heartbeats and the join of a rank into a
live group (``join_tcp_group``) are later parts of ROADMAP.md item 6.
The multiplexer pairs its peers so that two blocking senders never wait
on each other (data/multiplexer.py).

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
from .group import (HEARTBEAT_KEY, CollectiveHangTimeout, Connection, Group,
                    hang_timeout_s)


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
        # monotonic timestamp of the last heartbeat frame seen on this
        # connection (liveness chatter of a peer that sends it)
        self.last_heartbeat = 0.0
        # link verdict: set when the stream died (peer closed, torn
        # frame, injected disconnect). A broken connection refuses
        # traffic fast; TcpGroup._heal_transport replaces it
        self.broken = False

    def _drop_link(self) -> None:
        """Tear this link down for real: close the fd, mark broken. The
        peer sees EOF on its next read."""
        self.broken = True
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


    def flush(self) -> None:
        """Sends are synchronous: a returned send has hit the socket.
        Kept for the injection site and the Connection contract."""
        _frame_site_check(_F_FLUSH)

    def send(self, obj: Any) -> int:
        """Send one message; returns the serialized payload byte count
        (the wire truth, measured here where the frame is encoded: the
        multiplexer's byte accounting reads it)."""
        _frame_site_check(_F_SEND)
        self._check_link()
        parts = wire.dumps_parts(obj, allow_pickle=self.authenticated)
        total = sum(len(p) for p in parts)
        bufs = [struct.pack("<I", total), *parts]
        try:
            with self._send_lock:
                if self._session_key is not None:
                    # per-frame MAC: the handshake alone does not protect
                    # the stream from on-path frame injection
                    bufs.append(wire.frame_mac_parts(
                        self._session_key, self._send_dir, self._send_seq,
                        parts))
                    self._send_seq += 1
                self._sendall_parts(bufs)
        except (ConnectionError, OSError) as e:
            self._mark_broken(e)
            raise
        return total

    def send_bounded(self, obj: Any, deadline_s: float) -> None:
        """Send one message with a hard bound on blocking time (the
        abort protocol, net/group.py ``poison_peers``: writing to a peer
        whose socket buffer is full must not hang the caller). A
        deadline that fires before any byte hit the wire raises
        TimeoutError and leaves the stream (and the MAC sequence) as
        before the call; one that fires mid-frame raises ConnectionError
        (the stream is torn). A sender already holding the send lock
        counts against the deadline."""
        if self.broken:
            raise ConnectionError(
                "tcp link is down (awaiting reconnect)")
        deadline_at = time.monotonic() + float(deadline_s)
        if not self._send_lock.acquire(timeout=deadline_s):
            raise TimeoutError("send_bounded: send lock busy past the "
                               "deadline")
        try:
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
                try:
                    self.sock.setblocking(True)
                except OSError:
                    pass
        except (ConnectionError, OSError) as e:
            self._mark_broken(e)
            raise
        finally:
            self._send_lock.release()

    def _sendall_parts(self, bufs) -> None:
        """sendmsg-based sendall over a list of buffers (zero-copy
        scatter-gather; handles partial sends). Caller holds
        _send_lock."""
        mvs = [memoryview(b).cast("B") for b in bufs]
        while mvs:
            try:
                n = self.sock.sendmsg(mvs)
            except InterruptedError:
                continue
            while mvs and n >= len(mvs[0]):
                n -= len(mvs[0])
                mvs.pop(0)
            if mvs and n:
                mvs[0] = mvs[0][n:]

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
                # a concurrent send_bounded flipped the fd to
                # non-blocking mid-frame; finish this frame with
                # direct reads (we hold _recv_lock)
                _wait_fd(self.sock, write=False, timeout=0.2)
                continue
            if not b:
                raise ConnectionError("peer closed connection")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class TcpGroup(Group):
    def __init__(self, my_rank: int, num_hosts: int,
                 conns: Dict[int, TcpConnection]) -> None:
        super().__init__(my_rank, num_hosts)
        self._conns = conns
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
    def flush(self) -> None:
        for c in self._conns.values():
            c.flush()

    def close(self) -> None:
        for c in self._conns.values():
            c.close()


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




def join_tcp_group(rank: int, hosts: List[Tuple[str, int]],
                   generation: int, timeout: Optional[float] = None,
                   secret: Optional[bytes] = None) -> TcpGroup:
    """Bootstrap of a joining rank into a live group mid-resize. Not
    ported yet: elastic membership is a later part of ROADMAP.md item
    6."""
    raise NotImplementedError(
        "join_tcp_group is not ported yet: ROADMAP.md queue A item 6, "
        "its generations-and-resize part")


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
