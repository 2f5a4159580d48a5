"""Network front door: socket admission, shed-load, streamed results
(counterpart of the reference package's ``service/front_door.py``).

The scheduler (service/scheduler.py) serves threads inside the
controller process; this module is the network edge: a TCP admission
protocol over :class:`~thrill_tpu_torch.net.tcp.TcpConnection` framing
and the :mod:`~thrill_tpu_torch.net.wire` codec. Admission frames are
small and ride their own sockets, never the exchange plane.

Protocol (one wire-codec frame per message, the client dials, MACed
when ``THRILL_TPU_SECRET`` is set: the mutual HMAC handshake every mesh
link runs):

* ``("hello", {"tenant", "proto"})`` -> ``("welcome", {"proto"})``
* ``("submit", {"id", "pipeline", "args", "deadline_s", "weight"})``
  -> ``("accept", id, {"mode": "blob"|"items"})`` or
  ``("reject", id, kind, retry_after_s, msg)``
* results stream back as ``("chunk", id, seq, payload)`` frames as the
  job's egress drains, closed by ``("done", id, nchunks, meta)``; a job
  failure is ``("error", id, kind, msg)``. Chunking bounds both sides'
  memory and detects a slow client per chunk.
* ``("bye", reason)`` ends a connection in either direction.

Pipelines are named: clients submit a registry key and args
(:meth:`FrontDoor.register`), never code, and the wire codec refuses
pickled payloads on unauthenticated links.

A registered pipeline runs on the scheduler's dispatcher thread, and
its result leaves the card there too: ``_stream_blob`` and
``_stream_items`` copy every tensor of a result to a numpy array before
encoding it, so the socket threads handle host bytes only and make no
CUDA call (a CUDA call from another thread could break a CUDA graph
capture of the dispatcher's job).

Overload is a designed regime:

* every rejection is typed (:class:`~.scheduler.ShedLoad`:
  ``rate_limited`` / ``tenant_queue_full`` / ``queue_full`` /
  ``draining`` / ``unknown_pipeline`` / ``deadline``) and carries a
  retry-after hint; nothing is dropped or left hanging silently;
* every client socket has read deadlines (a slow-loris client torn
  mid-frame, or a half-open one idling past
  ``THRILL_TPU_SERVE_READ_TIMEOUT_S`` with nothing in flight, is
  dropped) and write deadlines (a client not draining its result stream
  within ``THRILL_TPU_SERVE_WRITE_TIMEOUT_S`` is dropped; its jobs still
  complete, other tenants never stall);
* per-connection egress is byte-bounded
  (``THRILL_TPU_SERVE_EGRESS_BYTES``): the dispatcher offers chunks
  with a bounded wait and drops the connection, never blocks the mesh
  on a dead socket;
* graceful drain (:meth:`FrontDoor.drain`, SIGTERM through
  :meth:`FrontDoor.install_sigterm`): stop accepting, reject new
  submits with ``draining`` and a retry-after, finish every in-flight
  job and flush its stream, then say ``bye``, bounded by
  ``THRILL_TPU_SERVE_DRAIN_TIMEOUT_S``.

One controller only: an external socket submits on one process, which
would break the lockstep admission contract of a mesh of several
processes (a loud refusal, like ``Scheduler.fence``).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..common import faults
from ..net import wire
from ..net.group import CollectiveHangTimeout
from ..net.tcp import F_CLIENT_DISCONNECT, TcpConnection, \
    _exchange_auth_flag
from .scheduler import ShedLoad

# protocol range this server speaks. v1: the original frame set, the
# hello carries a single int and equality decides. v2: the hello may
# carry ``[min, max]``, the server negotiates the highest common
# version into the welcome (``{"proto": negotiated, "range": [..]}``)
# and stamps the mesh generation onto accept frames (elastic resize
# awareness). Out-of-range clients get a TYPED ``version_mismatch``
# reject naming the supported range — never a silent EOF.
PROTO_MIN = 1
PROTO_MAX = 2
# legacy shorthand: the single version a pre-range peer offers/expects
PROTO_VERSION = 1

# fired per accepted socket, before the handshake: an armed fire drops
# the connection (the client sees EOF and its retry policy redials)
_F_ACCEPT = faults.declare("service.front_door.accept")
# fired per result chunk as the dispatcher offers it to the egress: an
# armed fire aborts exactly that stream with a typed ("error", ...,
# "stream") frame — the job still completes, the connection survives
_F_STREAM = faults.declare("service.front_door.stream")
# armed with delay= it makes the writer a deterministic straggler (the
# slow-client detection's test hook); a raising fire drops the client
_F_SLOW = faults.declare("service.front_door.slow_client")


def _env_f(name: str, default: float) -> float:
    try:
        v = os.environ.get(name)
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        v = os.environ.get(name)
        return int(v) if v not in (None, "") else default
    except ValueError:
        return default


def _to_host(obj):
    """``obj`` with every tensor copied to a numpy array (inside tuples,
    lists and dict values): a result leaves the card here, on the
    dispatcher thread that runs the job."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


class _Conn:
    """One client connection: reader thread + writer thread + a
    byte-bounded egress queue between the dispatcher and the socket.

    The DISPATCHER never touches the socket: job wrappers ``offer()``
    frames into ``out`` (bounded wait, shed on overflow) and the
    writer thread drains them through ``send_bounded`` — so a dead or
    slow client costs the mesh at most one bounded offer, never a
    blocked collective."""

    __slots__ = ("conn", "peer", "tenant", "proto", "out", "out_bytes",
                 "cv", "dead", "inflight", "reader", "writer",
                 "t_last_frame", "fd")

    def __init__(self, fd: "FrontDoor", conn: TcpConnection,
                 peer: str) -> None:
        self.fd = fd
        self.conn = conn
        self.peer = peer
        self.tenant = "default"
        self.proto = PROTO_MIN     # negotiated up in the handshake
        self.out: deque = deque()
        self.out_bytes = 0
        self.cv = threading.Condition()
        self.dead = False
        self.inflight: Dict[int, Any] = {}      # id -> JobFuture
        self.t_last_frame = time.monotonic()
        self.reader: Optional[threading.Thread] = None
        self.writer: Optional[threading.Thread] = None

    # -- egress ---------------------------------------------------------
    def enqueue(self, frame, nbytes: int = 0) -> bool:
        """Queue a CONTROL frame (accept/reject/done/error/bye):
        always admitted — the taxonomy's never-silent rule — unless
        the connection is already dead."""
        with self.cv:
            if self.dead:
                return False
            self.out.append((frame, nbytes))
            self.out_bytes += nbytes
            self.cv.notify_all()
        return True

    def offer(self, frame, nbytes: int, timeout_s: float) -> bool:
        """Queue a STREAM chunk under the egress byte budget, waiting
        (bounded) for the writer to drain. False = the budget stayed
        full past the timeout (slow client) or the connection died."""
        deadline = time.monotonic() + timeout_s
        with self.cv:
            while not self.dead and self.out_bytes + nbytes \
                    > self.fd.egress_budget and self.out:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cv.wait(min(left, 0.2))
            if self.dead:
                return False
            self.out.append((frame, nbytes))
            self.out_bytes += nbytes
            self.cv.notify_all()
        return True

    def kill(self, why: str) -> None:
        """Drop this client for real: mark dead (enqueues become
        no-ops, blocked offers return), close the socket (both
        threads unblock), discard queued egress. In-flight jobs keep
        running — their futures belong to the scheduler, and a
        SIGKILLed client must never stall other tenants' work."""
        with self.cv:
            if self.dead:
                return
            self.dead = True
            self.out.clear()
            self.out_bytes = 0
            self.cv.notify_all()
        try:
            self.conn.close()
        except Exception:
            pass
        self.fd._conn_closed(self, why)

    def idle(self) -> bool:
        with self.cv:
            return not self.inflight and not self.out


class FrontDoor:
    """The TCP admission edge of one serving Context.

    ``FrontDoor(ctx, port=0)`` binds and starts accepting; ``.port``
    is the bound port (ephemeral when 0). Register pipelines with
    :meth:`register` before clients submit them. ``close()`` (or
    ``Context.close``) stops accepting, drains and tears down."""

    def __init__(self, ctx, port: Optional[int] = None,
                 host: str = "127.0.0.1") -> None:
        if ctx.net.num_workers > 1 or ctx.mesh_exec.num_processes > 1:
            raise RuntimeError(
                "FrontDoor is single-controller only: an external "
                "socket submits on one rank, violating the lockstep "
                "admission contract (see service/front_door.py)")
        self.ctx = ctx
        self.secret = wire.secret_from_env()
        self.read_timeout_s = _env_f(
            "THRILL_TPU_SERVE_READ_TIMEOUT_S", 60.0)
        self.write_timeout_s = _env_f(
            "THRILL_TPU_SERVE_WRITE_TIMEOUT_S", 10.0)
        self.drain_timeout_s = _env_f(
            "THRILL_TPU_SERVE_DRAIN_TIMEOUT_S", 30.0)
        self.chunk_bytes = max(
            4096, _env_i("THRILL_TPU_SERVE_CHUNK", 256 << 10))
        self.egress_budget = max(
            self.chunk_bytes,
            _env_i("THRILL_TPU_SERVE_EGRESS_BYTES", 8 << 20))
        self._pipelines: Dict[str, Callable] = {}
        self._conns: list = []
        self._lock = threading.Lock()
        self._draining = False
        self._closed = False
        self.drained = threading.Event()
        # resize verdict gate: while a Context.resize has REQUESTED
        # its dispatcher fence but the swap has not completed, no
        # admission verdict frame may be emitted — an accept sent in
        # that window would name a generation (and mesh W) the resize
        # is about to invalidate. Reader threads block on this gate at
        # the top of _handle_submit; Context.resize brackets its
        # fenced swap with begin/end (see that method).
        self._fence_cv = threading.Condition()
        self._fencing = 0
        # the fd_* counter row (Context.overall_stats merges stats(),
        # so the Prometheus endpoint exports these for free)
        self.conns_accepted = 0
        self.conns_dropped = 0
        self.jobs_submitted = 0
        self.jobs_rejected = 0
        self.chunks_sent = 0
        self.slow_clients = 0
        self.deadline_expired = 0
        if port is None:
            port = _env_i("THRILL_TPU_SERVE_PORT", 0)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(16)
        self._srv.settimeout(0.25)
        self.host = host
        self.port = self._srv.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="thrill-fd-accept",
            daemon=True)
        self._accept_thread.start()
        ctx.front_door = self
        log = ctx.logger
        if log.enabled:
            log.line(event="front_door_listen", host=host,
                     port=self.port,
                     authenticated=self.secret is not None)

    # -- registry -------------------------------------------------------
    def register(self, name: str, fn: Callable) -> None:
        """Register ``fn(ctx, args) -> result`` under ``name``. A
        GENERATOR function streams: each yielded item becomes its own
        chunk frame the moment the egress drains it — the client can
        consume results while the job is still running."""
        self._pipelines[str(name)] = fn

    def stats(self) -> dict:
        return {"fd_conns_accepted": self.conns_accepted,
                "fd_conns_dropped": self.conns_dropped,
                "fd_jobs_submitted": self.jobs_submitted,
                "fd_jobs_rejected": self.jobs_rejected,
                "fd_chunks_sent": self.chunks_sent,
                "fd_slow_clients": self.slow_clients,
                "fd_deadline_expired": self.deadline_expired}

    # -- accept side ----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed and not self._draining:
            try:
                sock, addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break                       # listener closed under us
            peer = f"{addr[0]}:{addr[1]}"
            try:
                faults.check(_F_ACCEPT, peer=peer)
            except faults.InjectedFault:
                # injected accept failure: the client sees EOF and its
                # bounded-retry policy redials — detection, not a hang
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            conn = TcpConnection(sock)
            c = _Conn(self, conn, peer)
            with self._lock:
                if self._draining or self._closed:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
                self.conns_accepted += 1
                self._conns.append(c)
            c.reader = threading.Thread(
                target=self._reader, args=(c,),
                name=f"thrill-fd-read-{peer}", daemon=True)
            c.writer = threading.Thread(
                target=self._writer, args=(c,),
                name=f"thrill-fd-write-{peer}", daemon=True)
            c.reader.start()
            c.writer.start()

    def _conn_closed(self, c: _Conn, why: str) -> None:
        with self._lock:
            if c in self._conns:
                self._conns.remove(c)
                self.conns_dropped += 1
        faults.note("recovery", what="front_door.conn_closed",
                    peer=c.peer, why=why)
        log = self.ctx.logger
        if log.enabled:
            log.line(event="front_door_conn_closed", peer=c.peer,
                     why=why)

    # -- reader ---------------------------------------------------------
    def _handshake(self, c: _Conn) -> bool:
        from ..common.timeouts import scaled
        conn = c.conn
        try:
            _exchange_auth_flag(conn, self.secret is not None)
            if self.secret is not None:
                conn.authenticate(self.secret, "server")
            frame = conn.recv_deadline(scaled(10.0))
            if not (isinstance(frame, (tuple, list)) and len(frame) == 2
                    and frame[0] == "hello"
                    and isinstance(frame[1], dict)):
                raise ConnectionError(f"bad hello {frame!r}")
            # version negotiation: a v2+ client offers [min, max], a
            # v1 client offers a single int (min == max). The server
            # picks the highest common version; no overlap is a TYPED
            # version_mismatch reject naming the supported range —
            # the client surfaces it as a permanent error, not a
            # redial-forever ConnectionError.
            offered = frame[1].get("proto", -1)
            try:
                if isinstance(offered, (list, tuple)) \
                        and len(offered) == 2:
                    cmin, cmax = int(offered[0]), int(offered[1])
                else:
                    cmin = cmax = int(offered)
            except (TypeError, ValueError):
                cmin = cmax = -1          # garbage: out of any range
            if cmin > cmax or cmax < PROTO_MIN or cmin > PROTO_MAX:
                c.enqueue(("reject", 0, "version_mismatch", 0.0,
                           f"server supports protocol "
                           f"[{PROTO_MIN},{PROTO_MAX}], client "
                           f"offered [{cmin},{cmax}]"))
                c.enqueue(("bye", "version mismatch"))
                return False
            c.proto = min(cmax, PROTO_MAX)
            c.tenant = str(frame[1].get("tenant") or "default")
            c.enqueue(("welcome", {"proto": c.proto,
                                   "range": [PROTO_MIN, PROTO_MAX]}))
            return True
        except (ConnectionError, OSError, CollectiveHangTimeout,
                wire.AuthError) as e:
            c.kill(f"handshake failed: {e!r}")
            return False

    def _reader(self, c: _Conn) -> None:
        if not self._handshake(c):
            return
        conn = c.conn
        while not c.dead and not self._closed:
            try:
                faults.check(F_CLIENT_DISCONNECT, peer=c.peer)
            except faults.InjectedFault:
                # the injected mid-stream client vanish: exactly what
                # a SIGKILLed client looks like from here
                c.kill("injected client disconnect")
                return
            try:
                frame = conn.recv_deadline(1.0)
            except CollectiveHangTimeout:
                if conn.broken:
                    # deadline fired MID-FRAME: a slow-loris client
                    # trickling bytes can never finish this frame —
                    # the link is condemned, drop it
                    self.slow_clients += 1
                    c.kill("slow-loris read (frame torn mid-read)")
                    return
                # between frames: just idle. A half-open client with
                # nothing in flight past the read timeout is dropped;
                # one with jobs running is kept (its results are
                # coming, the writer owns slow-drain detection).
                idle_s = time.monotonic() - c.t_last_frame
                if not c.inflight and idle_s > self.read_timeout_s:
                    c.enqueue(("bye", "idle timeout"))
                    # bounded courtesy: give the writer a moment to
                    # flush the bye, then drop
                    time.sleep(0.05)
                    c.kill("idle past read timeout (half-open)")
                    return
                continue
            except (ConnectionError, OSError, ValueError) as e:
                # ValueError: kill() closed the socket under this
                # blocked read (fileno() == -1 inside the poller)
                c.kill(f"client gone: {e!r}")
                return
            c.t_last_frame = time.monotonic()
            try:
                self._handle_frame(c, frame)
            except _Bye:
                c.kill("client bye")
                return

    def _handle_frame(self, c: _Conn, frame) -> None:
        if not isinstance(frame, (tuple, list)) or not frame:
            c.enqueue(("bye", f"bad frame {type(frame).__name__}"))
            raise _Bye()
        op = frame[0]
        if op == "bye":
            raise _Bye()
        if op == "submit" and len(frame) == 2 \
                and isinstance(frame[1], dict):
            self._handle_submit(c, frame[1])
            return
        c.enqueue(("bye", f"unknown frame {op!r}"))
        raise _Bye()

    def _handle_submit(self, c: _Conn, req: dict) -> None:
        jid = int(req.get("id", 0))
        name = str(req.get("pipeline") or "")
        tr = getattr(self.ctx, "tracer", None)
        # perf_counter, not monotonic: these stamps feed emit_span,
        # which places spans by perf_counter deltas (common/trace.py)
        t_accept = time.perf_counter()
        # elastic fence gate (regression: a queued-but-unaccepted job
        # during a resize): wait out any pending resize BEFORE any
        # verdict frame, so the accept below is stamped with the
        # post-resize generation and the job provably runs on the mesh
        # its accept named. No deadlock: this reader thread holds no
        # scheduler state, and the resize completes on the dispatcher
        # thread independently of it.
        with self._fence_cv:
            while self._fencing and not self._closed and not c.dead:
                self._fence_cv.wait(0.1)
        if self._draining:
            self._reject(c, jid, "draining",
                         round(self.drain_timeout_s, 3),
                         "front door is draining (SIGTERM): retry "
                         "against the relaunched service")
            return
        fn = self._pipelines.get(name)
        if fn is None:
            self._reject(c, jid, "unknown_pipeline", 0.0,
                         f"no pipeline registered under {name!r} "
                         f"(known: {sorted(self._pipelines)})")
            return
        deadline_s = req.get("deadline_s")
        deadline_at = (time.perf_counter() + float(deadline_s)
                       if deadline_s else None)
        args = req.get("args")
        import inspect
        streaming = inspect.isgeneratorfunction(fn)
        wrapper = self._make_job(c, jid, name, fn, args, deadline_at,
                                 t_accept, streaming)
        fut = self.ctx.submit(
            wrapper, tenant=c.tenant,
            name=f"fd-{c.tenant}-{jid}",
            weight=req.get("weight"))
        if fut.done():
            err = fut.exception(0)
            if isinstance(err, ShedLoad):
                self._reject(c, jid, err.kind, err.retry_after_s,
                             str(err))
                return
            if err is not None:
                self.jobs_rejected += 1
                c.enqueue(("error", jid, "submit", repr(err)[:300]))
                return
        self.jobs_submitted += 1
        with c.cv:
            c.inflight[jid] = fut
        # mode rides the accept so a client can decode items-mode
        # chunks AS THEY ARRIVE instead of waiting for the done frame;
        # v2 clients also get the generation the job will run under
        # (read AFTER the fence gate, so a concurrent resize can never
        # invalidate it)
        meta: Dict[str, Any] = {"mode": "items" if streaming
                                else "blob"}
        if c.proto >= 2:
            meta["gen"] = int(getattr(self.ctx, "generation", 0))
        c.enqueue(("accept", jid, meta))
        if tr is not None and tr.enabled:
            tr.emit_span("front_door", "admit", t_accept,
                         time.perf_counter(), tenant=c.tenant,
                         job=jid, pipeline=name)

    def _reject(self, c: _Conn, jid: int, kind: str,
                retry_after_s: float, msg: str) -> None:
        """One TYPED shed-load response — the never-silent contract:
        every rejection names its kind and when to retry."""
        self.jobs_rejected += 1
        c.enqueue(("reject", jid, kind, float(retry_after_s),
                   msg[:300]))
        log = self.ctx.logger
        if log.enabled:
            log.line(event="front_door_reject", peer=c.peer,
                     tenant=c.tenant, job=jid, kind=kind,
                     retry_after_s=retry_after_s)

    # -- the job wrapper (runs on the DISPATCHER) -----------------------
    def _make_job(self, c: _Conn, jid: int, name: str, fn: Callable,
                  args, deadline_at: Optional[float],
                  t_accept: float, streaming: bool) -> Callable:
        def job(ctx):
            t0 = time.perf_counter()
            if deadline_at is not None and t0 >= deadline_at:
                # queued past its deadline: a typed error frame, NOT a
                # pipeline abort — nothing ran, nothing needs healing
                self.deadline_expired += 1
                self._settle(c, jid, ("error", jid, "deadline",
                                      f"job spent {t0 - t_accept:.3f}s"
                                      f" queued, past its deadline"))
                return None
            try:
                if streaming:
                    out = self._stream_items(c, jid, fn, ctx, args)
                else:
                    out = self._stream_blob(c, jid, fn(ctx, args))
            except _StreamAborted:
                # the stream died (slow client / injected stream
                # fault) but the JOB is fine — typed error frame went
                # out already (or the conn is dead); nothing to heal
                return None
            except BaseException as e:
                # job failure: typed error frame BEFORE re-raising so
                # the scheduler's accounting (jobs_failed, heal) stays
                # truthful while the client still gets its verdict
                self._settle(c, jid, ("error", jid, "pipeline",
                                      repr(e)[:300]))
                raise
            self._settle(c, jid, None)
            tr = getattr(self.ctx, "tracer", None)
            if tr is not None and tr.enabled:
                tr.emit_span("front_door", f"stream:{name}", t0,
                             time.perf_counter(), tenant=c.tenant,
                             job=jid, chunks=out)
            return None

        return job

    def _settle(self, c: _Conn, jid: int, frame) -> None:
        if frame is not None:
            c.enqueue(frame)
        with c.cv:
            c.inflight.pop(jid, None)
            c.cv.notify_all()

    def _offer_chunk(self, c: _Conn, jid: int, seq: int,
                     payload: bytes) -> None:
        try:
            faults.check(_F_STREAM, job=jid, seq=seq)
        except faults.InjectedFault as e:
            # a torn result stream is a STREAM failure, not a job
            # failure: typed error frame, connection survives, the
            # scheduler never sees it (nothing to heal)
            self._settle(c, jid, ("error", jid, "stream",
                                  f"result stream aborted: {e}"))
            raise _StreamAborted()
        if not c.offer(("chunk", jid, seq, payload), len(payload),
                       self.write_timeout_s):
            if not c.dead:
                # egress stayed full past the write budget: the
                # client is alive but not draining — shed the
                # CONNECTION (typed verdict), keep the mesh moving
                self.slow_clients += 1
                faults.note("recovery",
                            what="front_door.slow_client_shed",
                            peer=c.peer, job=jid, seq=seq)
                c.kill("slow client: egress past write budget")
            raise _StreamAborted()
        self.chunks_sent += 1

    def _stream_blob(self, c: _Conn, jid: int, result) -> int:
        """Serialize once, stream in bounded chunks as the egress
        drains. Returns the chunk count."""
        try:
            payload = wire.dumps(_to_host(result),
                                 allow_pickle=c.conn.authenticated)
        except Exception as e:
            self._settle(c, jid, ("error", jid, "encode",
                                  f"result not wire-encodable: "
                                  f"{e!r}"[:300]))
            raise _StreamAborted()
        n = self.chunk_bytes
        chunks = [payload[i:i + n] for i in range(0, len(payload), n)] \
            or [b""]
        for seq, chunk in enumerate(chunks):
            self._offer_chunk(c, jid, seq, chunk)
        c.enqueue(("done", jid, len(chunks), {"mode": "blob"}))
        return len(chunks)

    def _stream_items(self, c: _Conn, jid: int, fn, ctx, args) -> int:
        """Generator pipelines: each yielded item is encoded and
        offered the moment it exists — the client consumes results
        while the job is still running."""
        seq = 0
        for item in fn(ctx, args):
            try:
                payload = wire.dumps(_to_host(item),
                                     allow_pickle=c.conn.authenticated)
            except Exception as e:
                self._settle(c, jid, ("error", jid, "encode",
                                      f"item {seq} not "
                                      f"wire-encodable: {e!r}"[:300]))
                raise _StreamAborted()
            self._offer_chunk(c, jid, seq, payload)
            seq += 1
        c.enqueue(("done", jid, seq, {"mode": "items"}))
        return seq

    # -- writer ---------------------------------------------------------
    def _writer(self, c: _Conn) -> None:
        conn = c.conn
        while True:
            with c.cv:
                while not c.out and not c.dead and not self._closed:
                    c.cv.wait(0.25)
                if c.dead or (self._closed and not c.out):
                    return
                frame, nbytes = c.out.popleft()
                c.out_bytes -= nbytes
                c.cv.notify_all()
            try:
                faults.check(_F_SLOW, peer=c.peer)
            except faults.InjectedFault:
                self.slow_clients += 1
                c.kill("injected slow client")
                return
            # WRITE deadline on every frame: a client that stopped
            # reading blocks at most write_timeout_s of this writer
            # thread (never the dispatcher), then gets dropped
            try:
                conn.send_bounded(frame, self.write_timeout_s)
            except TimeoutError:
                self.slow_clients += 1
                c.kill("slow client: frame write past deadline")
                return
            except (ConnectionError, OSError, ValueError) as e:
                c.kill(f"client write failed: {e!r}")
                return

    # -- resize verdict gate --------------------------------------------
    def begin_resize_fence(self) -> None:
        """Called by ``Context.resize`` BEFORE it requests the
        dispatcher fence: from here until :meth:`end_resize_fence`,
        no admission verdict frame leaves the front door (readers
        park at the gate in ``_handle_submit``). Re-entrant — nested
        resizes each count."""
        with self._fence_cv:
            self._fencing += 1

    def end_resize_fence(self) -> None:
        """Open the gate after the fenced swap completed (or failed —
        callers pair this in a ``finally``). Parked readers re-read
        ``ctx.generation`` after waking, so their accept frames carry
        the post-resize generation."""
        with self._fence_cv:
            self._fencing = max(0, self._fencing - 1)
            self._fence_cv.notify_all()

    # -- drain / close --------------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful drain: stop accepting, typed ``draining`` rejects
        for new submits, finish every in-flight job and flush its
        stream, then ``bye``. True = fully drained inside the budget;
        False = the budget expired and remaining clients were dropped
        (each with a loud note, never silently)."""
        timeout_s = (self.drain_timeout_s if timeout_s is None
                     else float(timeout_s))
        with self._lock:
            if self._draining:
                return self.drained.wait(timeout_s)
            self._draining = True
        log = self.ctx.logger
        if log.enabled:
            log.line(event="front_door_drain", timeout_s=timeout_s)
        try:
            self._srv.close()
        except OSError:
            pass
        deadline = time.monotonic() + timeout_s
        clean = True
        while True:
            with self._lock:
                live = list(self._conns)
            busy = [c for c in live if not c.idle()]
            if not busy:
                break
            if time.monotonic() >= deadline:
                clean = False
                for c in busy:
                    faults.note("recovery",
                                what="front_door.drain_expired",
                                peer=c.peer,
                                inflight=len(c.inflight))
                    c.kill("drain budget expired")
                break
            time.sleep(0.05)
        with self._lock:
            live = list(self._conns)
        for c in live:
            c.enqueue(("bye", "drained"))
        # bounded courtesy flush of the byes, then close
        t_end = time.monotonic() + 1.0
        while time.monotonic() < t_end and any(c.out for c in live):
            time.sleep(0.02)
        for c in live:
            c.kill("drained")
        self.drained.set()
        return clean

    def install_sigterm(self) -> None:
        """SIGTERM -> graceful drain on a background thread (signal
        handlers must not block); chains any previous handler."""
        import signal
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, sig_frame):
            threading.Thread(target=self.drain,
                             name="thrill-fd-drain",
                             daemon=True).start()
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, sig_frame)

        signal.signal(signal.SIGTERM, handler)

    def close(self, drain: bool = True) -> None:
        if self._closed:
            return
        if drain:
            self.drain()
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            live = list(self._conns)
        for c in live:
            c.kill("front door closed")
        if self.ctx.front_door is self:
            self.ctx.front_door = None


class _Bye(Exception):
    """Internal: client ended the session."""


class _StreamAborted(Exception):
    """Internal: this job's result stream died (slow client, injected
    stream fault, dead connection) — the job itself is fine."""


def maybe_start(ctx) -> Optional[FrontDoor]:
    """Start the front door when THRILL_TPU_SERVE_PORT names a port
    (mirrors common/metrics.py maybe_start). A bind failure is loud
    and degrades to no front door — the job itself must still run."""
    raw = os.environ.get("THRILL_TPU_SERVE_PORT", "")
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        import sys
        print(f"thrill_tpu: bad THRILL_TPU_SERVE_PORT={raw!r}; "
              f"front door disabled", file=sys.stderr)
        return None
    if port <= 0:
        return None
    try:
        return FrontDoor(ctx, port)
    except (OSError, RuntimeError) as e:
        import sys
        print(f"thrill_tpu: front door failed to start on port "
              f"{port}: {e}", file=sys.stderr)
        return None
