"""Client library for the front door (service/front_door.py;
counterpart of the reference package's ``service/client.py``).

A thin, dependency-free peer of the server's admission protocol:
dial, mutual-HMAC authenticate when a secret is set, ``hello`` /
``welcome``, then submit named pipelines and consume streamed result
chunks. The client is built for an OVERLOADED or RESTARTING server —
the regimes the front door is designed around:

* connect runs under the shared bounded full-jitter
  :class:`~thrill_tpu_torch.common.retry.RetryPolicy` (a restarting server
  is a transient, not an error);
* a typed ``reject`` raises :class:`Rejected` carrying the server's
  ``kind`` and ``retry_after_s`` hint — :meth:`FrontDoorClient
  .submit_retry` honors the hint: it sleeps the MAX of the server's
  hint and its own full-jitter delay, so a fleet of shed clients
  neither hammers the server early nor thundering-herds on the same
  beat (the jitter half) nor returns before the queue could have
  drained (the hint half);
* chunks are consumable AS THEY ARRIVE (:meth:`RemoteJob.chunks`) —
  an items-mode pipeline streams results while the job is still
  running server-side.

Threading: one reader thread per client demultiplexes frames to
:class:`RemoteJob` objects by id; ``submit`` only writes. All public
methods are thread-safe.
"""

from __future__ import annotations

import itertools
import random
import socket
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional

from ..common.retry import default_policy
from ..net import wire
from ..net.tcp import TcpConnection, _exchange_auth_flag
from .front_door import PROTO_MAX, PROTO_MIN, PROTO_VERSION


class Rejected(RuntimeError):
    """The server shed this submit — typed, with a retry-after hint."""

    def __init__(self, kind: str, retry_after_s: float,
                 msg: str) -> None:
        super().__init__(f"rejected ({kind}, retry after "
                         f"{retry_after_s:.3f}s): {msg}")
        self.kind = kind
        self.retry_after_s = float(retry_after_s)


class VersionMismatch(RuntimeError):
    """The server speaks no protocol version in this client's range —
    PERMANENT by construction (a plain RuntimeError subclass, so the
    connect retry policy surfaces it immediately instead of redialing
    a server that will refuse forever). Carries the server's
    supported range parsed from the typed reject."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"protocol version mismatch: {msg} "
                         f"(this client speaks "
                         f"[{PROTO_MIN},{PROTO_MAX}])")


class RemoteJobError(RuntimeError):
    """The job was accepted but failed server-side (``error`` frame:
    pipeline exception, missed deadline, torn result stream)."""

    def __init__(self, kind: str, msg: str) -> None:
        super().__init__(f"remote job failed ({kind}): {msg}")
        self.kind = kind


class RemoteJob:
    """One in-flight submit: resolves to chunks then a terminal frame.

    ``result(timeout)`` blocks for the whole result; ``chunks()``
    yields decoded chunks as they arrive (items mode: one result item
    per chunk, usable mid-job). Terminal failures raise their typed
    exception from either method."""

    def __init__(self, jid: int) -> None:
        self.id = jid
        self.mode = "blob"
        # v2 servers stamp the accept with the mesh generation the
        # job runs under (None from v1 servers) — the elastic-fence
        # regression test pins that a resize can never invalidate it
        self.generation: Optional[int] = None
        self._chunks: deque = deque()
        self._raw: list = []
        self._cv = threading.Condition()
        self._accepted = False
        self._done = False
        self._exc: Optional[BaseException] = None

    # -- reader side ----------------------------------------------------
    def _on_accept(self, meta: dict) -> None:
        with self._cv:
            self._accepted = True
            self.mode = str(meta.get("mode", "blob"))
            gen = meta.get("gen")
            self.generation = int(gen) if gen is not None else None
            self._cv.notify_all()

    def _on_chunk(self, payload: bytes) -> None:
        with self._cv:
            self._raw.append(payload)
            self._chunks.append(payload)
            self._cv.notify_all()

    def _finish(self, exc: Optional[BaseException]) -> None:
        with self._cv:
            if self._done:
                return
            self._done = True
            self._exc = exc
            self._cv.notify_all()

    # -- consumer side --------------------------------------------------
    def wait_accepted(self, timeout: Optional[float] = None) -> None:
        """Block until the admission verdict: returns on ``accept``,
        raises :class:`Rejected` on ``reject`` (TimeoutError if the
        server answered neither in time)."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._cv:
            while not self._accepted and not self._done:
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"no admission verdict for job {self.id}")
                self._cv.wait(left if left is not None else 1.0)
            if self._done and self._exc is not None:
                raise self._exc

    def chunks(self, timeout: Optional[float] = None
               ) -> Iterator[Any]:
        """Yield decoded chunks as they arrive (items mode: each is
        one result item). ``timeout`` bounds the wait per chunk."""
        seen = 0
        while True:
            with self._cv:
                deadline = None if timeout is None else \
                    time.monotonic() + timeout
                while not self._chunks and not self._done:
                    left = None if deadline is None else \
                        deadline - time.monotonic()
                    if left is not None and left <= 0:
                        raise TimeoutError(
                            f"no chunk for job {self.id} after "
                            f"{timeout}s (server slow or stream "
                            f"wedged)")
                    self._cv.wait(left if left is not None else 1.0)
                if self._chunks:
                    payload = self._chunks.popleft()
                elif self._exc is not None:
                    raise self._exc
                else:
                    return
            # decode OUTSIDE the lock; blob-mode chunks are raw
            # slices of one encoded payload — yield bytes, result()
            # does the join+decode
            yield wire.loads(payload) if self.mode == "items" \
                else payload
            seen += 1

    def result(self, timeout: Optional[float] = None) -> Any:
        """The whole result: blob mode decodes the reassembled
        payload; items mode returns the list of items."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._cv:
            while not self._done:
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"job {self.id} not done after {timeout}s")
                self._cv.wait(left if left is not None else 1.0)
            if self._exc is not None:
                raise self._exc
            raw = list(self._raw)
        if self.mode == "items":
            return [wire.loads(p) for p in raw]
        return wire.loads(b"".join(raw))


class FrontDoorClient:
    """One authenticated connection to a front door.

    ``secret`` defaults to ``THRILL_TPU_SECRET`` (the same env the
    server and every mesh link read); pass ``secret=None`` explicitly
    AND unset the env for an unauthenticated dev connection."""

    def __init__(self, host: str, port: int, tenant: str = "default",
                 secret: Optional[bytes] = None,
                 connect_timeout_s: float = 10.0) -> None:
        self.tenant = str(tenant)
        self.secret = secret if secret is not None \
            else wire.secret_from_env()
        self._ids = itertools.count(1)
        self._jobs: dict = {}
        self._lock = threading.Lock()
        self._closed = False
        self._conn_lost: Optional[BaseException] = None
        self._bye_reason: Optional[str] = None
        # filled by the handshake: the negotiated protocol version and
        # the server's advertised [min, max]
        self.proto = PROTO_VERSION
        self.server_range = (PROTO_VERSION, PROTO_VERSION)

        def dial() -> TcpConnection:
            sock = socket.create_connection(
                (host, int(port)), timeout=connect_timeout_s)
            sock.settimeout(None)
            conn = TcpConnection(sock)
            try:
                _exchange_auth_flag(conn, self.secret is not None)
                if self.secret is not None:
                    conn.authenticate(self.secret, "client")
                # v2 hello: offer the whole range. A v1 server reads
                # the field with int() and rejects the list with its
                # "proto mismatch" bye — falling back to a plain int
                # there is not needed in-tree (server and client ship
                # together); cross-version cover is the v2 server
                # accepting v1 clients' single-int hellos.
                conn.send(("hello", {"tenant": self.tenant,
                                     "proto": [PROTO_MIN, PROTO_MAX]}))
                frame = conn.recv_deadline(connect_timeout_s)
            except BaseException:
                conn.close()
                raise
            if (isinstance(frame, (tuple, list)) and len(frame) >= 5
                    and frame[0] == "reject"
                    and frame[2] == "version_mismatch"):
                conn.close()
                raise VersionMismatch(str(frame[4]))
            if not (isinstance(frame, (tuple, list)) and frame
                    and frame[0] == "welcome"):
                conn.close()
                raise ConnectionError(
                    f"front door refused handshake: {frame!r}")
            # negotiated version + server range (v1 servers send just
            # {"proto": 1}: range degrades to [proto, proto])
            meta = frame[1] if len(frame) > 1 \
                and isinstance(frame[1], dict) else {}
            self.proto = int(meta.get("proto", PROTO_VERSION))
            rng = meta.get("range") or [self.proto, self.proto]
            self.server_range = (int(rng[0]), int(rng[1]))
            return conn

        # a restarting / briefly-saturated server is a transient:
        # bounded full-jitter redial, permanent errors (AuthError)
        # surface immediately
        self.conn = default_policy().run(
            dial, what=f"front_door.connect:{host}:{port}")
        self._reader = threading.Thread(
            target=self._read_loop, name="thrill-fd-client-read",
            daemon=True)
        self._reader.start()

    # -- reader ---------------------------------------------------------
    def _read_loop(self) -> None:
        while not self._closed:
            try:
                frame = self.conn.recv()
            except (ConnectionError, OSError, EOFError,
                    ValueError) as e:
                # ValueError: close() tore the socket under this
                # blocked recv (fileno() == -1 inside the poller)
                self._fail_all(ConnectionError(
                    f"front door connection lost: {e!r}"
                    if self._bye_reason is None else
                    f"front door said bye: {self._bye_reason}"))
                return
            try:
                self._dispatch(frame)
            except _ServerBye:
                self._fail_all(ConnectionError(
                    f"front door said bye: {self._bye_reason}"))
                return

    def _dispatch(self, frame) -> None:
        if not isinstance(frame, (tuple, list)) or not frame:
            return
        op = frame[0]
        if op == "bye":
            self._bye_reason = frame[1] if len(frame) > 1 else ""
            raise _ServerBye()
        if len(frame) < 2:
            return
        job = self._jobs.get(frame[1])
        if job is None:
            return
        if op == "accept":
            job._on_accept(frame[2] if len(frame) > 2 else {})
        elif op == "reject":
            _, _, kind, retry_after_s, msg = frame
            job._finish(Rejected(kind, retry_after_s, msg))
        elif op == "chunk":
            job._on_chunk(frame[3])
        elif op == "done":
            job._finish(None)
        elif op == "error":
            job._finish(RemoteJobError(frame[2], frame[3]))

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            self._conn_lost = exc
            jobs = list(self._jobs.values())
            self._jobs.clear()
        for job in jobs:
            job._finish(exc)

    # -- submit side ----------------------------------------------------
    def submit(self, pipeline: str, args: Any = None,
               deadline_s: Optional[float] = None,
               weight: Optional[float] = None) -> RemoteJob:
        """Submit a named pipeline; returns immediately with a
        :class:`RemoteJob` (the admission verdict arrives async —
        ``wait_accepted()`` / ``result()`` surface a ``reject`` as
        :class:`Rejected`)."""
        if self._closed:
            raise ConnectionError("client is closed")
        jid = next(self._ids)
        job = RemoteJob(jid)
        with self._lock:
            # fail FAST after a lost connection: a submit racing the
            # reader's _fail_all would otherwise never resolve
            if self._conn_lost is not None:
                raise ConnectionError(
                    f"no connection: {self._conn_lost}") \
                    from self._conn_lost
            self._jobs[jid] = job
        req = {"id": jid, "pipeline": str(pipeline), "args": args}
        if deadline_s is not None:
            req["deadline_s"] = float(deadline_s)
        if weight is not None:
            req["weight"] = float(weight)
        try:
            self.conn.send(("submit", req))
        except (ConnectionError, OSError) as e:
            with self._lock:
                self._jobs.pop(jid, None)
            raise ConnectionError(f"submit failed: {e!r}") from e
        return job

    def submit_retry(self, pipeline: str, args: Any = None,
                     deadline_s: Optional[float] = None,
                     attempts: int = 6,
                     verdict_timeout_s: float = 30.0,
                     seed: Optional[int] = None) -> RemoteJob:
        """Submit, retrying TYPED sheds until accepted or the attempt
        budget runs out. Sleeps ``max(server retry-after hint,
        full-jitter backoff)`` between tries — the hint keeps retries
        out of a window the server PROMISED is full, the jitter keeps
        a fleet of shed clients from herding back on one beat. The
        last :class:`Rejected` re-raises unchanged."""
        policy = default_policy()
        rng = random.Random(seed)
        last: Optional[Rejected] = None
        for attempt in range(max(1, int(attempts))):
            job = self.submit(pipeline, args, deadline_s=deadline_s)
            try:
                job.wait_accepted(verdict_timeout_s)
                return job
            except Rejected as e:
                last = e
                time.sleep(max(e.retry_after_s,
                               policy.delay(attempt, rng)))
        assert last is not None
        raise last

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.conn.send(("bye",))
        except (ConnectionError, OSError):
            pass
        try:
            self.conn.close()
        except Exception:
            pass
        self._fail_all(ConnectionError("client closed"))

    def __enter__(self) -> "FrontDoorClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _ServerBye(Exception):
    """Internal: the server ended the session."""
