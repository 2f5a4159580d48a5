"""MPI transport backend: control plane and byte-frame data plane
(counterpart of the reference package's ``net/mpi.py``; Thrill:
thrill/net/mpi/group.cpp:26,654-660 and net/mpi/dispatcher.cpp:67).
``THRILL_TPU_NET=mpi`` makes it the host group of a mesh of several
processes (``api/context.py``). Three disciplines:

* **Serialized threading**: Thrill initializes ``MPI_THREAD_SERIALIZED``
  and guards every MPI call with one global mutex; here ``_MPI_LOCK``
  wraps each mpi4py call the same way, so any number of threads can
  share the library.

* **No blocking in send**: messages above MPI's eager threshold
  complete their Isend only when the matching receive posts
  (rendezvous), and the group's collectives (net/group.py) and the
  multiplexer's host exchange have every rank send before it receives,
  so a send that waited for its Isend would deadlock the world. ``send``
  queues the request on a per-world engine and returns; pending Isends
  complete lazily, tested in ``recv``'s Iprobe loop, at the next send,
  by a progress thread, and exhaustively in ``flush``, as Thrill's MPI
  dispatcher parks Isend requests and polls ``MPI_Testsome``. The
  engine's in-flight byte count past its cap makes send() reap while
  completions arrive, never wait: the bound is structural (each group
  queues at most one exchange's outgoing frames).

* **Byte frames**: payloads travel as raw bytes over ``Isend``/``Irecv``
  with ``MPI.BYTE``, framed by the non-executing wire codec
  (net/wire.py), the frames the TCP plane ships. Pickle inside the codec
  is allowed: MPI ranks are instances of one program launched together
  by ``mpirun``, the trust model Thrill assumes for its MPI world.

Groups share ``COMM_WORLD`` as tag namespaces (the group's tag is the
MPI message tag), as Thrill multiplexes its groups over one world (flow
group 0, data group 1).

mpi4py is imported inside ``construct()`` only, which raises the fix
(install mpi4py and launch under ``mpirun``, or ``THRILL_TPU_NET=tcp``)
where it is missing, unless an MPI module was injected into ``MPI``:
the tests inject a socket-backed fake world whose every message is a
rendezvous and run real processes over it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional

from . import wire
from .group import Connection, Group

#: serialized-MPI discipline: one lock around every MPI call (and the
#: engine's queue, which is only touched around MPI calls anyway)
_MPI_LOCK = threading.Lock()

#: injection point — tests (or embedders) may set this to an object
#: exposing the mpi4py.MPI surface used here (COMM_WORLD, Isend, Irecv,
#: Iprobe, Status, BYTE, ...)
MPI: Optional[Any] = None


class MpiUnavailable(RuntimeError):
    pass


def _load_mpi():
    global MPI
    if MPI is not None:
        return MPI
    try:
        from mpi4py import MPI as _mpi  # type: ignore
    except ImportError as e:
        raise MpiUnavailable(
            "MPI backend requires mpi4py, which is not installed. "
            "Install mpi4py and launch with "
            "`mpirun -np <P> python your_program.py`, or set "
            "THRILL_TPU_NET=tcp to use the built-in TCP backend "
            "(Thrill: thrill/net/mpi/group.cpp)") from e
    # Thrill demands at least MPI_THREAD_SERIALIZED
    if hasattr(_mpi, "Query_thread") and \
            _mpi.Query_thread() < _mpi.THREAD_SERIALIZED:
        raise MpiUnavailable(
            "MPI library initialized below MPI_THREAD_SERIALIZED; the "
            "framework's serialized-call discipline needs it "
            "(Thrill: MPI_Init_thread, net/mpi/group.cpp:26)")
    MPI = _mpi
    return MPI


def _req_done(req) -> bool:
    """Poll a request once, normalizing the two mpi4py shapes:
    uppercase Test() -> bool and lowercase test() -> (flag, msg)."""
    res = req.Test() if hasattr(req, "Test") else req.test()
    return res[0] if isinstance(res, tuple) else bool(res)


class _SendEngine:
    """Per-world ledger of in-flight Isend requests.

    Keeps (request, payload) pairs alive until MPI reports completion —
    the payload buffer must outlive the Isend (MPI reads it lazily
    during rendezvous). ``reap_locked`` is called from every send and
    every recv poll (caller holds ``_MPI_LOCK``); ``flush`` completes
    everything and is the only place allowed to wait, because at flush
    points (group close / explicit barrier) every queued message's
    matching receive is already posted or will be without our help.
    """

    #: drain-accelerator threshold (bytes), NOT a hard memory bound:
    #: over this, send() keeps reaping while completions arrive, but
    #: never blocks without progress (see module docstring — the hard
    #: bound is the caller's per-phase send volume)
    CAP_BYTES = 32 << 20

    #: async-progress poll period. Lazy reaping alone starves rendezvous
    #: completion when the owning thread blocks outside the transport
    #: with an isend still pending (inside a device collective of
    #: ``torch.distributed``, where no recv poll runs while the peer
    #: waits for this rank's data). Real MPI deployments run an async
    #: progress thread for this; ours honors the serialized-call lock.
    PROGRESS_POLL_S = 2e-3

    def __init__(self) -> None:
        self.pending: collections.deque = collections.deque()
        self.pending_bytes = 0
        self._progress_wake = threading.Event()
        self._progress_thread: Optional[threading.Thread] = None

    def note_send_locked(self, req, payload) -> None:
        self.pending.append((req, payload))
        self.pending_bytes += len(payload)
        if self._progress_thread is None:
            self._progress_thread = threading.Thread(
                target=self._progress_loop,
                name="thrill-tpu-torch-mpi-progress", daemon=True)
            self._progress_thread.start()
        self._progress_wake.set()

    def _progress_loop(self) -> None:
        """Daemon: complete pending isends while the app threads are
        parked elsewhere. Parks itself (Event) whenever the pending set
        drains, so an idle world costs nothing. MUST outlive transport
        errors: a raising request was already dropped by reap_locked,
        so note it and keep pumping — a dead daemon would silently
        reinstate the rendezvous-starvation wedge, and the app threads
        surface the peer failure through their own sends/recvs."""
        while True:
            self._progress_wake.wait()
            try:
                with _MPI_LOCK:
                    self.reap_locked()
                    if not self.pending:
                        self._progress_wake.clear()
            except Exception as e:
                import sys
                print(f"thrill_tpu_torch.net.mpi: async progress dropped a "
                      f"failing isend ({e!r}); the peer error will "
                      f"surface on the owning thread's next transport "
                      f"call", file=sys.stderr)
            time.sleep(self.PROGRESS_POLL_S)

    def reap_locked(self) -> int:
        """One non-blocking pass over pending isends; returns how many
        completed (and were dropped). A request whose Test RAISES is
        dropped with its byte account settled before the error
        propagates — a dead peer's send must not inflate
        ``pending_bytes`` forever."""
        done = 0
        for _ in range(len(self.pending)):
            req, payload = self.pending.popleft()
            try:
                ok = _req_done(req)
            except Exception:
                self.pending_bytes -= len(payload)
                raise
            if ok:
                self.pending_bytes -= len(payload)
                done += 1
            else:
                self.pending.append((req, payload))
        return done

    def enforce_cap(self) -> None:
        """Reap while over the cap AND completions keep arriving. Stops
        at the first no-progress pass — never a liveness hazard."""
        while True:
            with _MPI_LOCK:
                if self.pending_bytes <= self.CAP_BYTES:
                    return
                if self.reap_locked() == 0:
                    return

    def flush(self, timeout_s: float | None = None) -> None:
        """Complete every pending isend (group close / barrier point).

        The deadline is a DIAGNOSTIC for a vanished peer, not flow
        control — real MPI_Waitall blocks forever here — so it scales
        with machine load (common/timeouts.py): a peer that is merely
        slow under contention must not read as dead."""
        from ..common.timeouts import budget_fn
        # RE-evaluated each poll when defaulted (cadence-limited
        # loadavg read): a load spike arriving near the distress point
        # must stretch an already-started wait, not just future ones
        budget = budget_fn(timeout_s, 120.0)
        start = time.monotonic()
        while True:
            with _MPI_LOCK:
                self.reap_locked()
                if not self.pending:
                    return
            b = budget()
            if time.monotonic() - start > b:
                raise TimeoutError(
                    f"MPI flush: {len(self.pending)} isends still "
                    f"pending after {b:.0f}s (peer gone or "
                    f"matching recv never posted)")
            time.sleep(MpiConnection.POLL_S)


class MpiConnection(Connection):
    """One peer within one group (tag namespace)."""

    # poll interval for the Iprobe spin; Thrill's dispatcher
    # polls Testsome in a loop the same way (net/mpi/dispatcher.cpp:67)
    POLL_S = 50e-6

    def __init__(self, mpi, comm, peer: int, tag: int,
                 engine: _SendEngine) -> None:
        self.mpi = mpi
        self.comm = comm
        self.peer = peer
        self.tag = tag
        self.engine = engine

    def send(self, obj: Any) -> int:
        """Queue the framed payload as an Isend and RETURN the
        serialized byte count (the wire truth, measured where the
        frame is encoded — the multiplexer's accounting reads it
        instead of paying a second serialization) — completion is lazy
        (engine reaps in recv polls / flush). See module docstring for
        why waiting here deadlocks rendezvous MPI."""
        payload = wire.dumps(obj, allow_pickle=True)
        with _MPI_LOCK:
            req = self.comm.Isend([payload, self.mpi.BYTE],
                                  dest=self.peer, tag=self.tag)
            self.engine.note_send_locked(req, payload)
            self.engine.reap_locked()
        self.engine.enforce_cap()
        return len(payload)

    def recv(self) -> Any:
        """Iprobe poll -> sized Irecv -> Test poll; every poll iteration
        also reaps pending isends (their lazy completion point)."""
        st = self.mpi.Status()
        while True:
            with _MPI_LOCK:
                self.engine.reap_locked()
                if self.comm.Iprobe(source=self.peer, tag=self.tag,
                                    status=st):
                    n = st.Get_count(self.mpi.BYTE)
                    buf = bytearray(n)
                    rreq = self.comm.Irecv([buf, self.mpi.BYTE],
                                           source=self.peer,
                                           tag=self.tag)
                    break
            time.sleep(self.POLL_S)
        while True:
            with _MPI_LOCK:
                self.engine.reap_locked()
                done = _req_done(rreq)
            if done:
                return wire.loads(bytes(buf), allow_pickle=True)
            time.sleep(self.POLL_S)


class MpiGroup(Group):
    """A tag namespace over an MPI communicator."""

    def __init__(self, mpi, comm, group_tag: int = 0,
                 engine: Optional[_SendEngine] = None) -> None:
        with _MPI_LOCK:
            rank = comm.Get_rank()
            size = comm.Get_size()
        super().__init__(rank, size)
        self.mpi = mpi
        self.comm = comm
        self.group_tag = group_tag
        self.engine = engine if engine is not None else _SendEngine()
        self._conns = {}

    def connection(self, peer: int) -> MpiConnection:
        if peer == self.my_rank or not 0 <= peer < self.num_hosts:
            raise ValueError(f"bad peer {peer} (rank {self.my_rank} "
                             f"of {self.num_hosts})")
        conn = self._conns.get(peer)
        if conn is None:
            conn = self._conns[peer] = MpiConnection(
                self.mpi, self.comm, peer, self.group_tag, self.engine)
        return conn

    def flush(self) -> None:
        """Complete all pending isends issued through this group's
        world engine (safe wherever every sent message's receive is
        guaranteed — barriers, teardown)."""
        self.engine.flush()

    def close(self) -> None:
        self.flush()


def construct(group_count: int = 2) -> List[MpiGroup]:
    """kGroupCount tag-namespace groups over COMM_WORLD (Thrill:
    flow group 0 + data group 1, net/manager.hpp:61-92). All groups of
    one world share one send engine — pending isends are a per-world
    resource, like the request table of Thrill's dispatcher."""
    mpi = _load_mpi()
    engine = _SendEngine()
    return [MpiGroup(mpi, mpi.COMM_WORLD, group_tag=g, engine=engine)
            for g in range(group_count)]


def available() -> bool:
    try:
        _load_mpi()
        return True
    except MpiUnavailable:
        return False
