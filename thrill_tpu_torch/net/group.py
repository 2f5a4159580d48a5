"""Abstract point-to-point group and generic collective algorithms
(counterpart of the reference package's ``net/group.py``).

Equivalent of the reference's net::Group / net::Connection and the
templated collectives implemented generically over connections
(reference: thrill/net/group.hpp:47, net/connection.hpp:49,
net/collective.hpp:52-579): dissemination prefix-sum, binomial-tree
broadcast, recursive-doubling all-gather and hypercube all-reduce, over
any transport (mock in-process queues, TCP across processes).

These host-level collectives form the *control plane*: small values,
blocking semantics. The bulk data plane of a mesh of several processes
is ``torch.distributed`` inside the device programs
(``parallel/mesh.py``); this layer coordinates the Python controllers
around them (scalar agreement, the host-storage multiplexer's frames,
barriers, the abort protocol).

Failure domains and elastic membership: ``begin_generation`` settles a
new generation after a pipeline abort (drains every channel up to the
peers' barrier markers, repairs dropped links), ``resize`` grows or
shrinks the membership at a generation boundary, ``prepare_relaunch``
is the relaunch gate of a process-level resize.
"""

from __future__ import annotations

import abc
import contextlib
import operator
import os
import time
from typing import Any, Callable, List, Optional

from ..common import faults


#: magic key of a poison control frame (a plain dict so it passes the
#: non-executing wire codec unauthenticated)
POISON_KEY = "__thrill_tpu_poison__"

#: magic key of a heartbeat frame (net/heartbeat.py): liveness chatter
#: multiplexed over the same connections — transports discard it before
#: it can reach a collective's payload stream
HEARTBEAT_KEY = "__thrill_tpu_hb__"

#: magic key of a generation-barrier control frame: the marker a
#: healing rank sends each peer when it enters a new failure domain
#: (Context generation). Everything queued BEFORE the marker on the
#: ordered channel belongs to the aborted generation and is drained;
#: the marker itself is the "fresh-generation barrier"
GENERATION_KEY = "__thrill_tpu_gen__"

#: injectable hang: an armed fire at this site makes the next blocking
#: collective recv behave as if its deadline expired with no frame —
#: the watchdog's abort path runs for real, no actual wedged peer needed
_F_HANG = faults.declare("net.group.recv_hang")

#: injectable generation replay: an armed fire makes the next recv see
#: a PRIOR-generation poison frame first (as if a stale frame from an
#: aborted pipeline were still in flight) — the generation filter must
#: drop it and the collective must still complete
_F_STALE = faults.declare("net.group.stale_frame")


#: latency-injection site at every host-collective entry. Checked as
#: the PER-RANK name ``net.group.delay.r<rank>`` so a delay arm
#: (``net.group.delay.r1:delay=50ms:n=0``) slows exactly one rank —
#: the deterministic straggler the doctor's wait attribution pins
#: (common/doctor.py). Armed WITHOUT ``delay=`` it raises at
#: collective entry like any site (nothing sent yet — a clean abort).
_F_DELAY = faults.declare("net.group.delay")

#: elastic-mesh resize handshake (Group.resize / tcp.join_tcp_group):
#: fired before any membership mutation, so an injected failure leaves
#: the old membership intact — the generation settles among the
#: survivors and the NEXT resize attempt starts from a clean group
F_RESIZE = faults.declare("net.group.resize_handshake",
                          exc=faults.InjectedConnectionError)

#: orchestrated process-level relaunch (Context.resize_processes):
#: fired at the relaunch GATE — after the RESIZE epoch sealed, before
#: the resize marker commits and before any membership drains — so an
#: injected failure aborts the whole move with the old-W group fully
#: intact (the sealed W' epoch is inert: an old-W resume rejects it by
#: the workers gate) and a clean retry re-runs the identical move
F_RELAUNCH = faults.declare("net.group.relaunch",
                            exc=faults.InjectedConnectionError)


def resize_enabled() -> bool:
    """Elastic membership changes are on by default;
    ``THRILL_TPU_RESIZE=0`` pins W for the process lifetime (a caller
    asking anyway gets a loud RuntimeError, never a silent no-op)."""
    return os.environ.get("THRILL_TPU_RESIZE", "1") != "0"


def resize_timeout_s() -> float:
    """Budget for one membership change (join handshakes + the
    generation barrier on the new membership):
    ``THRILL_TPU_RESIZE_TIMEOUT_S``, default = the heal budget. Like
    the heal it MUST be bounded — waiting forever on a joiner that
    died mid-handshake is a hang, not patience."""
    v = os.environ.get("THRILL_TPU_RESIZE_TIMEOUT_S", "")
    try:
        t = float(v)
    except ValueError:
        return heal_timeout_s()
    return t if t > 0 else heal_timeout_s()




class CollectiveHangTimeout(TimeoutError):
    """A blocking collective recv exceeded THRILL_TPU_HANG_TIMEOUT_S
    with no frame from the peer: the collective is wedged. Raised by
    transports (tcp/mock); the Group watchdog converts it into a
    ClusterAbort naming the collective and the silent peer rank."""


def hang_timeout_s() -> Optional[float]:
    """Collective-recv watchdog deadline (None = watchdog off — the
    default: a healthy slow peer must never be declared hung unless
    the operator opted into a bound)."""
    v = os.environ.get("THRILL_TPU_HANG_TIMEOUT_S", "")
    try:
        t = float(v)
    except ValueError:
        return None
    return t if t > 0 else None


def heal_timeout_s() -> float:
    """Budget for one generation heal (barrier drain + reconnects):
    THRILL_TPU_HEAL_TIMEOUT_S, default 30s. Past it the heal itself
    fails and the abort escalates to the unrecoverable path. Unlike
    the watchdog knob, the heal MUST be bounded (an unbounded barrier
    against a dead peer is a hang) — a non-positive value is refused
    loudly and the default applies."""
    v = os.environ.get("THRILL_TPU_HEAL_TIMEOUT_S", "")
    try:
        t = float(v)
    except ValueError:
        return 30.0
    if t <= 0:
        global _WARNED_HEAL_TIMEOUT
        if not _WARNED_HEAL_TIMEOUT:
            _WARNED_HEAL_TIMEOUT = True
            import sys
            print("thrill_tpu_torch.net: THRILL_TPU_HEAL_TIMEOUT_S must be "
                  "> 0 (the heal cannot be unbounded); using the "
                  "default 30s", file=sys.stderr)
        return 30.0
    return t


_WARNED_HEAL_TIMEOUT = False


class ClusterAbort(ConnectionError):
    """A peer broadcast a poison frame: its ROOT CAUSE, not a local
    secondary symptom. ConnectionError subclass so existing dead-peer
    handling (tests, cleanup paths) treats an abort as fatal transport
    loss — but the retry policy classifies it permanent (never retry
    a coordinated shutdown).

    ``generation`` scopes the abort to one pipeline run (Context
    failure domain); ``recoverable`` distinguishes pipeline-scoped
    verdicts (poison, hung collective, dropped link — the Context can
    heal and serve the next pipeline) from process-death verdicts
    (heartbeat-confirmed dead peer — only a supervised relaunch +
    resume recovers those)."""

    def __init__(self, origin: int, cause: str, generation: int = -1,
                 recoverable: bool = True) -> None:
        super().__init__(
            f"cluster abort from rank {origin}: {cause}")
        self.origin = origin
        self.cause = cause
        self.generation = generation
        self.recoverable = recoverable


class Connection(abc.ABC):
    """Reliable ordered duplex message channel to one peer."""

    @abc.abstractmethod
    def send(self, obj: Any) -> Optional[int]:
        """Send one message. Transports that serialize the payload
        return the serialized byte count (the wire truth, measured
        ONCE where the frame is encoded — data/multiplexer.py's
        byte accounting reads it instead of re-serializing); queue
        transports that pass objects by reference return None."""

    @abc.abstractmethod
    def recv(self) -> Any: ...

    def recv_deadline(self, deadline_s: float) -> Any:
        """Receive one message, raising :class:`CollectiveHangTimeout`
        after ``deadline_s`` with no complete frame. Transports without
        timed receives fall back to a plain blocking recv (the watchdog
        then covers only transports that implement it)."""
        return self.recv()

    def send_bounded(self, obj: Any, deadline_s: float) -> None:
        """Send with a bounded blocking time, raising TimeoutError on
        expiry. Used by the abort protocol: poisoning a peer whose
        socket buffer is full must not hang the aborting worker. The
        default delegates to plain send (queue-backed transports never
        block)."""
        self.send(obj)


class Group(abc.ABC):
    """A p-way clique of connections; my_rank in [0, num_hosts)."""

    def __init__(self, my_rank: int, num_hosts: int) -> None:
        self.my_rank = my_rank
        self._num_hosts = num_hosts
        # poison frames relay AT MOST ONCE per (origin, cause)
        # (transitivity without ping-pong, while a LATER unrelated
        # abort on a surviving group still relays): keys added by
        # poison_peers and by received poison frames
        self._poison_relayed: set = set()
        # failure detector state: which collective the caller is inside
        # (named in hang-abort causes), last heartbeat seen per peer,
        # and an abort latched by the background heartbeat monitor for
        # the main thread to surface at its next group operation
        self._collective_site: str = ""
        self._hb_last: dict = {}
        self._pending_abort: Optional[ClusterAbort] = None
        # failure-domain scope (Context generation): poison frames and
        # generation barriers carry it; frames tagged with an OLDER
        # generation are stale leftovers of an aborted pipeline and are
        # dropped instead of poisoning the healed group
        self.generation = 0
        self.stats_stale_dropped = 0
        # link repairs performed by _repair_connection (tcp reconnect)
        self.stats_reconnects = 0
        # newest generation-barrier marker seen per peer OUTSIDE a
        # barrier drain (a payload recv may consume one when this rank
        # missed the cluster's abort): the local barrier reads the
        # stash instead of waiting for a frame already consumed
        self._gen_markers: dict = {}
        # tracing spine (common/trace.py), attached by the Context:
        # every collective (_at) and generation heal becomes a span in
        # the "net" lane; None / disabled = no allocation
        self.tracer = None
        # performance doctor (common/doctor.py), attached by the
        # Context: every blocking collective recv records how long
        # this rank was blocked and on WHOM (per-peer arrival deltas
        # -> straggler attribution). None (THRILL_TPU_DOCTOR=0) = one
        # attribute read per recv, zero allocations
        self.doctor = None

    @property
    def num_hosts(self) -> int:
        return self._num_hosts

    @abc.abstractmethod
    def connection(self, peer: int) -> Connection: ...

    def send_to(self, peer: int, obj: Any) -> Optional[int]:
        self._check_pending_abort()
        return self.connection(peer).send(obj)

    @contextlib.contextmanager
    def _at(self, site: str):
        """Name the collective in flight so a hang-abort cause can say
        WHERE the group wedged, not just that it did — and, with the
        tracing spine attached, put every host collective on the "net"
        span lane (one hook covers prefix_sum/broadcast/all_gather/
        all_reduce/barrier and their nested forms)."""
        if self.num_hosts > 1 and faults.REGISTRY.active():
            # latency injection: a delay arm on this rank's site name
            # sleeps HERE, before the collective's first frame — the
            # peers observe the lateness as per-peer recv wait. The
            # detail key is ``at`` (NOT ``site``): detail fields merge
            # into the fault_injected record, and a ``site`` key would
            # clobber the fault-site name in the event stream.
            faults.check(f"net.group.delay.r{self.my_rank}", at=site)
        prev = self._collective_site
        self._collective_site = site
        tr = self.tracer
        sp = (tr.begin("net", site) if tr is not None and tr.enabled
              and self.num_hosts > 1 else None)
        try:
            yield
        except BaseException as e:
            if sp is not None:
                sp.attrs["error"] = repr(e)[:200]
            raise
        finally:
            if sp is not None:
                tr.end(sp)
            self._collective_site = prev

    def _check_pending_abort(self) -> None:
        ab = self._pending_abort
        if ab is not None:
            raise ab

    def mark_dead(self, peer: int, cause: str) -> None:
        """Failure-detector verdict (net/heartbeat.py): ``peer`` is
        unreachable. Latch an abort for the main thread, poison the
        surviving peers so the whole group converts to fast attributable
        aborts instead of a cascade of timeouts.

        The verdict is UNRECOVERABLE: a heartbeat-confirmed dead
        process cannot be healed by a new generation — only the
        supervised relaunch + checkpoint resume path recovers it
        (run-scripts/supervise.sh, api.RunSupervised)."""
        ab = ClusterAbort(self.my_rank, cause,
                          generation=self.generation, recoverable=False)
        if self._pending_abort is None or getattr(
                self._pending_abort, "recoverable", True):
            self._pending_abort = ab
        try:
            self.poison_peers(cause, unrecoverable=True)
        except Exception:
            pass

    def recv_from(self, peer: int) -> Any:
        """Receive one message; a poison control frame surfaces as
        :class:`ClusterAbort` carrying the originator's root cause
        (reference has no analog — a dead peer hangs its job until the
        runtime kills it, api/context.cpp:849-878).

        Collective watchdog: with ``THRILL_TPU_HANG_TIMEOUT_S`` set,
        a recv that sees no frame within the deadline poisons the
        group with a ClusterAbort naming the collective and the silent
        peer rank — a wedged collective becomes a fast, attributable
        abort a supervising re-launch can resume from."""
        self._check_pending_abort()
        deadline = hang_timeout_s()
        # the deadline is ABSOLUTE across heartbeat-filter iterations:
        # liveness chatter proves the peer process is alive but does
        # not excuse a wedged collective (same semantics as the tcp
        # transport's internal filter, TcpConnection._recv_msg)
        deadline_at = (None if deadline is None
                       else time.monotonic() + deadline)
        site = self._collective_site or "recv"
        injected_stale = False
        while True:
            try:
                obj = None
                if faults.REGISTRY.active():
                    try:
                        faults.check(_F_HANG, peer=peer, site=site)
                    except faults.InjectedFault:
                        raise CollectiveHangTimeout(
                            "injected wedge") from None
                    if not injected_stale:
                        try:
                            faults.check(_F_STALE, peer=peer, site=site)
                        except faults.InjectedFault:
                            # replay a prior-generation poison frame as
                            # if it were still in flight from an aborted
                            # pipeline: the filter below must drop it
                            # and the REAL frame arrives on the next
                            # loop pass
                            injected_stale = True
                            obj = {POISON_KEY: {
                                "origin": peer,
                                "cause": "injected stale replay",
                                "gen": self.generation - 1}}
                if obj is None:
                    conn = self.connection(peer)
                    doc = self.doctor
                    if doc is not None:
                        # lock-free attribute reads (benign race): the
                        # background-I/O busy delta across the blocked
                        # window caps the wait's I/O attribution
                        from ..common.iostats import IO as _io
                        t0 = time.perf_counter()
                        io0 = _io.io_busy_s
                    if deadline_at is None:
                        obj = conn.recv()
                    else:
                        remaining = deadline_at - time.monotonic()
                        if remaining <= 0:
                            raise CollectiveHangTimeout("deadline spent")
                        obj = conn.recv_deadline(remaining)
                    if doc is not None:
                        doc.record_wait(site, peer,
                                        time.perf_counter() - t0,
                                        io_s=_io.io_busy_s - io0)
            except CollectiveHangTimeout:
                cause = (f"hang at {site}: rank {self.my_rank} "
                         f"received no frame from rank {peer} within "
                         f"{deadline if deadline is not None else 0}s "
                         f"(THRILL_TPU_HANG_TIMEOUT_S)")
                try:
                    self.poison_peers(cause)
                except Exception:
                    pass
                raise ClusterAbort(self.my_rank, cause,
                                   generation=self.generation) from None
            if isinstance(obj, dict) and HEARTBEAT_KEY in obj:
                # liveness chatter from a transport without its own
                # filter (mock queues): note it, keep waiting for the
                # payload on the SAME deadline budget
                self._hb_last[peer] = time.monotonic()
                continue
            if isinstance(obj, dict) and GENERATION_KEY in obj:
                info = obj[GENERATION_KEY]
                g = int(info.get("gen", 0))
                if g > self.generation:
                    # the peer healed into a NEWER failure domain:
                    # this rank MISSED the cluster's abort (its poison
                    # frame was lost and the watchdog is off). Stash
                    # the marker — our own barrier must not wait for a
                    # frame we just consumed — and abort the current
                    # collective so the pipeline handler heals and
                    # meets the peer at the barrier.
                    self._gen_markers[peer] = max(
                        self._gen_markers.get(peer, 0), g)
                    origin = int(info.get("rank", peer))
                    raise ClusterAbort(
                        origin,
                        f"peer rank {origin} healed to generation "
                        f"{g} while this rank was still in generation "
                        f"{self.generation} — the cluster aborted "
                        f"without local notice",
                        generation=self.generation)
                # a LATE marker from a heal this rank already
                # completed: control chatter, never payload — drop it
                self._drop_stale(peer, obj)
                continue
            if isinstance(obj, dict) and POISON_KEY in obj:
                info = obj[POISON_KEY]
                gen = int(info.get("gen", self.generation))
                if gen < self.generation:
                    # stale poison of an ALREADY-HEALED generation (a
                    # slow peer's abort frame, or a replayed frame):
                    # the failure domain it belongs to is gone — drop
                    # it instead of killing the healed group
                    self._drop_stale(peer, obj)
                    continue
                origin = int(info.get("origin", peer))
                cause = str(info.get("cause", "unknown"))
                recoverable = not bool(info.get("unrecoverable", False))
                if (origin, cause) not in self._poison_relayed:
                    # RELAY once before aborting: in tree/hypercube
                    # collectives most ranks never recv from the origin
                    # directly — without the relay they would block on a
                    # healthy partner that already aborted and surface a
                    # secondary 'peer closed' instead of the root cause
                    try:
                        self.poison_peers(cause, origin=origin,
                                          unrecoverable=not recoverable)
                    except Exception:
                        pass
                raise ClusterAbort(origin, cause, generation=gen,
                                   recoverable=recoverable)
            return obj

    def _drop_stale(self, peer: int, obj: Any) -> None:
        """Count + log one dropped prior-generation frame."""
        self.stats_stale_dropped += 1
        info = next(iter(obj.values())) if obj else {}
        faults.note("recovery", what="net.stale_frame_dropped",
                    _quiet=self.stats_stale_dropped > 8,
                    peer=peer, gen=self.generation,
                    frame_gen=(info or {}).get("gen"))

    # ------------------------------------------------------------------
    # any-source receive (MixStream consume-first-arrival)
    # ------------------------------------------------------------------

    @property
    def supports_recv_any(self) -> bool:
        """Whether :meth:`recv_any` can genuinely pick whichever peer's
        frame lands first. Transports without a readiness probe fall
        back to the fixed per-peer schedule (the pre-any-source
        behavior) — callers need no special-casing either way."""
        return False

    def _pick_ready_peer(self, peers: List[int]) -> int:
        """Transport hook: block until SOME peer in ``peers`` has a
        frame pending and return its rank. The default (no readiness
        probe) returns the first peer — recv_any then degrades to the
        fixed schedule. Implementations should bound their wait by
        :func:`hang_timeout_s` and return any peer on expiry so
        ``recv_from``'s own watchdog produces the attributable abort."""
        return peers[0]

    def recv_any(self, peers: List[int]) -> tuple:
        """Receive one message from whichever of ``peers`` delivers
        first; returns ``(peer, obj)``. Poison frames, heartbeat
        filtering and the collective watchdog behave exactly as in
        :meth:`recv_from` (the pick only chooses WHO to drain; the
        actual receive goes through the same guarded path)."""
        self._check_pending_abort()
        peer = self._pick_ready_peer(list(peers))
        return peer, self.recv_from(peer)

    # ------------------------------------------------------------------
    # coordinated abort (poison control frames)
    # ------------------------------------------------------------------

    def poison_peers(self, cause: Any, origin: Optional[int] = None,
                     unrecoverable: bool = False) -> int:
        """Best-effort broadcast of a poison frame to every peer.

        A worker hitting an unrecoverable error calls this before
        re-raising, so every peer blocked in a collective surfaces the
        ROOT CAUSE within its own recv deadline instead of a cascade of
        secondary timeouts; receivers relay once (recv_from), so ranks
        that never recv from the origin directly still get the cause.
        Returns the number of peers notified; failures to notify (the
        cause may be the transport itself) are swallowed — the
        caller's re-raise is the authoritative error. ``origin`` is
        set by relays to preserve the ORIGINATING rank.

        The frame is tagged with the CURRENT generation so a healed
        group drops it if it arrives after the failure domain it
        belongs to was torn down; ``unrecoverable`` marks process-death
        verdicts (mark_dead) that no heal may clear.
        """
        org = self.my_rank if origin is None else origin
        self._poison_relayed.add((org, _cause_str(cause)))
        frame = {POISON_KEY: {"origin": org,
                              "cause": _cause_str(cause),
                              "gen": self.generation,
                              **({"unrecoverable": True}
                                 if unrecoverable else {})}}
        # bounded send deadline (common/timeouts.py load scaling): a
        # peer that stopped draining its socket (wedged, descheduled,
        # dying) can have a FULL kernel buffer — a blocking send of the
        # poison frame would then hang the aborting worker itself.
        # Past the deadline that peer is skipped; it still learns the
        # cause from another rank's relay or its own recv deadline.
        from ..common.timeouts import scaled
        deadline = min(scaled(1.0), 5.0)
        notified = 0
        for peer in range(self.num_hosts):
            if peer == self.my_rank:
                continue
            try:
                # send only, never flush: a flush would wait on bulk
                # frames already queued to a DEAD peer and hang the
                # abort itself. Dispatcher-attached connections drain
                # the queued poison frame asynchronously; blocking
                # connections wrote it synchronously in send_bounded().
                self.connection(peer).send_bounded(frame, deadline)
                notified += 1
            except Exception:
                continue
        faults.note("abort", origin=self.my_rank, notified=notified,
                    cause=_cause_str(cause))
        return notified

    # ------------------------------------------------------------------
    # generation-scoped failure domains (heal after a pipeline abort)
    # ------------------------------------------------------------------

    def _heal_transport(self, deadline_at: float) -> None:
        """Proactively repair links already KNOWN broken before the
        generation barrier runs (tcp overrides: reconnect + session
        handshake). Base transports have nothing to repair."""

    def _repair_connection(self, peer: int, deadline_at: float,
                           cause: Optional[BaseException] = None) -> bool:
        """Transport hook: try to re-establish the link to ``peer``
        after a transport error surfaced mid-barrier. Returns True when
        the link is usable again (the barrier retries), False when this
        transport cannot reconnect (the heal fails and the abort
        escalates to the unrecoverable path)."""
        return False

    def link_repairable(self, peer: int) -> bool:
        """Is the link to ``peer`` in a DOWN-BUT-REPAIRABLE state (a
        dropped stream a generation heal could reconnect)? The
        heartbeat monitor consults this before ruling a peer dead: a
        repairable link drop is a PIPELINE-scoped event owned by the
        heal (whose dial budget still produces the dead-process verdict
        when nobody answers) — declaring it a dead process here would
        defeat the heal. Base transports have no repair path."""
        return False

    def begin_generation(self, gen: int) -> int:
        """Enter failure domain ``gen`` after a pipeline abort: clear
        the pipeline-scoped abort latch, repair dropped links (tcp),
        send every peer a generation-barrier marker and DRAIN each
        inbound channel up to the peer's marker — everything queued
        before it (bulk frames of the aborted exchange, late poison,
        stray collective payloads) belongs to the dead generation and
        is discarded. On return the group is exactly as quiet as a
        freshly bootstrapped one.

        Raises the latched abort when it is unrecoverable (heartbeat
        dead-peer verdict), :class:`CollectiveHangTimeout` when a peer
        never delivers its marker within THRILL_TPU_HEAL_TIMEOUT_S,
        and :class:`ClusterAbort` when a CURRENT-generation poison
        arrives mid-drain (a new failure during the heal itself).
        Returns the number of stale frames dropped."""
        tr = self.tracer
        if tr is None or not tr.enabled:
            return self._begin_generation(gen)
        with tr.span("net", "heal", gen=int(gen)) as sp:
            dropped = self._begin_generation(gen)
            sp.attrs["settled_gen"] = self.generation
            sp.attrs["stale_dropped"] = dropped
            sp.attrs["reconnects"] = self.stats_reconnects
            return dropped

    def _begin_generation(self, gen: int) -> int:
        gen = int(gen)
        if self._gen_markers:
            # ADOPT a newer generation announced by peers whose heal
            # this rank missed: the barrier only completes when every
            # rank targets the same id
            gen = max(gen, max(self._gen_markers.values()))
        ab = self._pending_abort
        if ab is not None:
            if (getattr(ab, "recoverable", True)
                    and getattr(ab, "generation", -1) < gen):
                # pipeline-scoped verdict of the aborted generation:
                # the new domain starts clean
                self._pending_abort = None
            else:
                raise ab
        self._poison_relayed.clear()
        self.generation = gen
        dropped = 0
        if self.num_hosts > 1:
            deadline_at = time.monotonic() + heal_timeout_s()
            self._heal_transport(deadline_at)
            frame = {GENERATION_KEY: {"gen": self.generation,
                                      "rank": self.my_rank}}
            for peer in range(self.num_hosts):
                if peer == self.my_rank:
                    continue
                while True:
                    try:
                        dropped += self._gen_barrier_peer(
                            peer, frame, deadline_at)
                        break
                    except (ClusterAbort, CollectiveHangTimeout):
                        raise
                    except (ConnectionError, OSError) as e:
                        if (isinstance(e, TimeoutError)
                                and not isinstance(e, ConnectionError)):
                            # bounded-send expiry with nothing written:
                            # the stream is INTACT (the peer is just
                            # slow to drain) — retry the barrier within
                            # the heal deadline instead of dropping a
                            # healthy authenticated link (duplicate
                            # markers are filtered on receipt)
                            if time.monotonic() >= deadline_at:
                                raise
                            continue
                        # the link itself died (or was already dead on
                        # this side): give the transport one repair
                        # attempt per error, bounded by the heal
                        # deadline
                        if (time.monotonic() >= deadline_at
                                or not self._repair_connection(
                                    peer, deadline_at, e)):
                            raise
        # markers at or below the settled generation are used up; only
        # evidence of an even NEWER domain (a concurrent further heal)
        # survives for the next barrier
        self._gen_markers = {p: g for p, g in self._gen_markers.items()
                             if g > self.generation}
        self.stats_stale_dropped += dropped
        if dropped:
            faults.note("recovery", what="net.generation_drain",
                        gen=self.generation, dropped=dropped)
        return dropped

    def _gen_barrier_peer(self, peer: int, frame: dict,
                          deadline_at: float) -> int:
        """Send ``peer`` the generation marker, then drain its channel
        up to the peer's own marker. Returns stale frames dropped."""
        conn = self.connection(peer)
        conn.send_bounded(frame,
                          min(max(deadline_at - time.monotonic(), 0.1),
                              5.0))
        if self._gen_markers.get(peer, 0) >= self.generation:
            # the peer's marker was already consumed by a payload recv
            # (the missed-abort path): the barrier is satisfied
            return 0
        dropped = 0
        while True:
            remaining = deadline_at - time.monotonic()
            if remaining <= 0:
                raise CollectiveHangTimeout(
                    f"generation barrier: no gen-{self.generation} "
                    f"marker from rank {peer} within "
                    f"{heal_timeout_s()}s (THRILL_TPU_HEAL_TIMEOUT_S)")
            obj = conn.recv_deadline(remaining)
            if isinstance(obj, dict) and HEARTBEAT_KEY in obj:
                self._hb_last[peer] = time.monotonic()
                continue
            if isinstance(obj, dict) and GENERATION_KEY in obj:
                g = int(obj[GENERATION_KEY].get("gen", 0))
                if g >= self.generation:
                    return dropped          # barrier reached
                dropped += 1                # stale marker of an older heal
                continue
            if isinstance(obj, dict) and POISON_KEY in obj:
                info = obj[POISON_KEY]
                g = int(info.get("gen", self.generation))
                if g >= self.generation:
                    # a NEW failure arrived during the heal itself
                    raise ClusterAbort(
                        int(info.get("origin", peer)),
                        str(info.get("cause", "unknown")),
                        generation=g,
                        recoverable=not bool(info.get("unrecoverable",
                                                      False)))
                dropped += 1
                continue
            dropped += 1                    # pre-abort payload frame

    # ------------------------------------------------------------------
    # elastic membership (resize at a generation boundary)
    # ------------------------------------------------------------------

    def _grow_transport(self, new_num_hosts: int, gen: int,
                        deadline_at: float) -> None:
        """Admit ranks ``[num_hosts, new_num_hosts)``: establish an
        authenticated connection to each joiner (transport-specific;
        tcp accepts the joiner's dial on this rank's own hostlist
        port, mock extends the queue matrix). Must NOT mutate
        ``_num_hosts`` — the caller commits membership only after
        every joiner connected."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot admit new ranks")

    def _shrink_transport(self, new_num_hosts: int) -> None:
        """Drop connections to ranks ``>= new_num_hosts`` (they have
        drained and left, or were already dead). Default: nothing —
        queue-backed transports just stop addressing them."""

    def resize(self, new_num_hosts: int, gen: int) -> None:
        """Collective membership change: every CURRENT rank (including
        the ranks about to leave) calls this in lockstep with the same
        ``(new_num_hosts, gen)``. A JOINING rank does not call it — it
        enters through the transport's join constructor
        (``tcp.join_tcp_group`` / ``MockNetwork.grow``) and then runs
        ``begin_generation(gen)`` like everyone else.

        Grow: admit the joiners, commit the new membership, then
        barrier on it — the joiners' first collective is the
        generation barrier itself. A failed admission (joiner died
        mid-handshake, injected ``net.group.resize_handshake``) rolls
        the membership back and settles ``gen`` among the old ranks,
        so the group is healed and the next resize attempt starts
        clean.

        Shrink: barrier on the OLD membership first — the departing
        rank's in-flight frames drain behind the existing generation
        barrier — then the survivors drop the departed links. A
        departing peer that is ALREADY DEAD is skipped with a note:
        scale-down of a dead peer is the graceful form of the
        dead-peer verdict (it was leaving anyway). A departing rank
        returns with its frames drained; the caller closes the group.
        """
        new_w = int(new_num_hosts)
        old_w = self.num_hosts
        gen = int(gen)
        if not resize_enabled():
            raise RuntimeError(
                "elastic resize is disabled (THRILL_TPU_RESIZE=0); "
                "the worker count is pinned for the process lifetime")
        if new_w < 1:
            raise ValueError(f"cannot resize to {new_w} hosts")
        faults.check(F_RESIZE, old=old_w, new=new_w, gen=gen,
                     rank=self.my_rank)
        if new_w == old_w:
            self.begin_generation(gen)
            return
        if new_w > old_w:
            deadline_at = time.monotonic() + resize_timeout_s()
            try:
                self._grow_transport(new_w, gen, deadline_at)
                self._num_hosts = new_w
                self.begin_generation(gen)
            except (ConnectionError, OSError, TimeoutError):
                # roll back: drop whatever joiner links landed, settle
                # the generation among the OLD membership so a retry
                # (or plain continued traffic) starts from a healed
                # group instead of a half-admitted one
                self._num_hosts = old_w
                self._shrink_transport(old_w)
                faults.note("recovery", what="net.resize_rollback",
                            old=old_w, new=new_w, gen=gen)
                self.begin_generation(gen)
                raise
            faults.note("recovery", what="net.resize", old=old_w,
                        new=new_w, gen=gen, _quiet=True)
            return
        # -- shrink --------------------------------------------------
        departing = frozenset(range(new_w, old_w))
        self._resize_barrier(gen, lenient=departing)
        if self.my_rank in departing:
            return                  # drained; caller closes the group
        self._num_hosts = new_w
        self._shrink_transport(new_w)
        self._hb_last = {p: t for p, t in self._hb_last.items()
                         if p < new_w}
        faults.note("recovery", what="net.resize", old=old_w,
                    new=new_w, gen=gen, _quiet=True)

    def prepare_relaunch(self, new_num_hosts: int, gen: int) -> None:
        """The net-layer step of an orchestrated process-level resize
        (``Context.resize_processes``): agree the group is ready to be
        torn down and relaunched at ``new_num_hosts``.

        Collective over the CURRENT membership, and deliberately
        mutation-free: every process — survivor, departing, and (for
        a grow) the current ranks the joiners will meet again — exits
        for the supervised relaunch right after the move commits, so
        the only job here is agreement that every current rank
        reached the relaunch point. Shrink settles the generation
        through the lenient departing-peer barrier (an
        already-dead departing rank must not wedge the survivors'
        move); grow is a plain generation barrier (the joiners do not
        exist until the supervisor spawns them — admission happens in
        the relaunched processes' authenticated bootstrap). Because
        nothing mutates, the marker commit that follows still runs
        its cross-rank barrier over the intact old membership, and an
        injected failure at ANY point before the marker leaves the
        old-W group exactly as it was. The ``net.group.relaunch``
        fault site fires FIRST — the nothing-mutated proof for this
        step."""
        new_w = int(new_num_hosts)
        old_w = self.num_hosts
        gen = int(gen)
        if not resize_enabled():
            raise RuntimeError(
                "elastic resize is disabled (THRILL_TPU_RESIZE=0); "
                "the worker count is pinned for the process lifetime")
        faults.check(F_RELAUNCH, old=old_w, new=new_w,
                     gen=gen, rank=self.my_rank)
        if new_w < old_w:
            departing = frozenset(range(new_w, old_w))
            self._resize_barrier(gen, lenient=departing)
        else:
            self.begin_generation(gen)
        faults.note("recovery", what="net.relaunch_ready",
                    old=old_w, new=new_w, gen=gen, _quiet=True)

    def _resize_barrier(self, gen: int, lenient: frozenset) -> int:
        """Generation barrier over the CURRENT membership in which a
        barrier failure against a ``lenient`` peer (the departing set)
        is skipped instead of escalated — an unreachable peer that is
        leaving anyway must not wedge the survivors. Mirrors
        :meth:`_begin_generation` otherwise (marker exchange, stale
        drain, pending-abort latch, repair-retry for survivors)."""
        gen = int(gen)
        if self._gen_markers:
            gen = max(gen, max(self._gen_markers.values()))
        ab = self._pending_abort
        if ab is not None:
            if (getattr(ab, "recoverable", True)
                    and getattr(ab, "generation", -1) < gen):
                self._pending_abort = None
            else:
                raise ab
        self._poison_relayed.clear()
        self.generation = gen
        dropped = 0
        if self.num_hosts > 1:
            deadline_at = time.monotonic() + resize_timeout_s()
            frame = {GENERATION_KEY: {"gen": self.generation,
                                      "rank": self.my_rank}}
            for peer in range(self.num_hosts):
                if peer == self.my_rank:
                    continue
                while True:
                    try:
                        dropped += self._gen_barrier_peer(
                            peer, frame, deadline_at)
                        break
                    except ClusterAbort:
                        raise
                    except (CollectiveHangTimeout, ConnectionError,
                            OSError) as e:
                        if peer in lenient:
                            # already-dead departing peer: the
                            # graceful form of the dead-peer verdict
                            faults.note("recovery",
                                        what="net.resize_skip_dead",
                                        peer=peer, gen=gen,
                                        error=repr(e)[:200])
                            break
                        if isinstance(e, CollectiveHangTimeout):
                            raise
                        if (time.monotonic() >= deadline_at
                                or not self._repair_connection(
                                    peer, deadline_at, e)):
                            raise
        self._gen_markers = {p: g for p, g in self._gen_markers.items()
                             if g > self.generation}
        self.stats_stale_dropped += dropped
        if dropped:
            faults.note("recovery", what="net.generation_drain",
                        gen=self.generation, dropped=dropped)
        return dropped


    # ------------------------------------------------------------------
    # collectives (reference: net/collective.hpp)
    # ------------------------------------------------------------------

    def prefix_sum(self, value: Any, op: Callable = operator.add) -> Any:
        """Dissemination ("doubling") inclusive prefix sum.

        Reference: PrefixSumDoubling, net/collective.hpp:52. O(log p)
        rounds; each round r exchanges with rank +/- 2^r.
        """
        p = self.num_hosts
        r = self.my_rank
        acc = value        # running sum of [r - 2^k + 1 .. r]
        d = 1
        with self._at("prefix_sum"):
            while d < p:
                if r + d < p:
                    self.send_to(r + d, acc)
                if r - d >= 0:
                    received = self.recv_from(r - d)
                    acc = op(received, acc)
                d <<= 1
        return acc

    def _shift_right(self, incl: Any, op: Callable, initial: Any) -> Any:
        """Turn an inclusive scan result into exclusive by sending the
        inclusive value to rank+1 (ring shift). The result folds in
        ``initial`` like the reference's ExPrefixSum: rank 0 returns
        ``initial``, rank r returns op(initial, incl[r-1])."""
        p = self.num_hosts
        r = self.my_rank
        with self._at("ex_prefix_sum"):
            if r + 1 < p:
                self.send_to(r + 1, incl)
            if r > 0:
                received = self.recv_from(r - 1)
                return received if initial is None \
                    else op(initial, received)
        return initial

    def ex_prefix_sum(self, value: Any, op: Callable = operator.add,
                      initial: Any = 0) -> Any:
        """Exclusive prefix sum (reference: ExPrefixSum, net/collective.hpp:165)."""
        incl = self.prefix_sum(value, op)
        return self._shift_right(incl, op, initial)

    def broadcast(self, value: Any, origin: int = 0) -> Any:
        """Binomial-tree broadcast (reference: BroadcastBinomialTree,
        net/collective.hpp:205)."""
        p = self.num_hosts
        if p == 1:
            return value
        # rotate ranks so origin is 0
        vr = (self.my_rank - origin) % p
        # binomial tree: parent = vr - lowbit(vr); children = vr + d for
        # powers of two d < lowbit(vr) (root: all d < p)
        lowbit = vr & -vr if vr != 0 else p
        with self._at("broadcast"):
            if vr != 0:
                value = self.recv_from(((vr - lowbit) + origin) % p)
            d = 1
            while d < lowbit and vr + d < p:
                self.send_to((vr + d + origin) % p, value)
                d <<= 1
        return value

    def all_gather(self, value: Any) -> List[Any]:
        """Bruck-style all-gather returning the list ordered by rank.

        Reference: AllGatherRecursiveDoublingPowerOfTwo / AllGatherBruck,
        net/collective.hpp:260,279. We implement Bruck (works for any p).
        """
        p = self.num_hosts
        r = self.my_rank
        items: List[Any] = [value]
        d = 1
        with self._at("all_gather"):
            while len(items) < p:
                cnt = min(d, p - len(items))
                self.send_to((r - d) % p, items[:cnt])
                items.extend(self.recv_from((r + d) % p))
                d <<= 1
        # Bruck leaves items rotated: items[i] belongs to rank (r + i) % p.
        out: List[Any] = [None] * p
        for i, it in enumerate(items):
            out[(r + i) % p] = it
        return out

    def reduce(self, value: Any, op: Callable = operator.add, root: int = 0) -> Optional[Any]:
        """Binomial-tree reduction to ``root``
        (reference: Reduce, net/collective.hpp:331)."""
        p = self.num_hosts
        vr = (self.my_rank - root) % p
        acc = value
        d = 1
        with self._at("reduce"):
            while d < p:
                if (vr & d) != 0:
                    self.send_to(((vr - d) + root) % p, acc)
                    return None
                if vr + d < p:
                    other = self.recv_from(((vr + d) + root) % p)
                    acc = op(acc, other)
                d <<= 1
        return acc if vr == 0 else None

    def all_reduce(self, value: Any, op: Callable = operator.add) -> Any:
        """All-reduce; hypercube for powers of two, elimination for the
        rest (reference: AllReduceHypercube net/collective.hpp:414 and
        the 3-2 elimination variant :459-548 — here the standard 2-1
        form: extras above the largest power of two fold into a partner
        first, the partners run the hypercube, and the extras get the
        result back: 2 extra rounds instead of a full
        reduce+broadcast)."""
        p = self.num_hosts
        r = self.my_rank
        pp = 1 << (p.bit_length() - 1)      # largest power of two <= p
        with self._at("all_reduce"):
            if pp == p:
                return self._hypercube_all_reduce(value, op, p, r)
            # ADJACENT ranks pair up (2i folds 2i+1), so the virtual-
            # rank order equals the global rank order and non-
            # commutative (associative) ops still combine left-to-right
            extras = p - pp
            if r < 2 * extras:
                if r % 2 == 1:           # eliminated: partner computes
                    self.send_to(r - 1, value)
                    return self.recv_from(r - 1)
                acc = op(value, self.recv_from(r + 1))
                vr = r // 2
            else:
                acc = value
                vr = r - extras

            def to_real(v: int) -> int:
                return 2 * v if v < extras else v + extras

            acc = self._hypercube_all_reduce(acc, op, pp, vr, to_real)
            if r < 2 * extras:               # fan the result back
                self.send_to(r + 1, acc)
        return acc

    def _hypercube_all_reduce(self, acc: Any, op: Callable, p: int,
                              r: int, to_real: Callable = None) -> Any:
        to_real = to_real or (lambda v: v)
        d = 1
        while d < p:
            peer = r ^ d
            # symmetric exchange; deterministic order avoids deadlock
            if r < peer:
                self.send_to(to_real(peer), acc)
                other = self.recv_from(to_real(peer))
            else:
                other = self.recv_from(to_real(peer))
                self.send_to(to_real(peer), acc)
            # keep rank order as operand order for non-commutative ops
            acc = op(acc, other) if r < peer else op(other, acc)
            d <<= 1
        return acc

    def barrier(self) -> None:
        self.all_reduce(0, operator.add)


def _cause_str(cause: Any) -> str:
    if isinstance(cause, BaseException):
        return f"{type(cause).__name__}: {cause}"
    return str(cause)


@contextlib.contextmanager
def poison_on_error(group: Optional[Group], what: str = ""):
    """Run a collective phase under the abort protocol: any error that
    escapes (except an abort we *received* — relaying those would ping-
    pong poison frames) is broadcast to every peer before re-raising.

    The no-op cases (group is None, single-host group) make the guard
    safe to wrap around code that also runs single-controller."""
    try:
        yield
    except ClusterAbort:
        raise
    except BaseException as e:
        if group is not None and group.num_hosts > 1:
            try:
                group.poison_peers(e)
            except Exception:
                pass                 # original error stays authoritative
        raise
