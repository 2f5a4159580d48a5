"""Liveness heartbeats multiplexed over the group's connections
(counterpart of the reference package's ``net/heartbeat.py``).

The collective watchdog (net/group.py recv deadlines) only fires while
a rank is *blocked in a recv* — a worker that died between collectives
would go unnoticed until the next one wedges. This monitor closes that
gap: a background thread sends a tiny heartbeat frame to every peer on
a fixed cadence over the SAME authenticated connections the
collectives use (transports filter the frames out before they can
reach a payload stream: tcp in ``TcpConnection._recv_msg``, any other
transport in ``Group.recv_from``).

A heartbeat send that still fails after the shared retry policy means
the kernel reported the peer's socket dead (RST/EPIPE — the OS-level
verdict on a kill -9'd process): the monitor latches a
:class:`~thrill_tpu_torch.net.group.ClusterAbort` on the group naming
the dead rank and poisons the surviving peers, converting silent worker
loss into a fast, attributable abort.

Opt-in via ``THRILL_TPU_HEARTBEAT_S=<seconds>`` (off by default: the
control plane's frame streams stay byte-identical to the
pre-heartbeat protocol unless the operator asks for liveness).
Injection site ``net.heartbeat`` (``common/faults.py``
``F_HEARTBEAT``) rides every probe:
a transient fire is absorbed by the retry policy, a persistent one
exercises the real dead-peer verdict path.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..common import faults
from ..common.retry import default_policy
from .group import HEARTBEAT_KEY, Group, heal_timeout_s

F_HEARTBEAT = faults.F_HEARTBEAT


def heartbeat_interval_s() -> Optional[float]:
    v = os.environ.get("THRILL_TPU_HEARTBEAT_S", "")
    try:
        t = float(v)
    except ValueError:
        return None
    return t if t > 0 else None


class HeartbeatMonitor:
    """Background prober for one Group; one instance per process."""

    def __init__(self, group: Group, interval_s: float) -> None:
        self.group = group
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        # one bounded-backoff policy for all probes: a single EAGAIN
        # blip must not declare a peer dead
        self._policy = default_policy()
        # first time each peer's link was seen down-but-repairable:
        # the monitor defers to the generation heal for a bounded
        # window only — a link that stays broken far past any heal
        # deadline with no repair is a dead peer after all
        self._broken_since: dict = {}

    def start(self) -> "HeartbeatMonitor":
        if self.group.num_hosts <= 1 or self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="thrill-tpu-torch-heartbeat",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0 + self.interval_s)

    # -- the probe loop -------------------------------------------------
    def _run(self) -> None:
        g = self.group
        while not self._stop.wait(self.interval_s):
            self._seq += 1
            frame = {HEARTBEAT_KEY: {"seq": self._seq,
                                     "rank": g.my_rank}}
            for peer in range(g.num_hosts):
                if peer == g.my_rank or self._stop.is_set():
                    continue
                if g.link_repairable(peer):
                    if self._defer_to_heal(peer):
                        # the link is down but a generation heal can
                        # reconnect it: that is a PIPELINE-scoped event
                        # the heal owns — probing now would fast-fail
                        # on the broken mark and misrule a dropped LINK
                        # as a dead PROCESS (if nobody answers the
                        # reconnect, the heal's dial budget produces
                        # that verdict instead)
                        continue
                    # deferral window spent with no heal: probe (and
                    # fast-fail into the dead verdict) after all
                else:
                    # link healthy or repaired: a LATER drop is a new
                    # incident with its own full deferral window
                    self._broken_since.pop(peer, None)
                try:
                    self._probe(peer, frame)
                except TimeoutError:
                    # peer not draining but socket alive: slow, not
                    # dead — the collective watchdog owns that verdict
                    continue
                except Exception as e:
                    if (g.link_repairable(peer)
                            and self._defer_to_heal(peer)):
                        # the probe itself was first to discover the
                        # drop (send failed, link now marked broken):
                        # re-check repairability AFTER the failure too,
                        # or the first-to-hit probe would misrule a
                        # reconnectable drop as a dead process
                        continue
                    cause = (f"heartbeat: rank {peer} is unreachable "
                             f"({type(e).__name__}: {e}"
                             f"{self._staleness(peer)}) — worker "
                             f"presumed dead")
                    faults.note("recovery", what="heartbeat.peer_dead",
                                peer=peer, error=repr(e))
                    g.mark_dead(peer, cause)
                    self._stop.set()
                    return

    def _defer_to_heal(self, peer: int) -> bool:
        """Should a down-but-repairable link still be left to the
        generation heal? Only within a bounded window (2x the heal
        deadline) of the CURRENT incident: an application that never
        heals (no ctx.pipeline() in use) must still get the dead-peer
        verdict eventually, or silent worker loss goes unreported.
        The window is keyed to the group's repair counter, not to the
        monitor observing a healthy instant — under sustained drops
        (one per pipeline, each healed) every probe pass may sample
        the link mid-incident, and an accumulated window would issue a
        false dead-process verdict for a peer whose every heal
        succeeded."""
        now = time.monotonic()
        repairs = getattr(self.group, "stats_reconnects", 0)
        first, seen = self._broken_since.get(peer, (now, repairs))
        if repairs != seen:
            # a repair landed since this incident began: whatever is
            # broken NOW is a new incident with a fresh window
            first, seen = now, repairs
        self._broken_since[peer] = (first, seen)
        return now - first < 2.0 * heal_timeout_s()

    def _staleness(self, peer: int) -> str:
        """Last inbound heartbeat seen from ``peer``, for the verdict
        cause: the transports stamp arrival times (TcpConnection.
        last_heartbeat, Group._hb_last) and this is where they are
        read."""
        last = self.group._hb_last.get(peer, 0.0)
        conn_last = getattr(self.group.connection(peer),
                            "last_heartbeat", 0.0)
        last = max(last, conn_last)
        if not last:
            return "; no heartbeat ever received from it"
        return (f"; its last heartbeat was "
                f"{time.monotonic() - last:.1f}s ago")

    def _probe(self, peer: int, frame: dict) -> None:
        bound = max(self.interval_s, 0.25)

        def once():
            faults.check(F_HEARTBEAT, peer=peer)
            # re-fetch per attempt: a concurrent generation heal may
            # swap in a freshly reconnected connection mid-retry — the
            # probe must judge the CURRENT link, not the dropped one
            self.group.connection(peer).send_bounded(frame, bound)

        self._policy.run(once, what="net.heartbeat", seed=peer)


def maybe_start(group: Group) -> Optional[HeartbeatMonitor]:
    """Start a monitor when THRILL_TPU_HEARTBEAT_S is set (>0)."""
    interval = heartbeat_interval_s()
    if interval is None or group.num_hosts <= 1:
        return None
    return HeartbeatMonitor(group, interval).start()
