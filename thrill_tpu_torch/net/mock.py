"""In-process mock network backend (counterpart of the reference
package's ``net/mock.py``).

Equivalent of the reference's net/mock backend
(reference: thrill/net/mock/group.hpp:41,116,171): connections enqueue
messages directly into the peer's queue — always available, no sockets,
used by the in-process virtual-cluster test harness the same way the
reference uses mock groups for RunLocalTests on platforms without
socketpairs.
"""

from __future__ import annotations

import queue
import time
from typing import Any, List, Optional

from .group import (CollectiveHangTimeout, Connection, Group,
                    hang_timeout_s)


class _MockConnection(Connection):
    def __init__(self, out_q: "queue.Queue[Any]", in_q: "queue.Queue[Any]") -> None:
        self._out = out_q
        self._in = in_q
        # simulated link drop (MockGroup.drop_link): a broken mock
        # connection refuses traffic like a closed socket, so the
        # Context heal / generation-barrier repair path is testable
        # without real sockets
        self.broken = False

    def _check_link(self) -> None:
        if self.broken:
            raise ConnectionError("mock link dropped")

    def send(self, obj: Any) -> Optional[int]:
        # objects pass by reference — nothing is serialized, so there
        # is no wire byte count to report (callers measuring frame
        # bytes fall back to an explicit wire.dumps)
        self._check_link()
        self._out.put(obj)
        return None

    def recv(self) -> Any:
        self._check_link()
        return self._in.get()

    def recv_deadline(self, deadline_s: float) -> Any:
        """Timed receive for the collective watchdog (net/group.py) —
        the mock transport honors THRILL_TPU_HANG_TIMEOUT_S too, so
        the hang-abort protocol is testable without sockets."""
        self._check_link()
        try:
            return self._in.get(timeout=deadline_s)
        except queue.Empty:
            raise CollectiveHangTimeout(
                "no frame within the recv deadline") from None


class MockGroup(Group):
    def __init__(self, my_rank: int, num_hosts: int,
                 queues: List[List["queue.Queue[Any]"]]) -> None:
        super().__init__(my_rank, num_hosts)
        # queues[src][dst] carries messages src -> dst; the matrix is
        # kept so an elastic grow can wire connections to ranks added
        # by MockNetwork.grow after this group was built
        self._queues = queues
        self._conns = [
            _MockConnection(queues[my_rank][peer], queues[peer][my_rank])
            for peer in range(num_hosts)
        ]

    def connection(self, peer: int) -> Connection:
        if peer == self.my_rank:
            raise ValueError("no connection to self")
        return self._conns[peer]

    def _grow_transport(self, new_num_hosts: int, gen: int,
                        deadline_at: float) -> None:
        """Wire connections to ranks the shared MockNetwork already
        grew (MockNetwork.grow extends the queue matrix in place, so
        every live group sees the new rows)."""
        if len(self._queues) < new_num_hosts:
            raise ConnectionError(
                f"mock network has {len(self._queues)} ranks; grow the "
                f"MockNetwork to {new_num_hosts} before resizing")
        for peer in range(len(self._conns), new_num_hosts):
            self._conns.append(_MockConnection(
                self._queues[self.my_rank][peer],
                self._queues[peer][self.my_rank]))

    def _shrink_transport(self, new_num_hosts: int) -> None:
        del self._conns[new_num_hosts:]

    def drop_link(self, peer: int) -> None:
        """Simulate a dropped link to ``peer`` (tests): traffic raises
        ConnectionError until a generation heal repairs it."""
        self._conns[peer].broken = True

    def _repair_connection(self, peer, deadline_at, cause=None) -> bool:
        """Mock links 'reconnect' by clearing the broken flag — the
        queues never actually died. In-flight frames queued before the
        drop survive (like kernel-buffered bytes on a real socket) and
        are discarded by the generation-barrier drain."""
        conn = self._conns[peer]
        if not conn.broken:
            return False
        conn.broken = False
        self.stats_reconnects += 1
        from ..common import faults
        faults.note("recovery", what="net.reconnect", peer=peer,
                    gen=self.generation, transport="mock")
        return True

    def _heal_transport(self, deadline_at: float) -> None:
        for peer in range(self.num_hosts):
            if peer != self.my_rank and self._conns[peer].broken:
                self._repair_connection(peer, deadline_at)

    def link_repairable(self, peer: int) -> bool:
        return self._conns[peer].broken

    @property
    def supports_recv_any(self) -> bool:
        return True

    def _pick_ready_peer(self, peers: List[int]) -> int:
        """Poll the incoming queues (non-destructively) and return the
        first peer with a frame pending — the mock transport's
        any-source readiness probe. Bounded by the collective-watchdog
        deadline; on expiry returns the first peer so recv_from's own
        watchdog raises the attributable abort."""
        deadline = hang_timeout_s()
        deadline_at = (None if deadline is None
                       else time.monotonic() + deadline)
        while True:
            for p in peers:
                if not self._conns[p]._in.empty():
                    return p
            if (deadline_at is not None
                    and time.monotonic() >= deadline_at):
                return peers[0]
            time.sleep(0.0005)


class MockNetwork:
    """Factory building a full mesh of MockGroups for p in-process hosts.

    Reference analog: mock::Group::ConstructLoopbackMesh
    (thrill/net/mock/group.hpp) used by ConstructLoopbackHostContexts
    (thrill/api/context.cpp:92-131).
    """

    def __init__(self, num_hosts: int) -> None:
        self.num_hosts = num_hosts
        self._queues = [[queue.Queue() for _ in range(num_hosts)]
                        for _ in range(num_hosts)]

    def group(self, rank: int) -> MockGroup:
        return MockGroup(rank, self.num_hosts, self._queues)

    def grow(self, new_num_hosts: int,
             from_hosts: Optional[int] = None) -> List[MockGroup]:
        """Extend the queue matrix in place to ``new_num_hosts`` ranks
        and return groups for the NEW ranks (the mock analog of
        ``tcp.join_tcp_group``). Live groups built from this network
        pick the new rows up through ``Group.resize``; each returned
        joiner group still owes a ``begin_generation`` to enter the
        membership.

        ``from_hosts`` is the LIVE membership width the grow starts
        from; it defaults to the matrix high-water mark (a first
        grow). A RE-grow after a shrink must pass the live width:
        dormant rank slots inside the matrix are re-activated with
        FRESH queues — the mock analog of a joiner's fresh sockets, so
        nothing a departed tenant of the slot left behind can leak
        into the new rank's inbox."""
        old_matrix = len(self._queues)
        live = old_matrix if from_hosts is None else int(from_hosts)
        if not (0 < live <= old_matrix):
            raise ValueError(
                f"from_hosts={live} outside the {old_matrix}-rank "
                f"matrix")
        if new_num_hosts < live:
            raise ValueError(
                f"grow to {new_num_hosts} < live {live}; shrink "
                f"happens through Group.resize, not the network")
        width = max(old_matrix, new_num_hosts)
        for row in self._queues:
            row.extend(queue.Queue()
                       for _ in range(len(row), width))
        self._queues.extend(
            [queue.Queue() for _ in range(width)]
            for _ in range(old_matrix, width))
        self.num_hosts = width
        for r in range(live, min(new_num_hosts, old_matrix)):
            for p in range(width):
                self._queues[r][p] = queue.Queue()
                self._queues[p][r] = queue.Queue()
        return [MockGroup(r, new_num_hosts, self._queues)
                for r in range(live, new_num_hosts)]

    @staticmethod
    def construct(num_hosts: int) -> List[MockGroup]:
        net = MockNetwork(num_hosts)
        return [net.group(r) for r in range(num_hosts)]
