"""Worker-level collectives: the FlowControlChannel equivalent
(counterpart of the reference package's ``net/flow.py``).

The reference exposes worker-thread-level collectives as ``ctx.net``
(reference: thrill/net/flow_control_channel.hpp:48 — PrefixSum :308,
ExPrefixSum :329, ExPrefixSumTotal :351, Broadcast :424, AllGather :477,
Reduce :543, AllReduce :599, Predecessor :653, Barrier :780).

Here there are two implementations behind one concept:

* ``FlowControlChannel`` — true SPMD: one instance per worker thread,
  collectives run over a net.Group backend (mock queues in-process, TCP
  across hosts). Used by the threaded test harness and by host-side
  coordination in multi-controller deployments.

* ``LocalFlowControl`` — single-controller: the controller holds all
  per-worker values in a list and computes the collective result
  directly. On the device path the same operations are batched tensor
  ops over the worker dimension, and ``torch.distributed`` collectives
  across processes (parallel/mesh.py).
"""

from __future__ import annotations

import operator
from typing import Any, Callable, List, Sequence

from .group import Group


class FlowControlChannel:
    """Per-worker collectives over a Group (SPMD flavor)."""

    def __init__(self, group: Group) -> None:
        self.group = group

    @property
    def my_rank(self) -> int:
        return self.group.my_rank

    @property
    def num_workers(self) -> int:
        return self.group.num_hosts

    def prefix_sum(self, value: Any, op: Callable = operator.add) -> Any:
        return self.group.prefix_sum(value, op)

    def ex_prefix_sum(self, value: Any, op: Callable = operator.add,
                      initial: Any = 0) -> Any:
        return self.group.ex_prefix_sum(value, op, initial)

    def ex_prefix_sum_total(self, value: Any, op: Callable = operator.add,
                            initial: Any = 0):
        """Exclusive prefix sum plus the global total, in one pass.

        Reference: ExPrefixSumTotal, net/flow_control_channel.hpp:351 —
        the workhorse of Sort/Zip size negotiation.
        """
        excl = self.group.ex_prefix_sum(value, op, initial)
        incl = op(excl, value)
        total = self.group.broadcast(incl, origin=self.num_workers - 1)
        return excl, total

    def broadcast(self, value: Any, origin: int = 0) -> Any:
        return self.group.broadcast(value, origin)

    def all_gather(self, value: Any) -> List[Any]:
        return self.group.all_gather(value)

    def reduce(self, value: Any, op: Callable = operator.add, root: int = 0):
        return self.group.reduce(value, op, root)

    def all_reduce(self, value: Any, op: Callable = operator.add) -> Any:
        return self.group.all_reduce(value, op)

    def predecessor(self, k: int, items: Sequence[Any]) -> List[Any]:
        """Receive the last <= k items of the preceding workers.

        Sequential ring pass like the reference's Predecessor
        (net/flow_control_channel.hpp:653), used by Window to fetch the
        k-1 items preceding each worker's range.
        """
        r = self.my_rank
        p = self.num_workers
        received: List[Any] = []
        if r > 0:
            received = self.group.recv_from(r - 1)
        if r + 1 < p:
            chain = received + list(items)
            self.group.send_to(r + 1, chain[-k:] if k > 0 else [])
        return received

    def barrier(self) -> None:
        self.group.barrier()


class LocalFlowControl:
    """Single-controller implementation with a global view.

    Every method takes the per-worker values as a list of length W and
    returns per-worker results, so host-path DIA operators can express
    the same communication structure as the reference without threads.
    """

    def __init__(self, num_workers: int) -> None:
        self.num_workers = num_workers

    def prefix_sum(self, values: Sequence[Any], op: Callable = operator.add) -> List[Any]:
        out: List[Any] = []
        acc = None
        for v in values:
            acc = v if acc is None else op(acc, v)
            out.append(acc)
        return out

    def ex_prefix_sum(self, values: Sequence[Any], op: Callable = operator.add,
                      initial: Any = 0) -> List[Any]:
        out: List[Any] = []
        acc = initial
        for v in values:
            out.append(acc)
            acc = op(acc, v)
        return out

    def ex_prefix_sum_total(self, values: Sequence[Any],
                            op: Callable = operator.add, initial: Any = 0):
        excl = self.ex_prefix_sum(values, op, initial)
        total = op(excl[-1], values[-1]) if values else initial
        return excl, total

    def all_gather(self, values: Sequence[Any]) -> List[Any]:
        return list(values)

    def all_reduce(self, values: Sequence[Any], op: Callable = operator.add,
                   initial: Any = None) -> Any:
        if not values:
            if initial is None:
                raise ValueError("all_reduce over zero workers needs initial")
            return initial
        acc = values[0] if initial is None else op(initial, values[0])
        for v in values[1:]:
            acc = op(acc, v)
        return acc

    def predecessor(self, k: int, per_worker_items: Sequence[Sequence[Any]]) -> List[List[Any]]:
        """For each worker, the <= k items immediately preceding its range."""
        out: List[List[Any]] = []
        flat_prev: List[Any] = []
        for items in per_worker_items:
            out.append(flat_prev[-k:] if k > 0 else [])
            flat_prev = (flat_prev + list(items))[-k:] if k > 0 else []
        return out
