"""The port's host group, its collectives, the abort protocol and the
flow-control channel (``thrill_tpu_torch/net/group.py``, ``mock.py``,
``flow.py``) against the reference package's over ``MockNetwork`` on
the CPU.

Tolerance: exact. Every collective at 1-4 hosts (with the
non-power-of-two all-reduce at 3) gives the reference's values; a
poisoned peer gives a ``ClusterAbort`` with the reference's origin and
cause; a silent peer gives ``CollectiveHangTimeout`` on a timed receive
and, under ``THRILL_TPU_HANG_TIMEOUT_S``, the reference's hang abort;
``FlowControlChannel`` gives the reference's values. Each host runs on a
daemon thread joined with a timeout, so a wrong collective fails rather
than hangs.
"""

import operator
import threading

import pytest

from thrill_tpu.net import FlowControlChannel as JFlow
from thrill_tpu.net import MockNetwork as JMock
from thrill_tpu.net.group import ClusterAbort as JClusterAbort

from thrill_tpu_torch.common import faults
from thrill_tpu_torch.net import FlowControlChannel, MockNetwork
from thrill_tpu_torch.net.group import (ClusterAbort, CollectiveHangTimeout,
                                        poison_on_error)


def run_group(net_cls, num_hosts, job, timeout=20):
    groups = net_cls.construct(num_hosts)
    results = [None] * num_hosts
    errors = [None] * num_hosts

    def target(i, g):
        try:
            results[i] = job(g)
        except BaseException as e:
            errors[i] = e

    threads = [threading.Thread(target=target, args=(i, g), daemon=True)
               for i, g in enumerate(groups)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert all(not t.is_alive() for t in threads), "collective hung"
    return results, errors


def both(num_hosts, job, flow=False):
    """``job`` over the port's and the reference's mock networks."""
    def wrap(fcls):
        return (lambda g: job(fcls(g))) if flow else job
    port, perr = run_group(MockNetwork, num_hosts, wrap(FlowControlChannel))
    ref, rerr = run_group(JMock, num_hosts, wrap(JFlow))
    for e in perr + rerr:
        if e is not None:
            raise e
    return port, ref


COLLECTIVES = {
    "prefix_sum": lambda g: g.prefix_sum(g.my_rank + 1),
    "prefix_sum_concat": lambda g: g.prefix_sum([g.my_rank]),
    "ex_prefix_sum": lambda g: g.ex_prefix_sum(g.my_rank + 1, initial=0),
    "ex_prefix_sum_initial": lambda g: g.ex_prefix_sum(g.my_rank + 1,
                                                       initial=10),
    "ex_prefix_sum_min": lambda g: g.ex_prefix_sum(
        [5, 3, 8, 1][g.my_rank % 4], op=min, initial=10 ** 9),
    "broadcast_0": lambda g: g.broadcast(
        g.my_rank * 10 if g.my_rank == 0 else None, origin=0),
    "broadcast_last": lambda g: g.broadcast(
        "v%d" % g.my_rank if g.my_rank == g.num_hosts - 1 else None,
        origin=g.num_hosts - 1),
    "all_gather": lambda g: g.all_gather(g.my_rank * 2),
    "all_gather_obj": lambda g: g.all_gather({"r": [g.my_rank] * 3}),
    "reduce": lambda g: g.reduce(g.my_rank + 1),
    "reduce_root_last": lambda g: g.reduce(g.my_rank + 1,
                                           root=g.num_hosts - 1),
    "all_reduce": lambda g: g.all_reduce(g.my_rank + 1),
    "all_reduce_max": lambda g: g.all_reduce((g.my_rank * 7) % 5, op=max),
    "all_reduce_concat": lambda g: g.all_reduce([g.my_rank],
                                                op=operator.add),
    "barrier": lambda g: g.barrier(),
}


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collectives_are_the_reference_s(name, p):
    port, ref = both(p, COLLECTIVES[name])
    assert port == ref


FLOW = {
    "prefix_sum": lambda f: f.prefix_sum(f.my_rank + 1),
    "ex_prefix_sum_total": lambda f: f.ex_prefix_sum_total(f.my_rank + 1),
    "broadcast": lambda f: f.broadcast(f.my_rank + 5),
    "all_gather": lambda f: f.all_gather(f.my_rank),
    "all_reduce": lambda f: f.all_reduce(f.my_rank + 1),
    "predecessor": lambda f: f.predecessor(
        2, [f.my_rank * 100 + i for i in range(3)]),
}


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(FLOW))
def test_flow_control_channel_is_the_reference_s(name, p):
    port, ref = both(p, FLOW[name], flow=True)
    assert port == ref


@pytest.mark.parametrize("p", [2, 3, 4])
def test_a_poisoned_peer_aborts_as_in_the_reference(p):
    """Rank p - 1 fails inside ``poison_on_error``; every other rank,
    blocked in an all-reduce, raises the abort with its origin and
    cause, as the reference's do."""
    def job_of(abort_cls, poe):
        def job(g):
            if g.my_rank == g.num_hosts - 1:
                with poe(g, "phase"):
                    raise RuntimeError("disk on fire")
            try:
                g.all_reduce(1)
            except abort_cls as e:
                return (e.origin, e.cause, e.recoverable)
            return None
        return job

    from thrill_tpu.net.group import poison_on_error as jpoe
    port, perr = run_group(MockNetwork, p, job_of(ClusterAbort,
                                                  poison_on_error))
    ref, rerr = run_group(JMock, p, job_of(JClusterAbort, jpoe))
    assert port[:-1] == ref[:-1]
    assert port[0] == (p - 1, "RuntimeError: disk on fire", True)
    assert type(perr[-1]) is RuntimeError and type(rerr[-1]) is RuntimeError


def test_a_silent_peer_is_a_hang(monkeypatch):
    """A timed receive with no frame raises CollectiveHangTimeout; under
    the collective watchdog a receive inside a collective becomes the
    reference's hang abort naming the collective and the silent peer."""
    g0, _ = MockNetwork.construct(2)
    with pytest.raises(CollectiveHangTimeout):
        g0.connection(1).recv_deadline(0.05)
    monkeypatch.setenv("THRILL_TPU_HANG_TIMEOUT_S", "0.2")
    causes = []
    for net, abort in ((MockNetwork, ClusterAbort),
                       (JMock, JClusterAbort)):
        a, _b = net.construct(2)
        with pytest.raises(abort) as ei:
            with a._at("all_gather"):
                a.recv_from(1)
        causes.append((ei.value.origin, ei.value.cause))
    assert causes[0] == causes[1]
    assert causes[0][1].startswith("hang at all_gather: rank 0 received "
                                   "no frame from rank 1")


def test_an_injected_hang_aborts_as_in_the_reference():
    g0, _ = MockNetwork.construct(2)
    with faults.inject("net.group.recv_hang"):
        with pytest.raises(ClusterAbort, match="hang at recv"):
            g0.recv_from(1)


def test_generations_wait_for_a_later_part_of_item_6():
    g0, _ = MockNetwork.construct(2)
    for call in (lambda: g0.begin_generation(1), lambda: g0.resize(3, 1),
                 lambda: g0.prepare_relaunch(3, 1)):
        with pytest.raises(NotImplementedError,
                           match="item 6, its generations-and-resize"):
            call()
