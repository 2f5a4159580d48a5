"""The port's TCP backend (``thrill_tpu_torch/net/tcp.py``) on loopback
against the reference package's, the cases of the reference's
``tests/net/test_tcp.py`` and its TCP cases of ``test_wire.py``.

Tolerance: exact. 1-4 rank groups bootstrap (authenticated with a
shared secret, or not) and their collectives give the reference's
values; a rank with the wrong secret, or with none against a secret, is
refused with ``AuthError``; frames round-trip (1 MiB blobs, MACed 3 MiB
frames); a dropped link is repaired by the reconnect path and carries
frames again, as in the reference. Every rank runs on a daemon thread
joined with a timeout.
"""

import socket
import threading
import time

import pytest

from thrill_tpu.net import FlowControlChannel as JFlow
from thrill_tpu.net.tcp import construct_tcp_group as jconstruct

from thrill_tpu_torch.net import FlowControlChannel, wire
from thrill_tpu_torch.net.tcp import (construct_tcp_group, join_tcp_group,
                                      parse_hostlist)


def free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def run_tcp(construct, num_hosts, job, secrets=None, timeout=60):
    hosts = [("127.0.0.1", p) for p in free_ports(num_hosts)]
    secrets = secrets or [None] * num_hosts
    results = [None] * num_hosts
    errors = [None] * num_hosts

    def target(r):
        try:
            g = construct(r, hosts, timeout=20, secret=secrets[r])
            try:
                results[r] = job(g)
            finally:
                g.close()
        except BaseException as e:
            errors[r] = e

    threads = [threading.Thread(target=target, args=(r,), daemon=True)
               for r in range(num_hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert all(not t.is_alive() for t in threads), "tcp group hung"
    return results, errors


def _collectives(flow_cls):
    def job(g):
        fcc = flow_cls(g)
        return (g.prefix_sum(g.my_rank + 1), g.all_reduce(g.my_rank + 1),
                g.all_gather(g.my_rank), g.broadcast(
                    "x" if g.my_rank == 0 else None),
                fcc.ex_prefix_sum_total(g.my_rank + 1))
    return job


@pytest.mark.parametrize("secret", [None, b"cluster-secret"])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_collectives_are_the_reference_s(p, secret):
    port, perr = run_tcp(construct_tcp_group, p,
                         _collectives(FlowControlChannel), [secret] * p)
    ref, rerr = run_tcp(jconstruct, p, _collectives(JFlow), [secret] * p)
    assert perr == [None] * p and rerr == [None] * p
    assert port == ref


def test_a_wrong_secret_is_refused():
    res, err = run_tcp(construct_tcp_group, 2, lambda g: g.all_reduce(1),
                       [b"cluster-secret", b"wrong"], timeout=90)
    assert any(isinstance(e, wire.AuthError) for e in err), err
    res, err = run_tcp(construct_tcp_group, 2, lambda g: g.all_reduce(1),
                       [b"cluster-secret", None], timeout=90)
    assert any(isinstance(e, wire.AuthError)
               and "one side" in str(e) for e in err), err


@pytest.mark.parametrize("secret", [None, b"cluster-secret"])
def test_large_frames_round_trip(secret):
    blob = bytes(range(256)) * 4096          # 1 MiB

    def job(g):
        if g.my_rank == 0:
            g.send_to(1, blob)
            return g.recv_from(1)
        got = g.recv_from(0)
        g.send_to(0, got)
        return len(got)
    res, err = run_tcp(construct_tcp_group, 2, job, [secret] * 2)
    assert err == [None, None]
    assert res == [blob, 1 << 20]


def test_macd_frames_of_megabytes_gather():
    blob = b"q" * (3 << 20)
    res, err = run_tcp(construct_tcp_group, 2,
                       lambda g: [o[0] for o in g.all_gather(
                           bytes([g.my_rank]) + blob)],
                       [b"cluster-secret"] * 2)
    assert err == [None, None] and res == [[0, 1], [0, 1]]


def _repair_job(g):
    """Rank 0 drops its link to rank 1; rank 1's next receive sees the
    peer close; both repair the link and exchange a frame over it."""
    if g.my_rank == 0:
        g.connection(1)._drop_link()
        seen = "dropped"
    else:
        try:
            g.recv_from(0)
            seen = "frame"
        except ConnectionError:
            seen = "closed"
    broken = g.connection(1 - g.my_rank).broken
    g._heal_transport(time.monotonic() + 30)
    g.send_to(1 - g.my_rank, ("after", g.my_rank))
    back = g.recv_from(1 - g.my_rank)
    return seen, broken, back, g.stats_reconnects, g.all_reduce(
        g.my_rank + 1)


@pytest.mark.parametrize("secret", [None, b"cluster-secret"])
def test_a_dropped_link_is_repaired_as_in_the_reference(secret):
    port, perr = run_tcp(construct_tcp_group, 2, _repair_job, [secret] * 2)
    ref, rerr = run_tcp(jconstruct, 2, _repair_job, [secret] * 2)
    assert perr == [None, None] and rerr == [None, None]
    assert port == ref
    assert port[1] == ("closed", True, ("after", 0), 1, 3)


def test_parse_hostlist_and_join_checks_its_rank():
    assert parse_hostlist("a:1 b:2,c:3") == [("a", 1), ("b", 2), ("c", 3)]
    assert parse_hostlist(":7000") == [("127.0.0.1", 7000)]
    # a joining rank outside its hostlist is refused, as in the
    # reference (the joins themselves: tests/test_torch_elastic.py)
    from thrill_tpu.net.tcp import join_tcp_group as jjoin
    for join in (join_tcp_group, jjoin):
        with pytest.raises(ValueError, match="outside hostlist"):
            join(2, [("127.0.0.1", 1), ("127.0.0.1", 2)], 1)
