"""The host-storage data plane (counterpart of the reference package's
``data/multiplexer.py``; Thrill: thrill/data/multiplexer.cpp:282-440).

Items that cannot live in device columns (strings, variable-shape
pytrees) are per-worker Python lists (``HostShards``). In one process
every list is here: the exchange buckets items in process and the
replication helpers are identities. In a mesh of several processes a
``HostShards`` holds items only for the workers this process owns, every
other list empty, and the helpers move items between processes over the
host control plane (``mex.host_net``, a FlowControlChannel over the TCP
group of net/tcp.py):

* ``host_exchange``: a per-item destination shuffle; each receiving
  worker sees its batches in source-worker rank order (the CatStream
  order, thrill/data/cat_stream.hpp:155).
* ``ensure_replicated``: every process gets every worker's items (for
  host ops that need a global view), and ``localize`` drops the other
  processes' lists again.
* ``split_even``: a replicated item list split evenly, localized.
* ``barrier``: every process reaches it before any goes on.
* ``global_counts``, ``global_total``, ``all_items``, ``net_fold``:
  agreed counts and folds.
* ``host_to_device``: HostShards to DeviceShards with a capacity and a
  schema agreed by every process.

Frames are sent synchronously. Two processes that both send a frame
larger than the socket buffers before reading would wait on each other,
so the peers are paired in the rounds of a 1-factorization and, in each
pair, the lower rank sends first and the higher receives first. The
reference's background sender (``_exchange_frames_async``) and its
arrival-order delivery (``THRILL_TPU_HOST_MIX``) wait with the
asynchronous dispatcher, a later part of ROADMAP.md item 6.

Items moved count, on every process, the items its workers send to
another worker (in one process, those that change worker), so the sum
over the processes is the one-process count. Bytes moved between
processes are ``stats_bytes_wire_host``, as the transport measured them.

Tracing: every host exchange is a ``host`` span ``host_exchange`` with
its ``reason`` and ``mode`` (``local``: in-process bucketing; ``serial``:
framed batches over the TCP group).
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np

from ..common import faults
from ..common.retry import default_policy
from ..common.trace import span_of
from ..net.group import poison_on_error
from .shards import DeviceShards, HostShards, columnarize

_MISSING = "__thrill_tpu_missing__"

# frame-level injection: fires before the frame reaches the transport,
# so a retry is safe (nothing was sent); a real transport error in
# mid-stream is permanent (the stream position is lost)
_F_SEND = faults.declare("net.multiplexer.frame_send",
                         exc=faults.InjectedConnectionError)
_F_RECV = faults.declare("net.multiplexer.frame_recv",
                         exc=faults.InjectedConnectionError)
_FRAME_RETRY = dict(transient=(faults.InjectedConnectionError,))


def _frame_bytes(msg: Any) -> int:
    """Serialized size of one frame, for transports that pass objects
    by reference (the mock network) and report no byte count."""
    try:
        from ..net import wire
        return len(wire.dumps(msg, allow_pickle=True))
    except Exception:
        return 0


def _send_frame(group, peer: int, msg: Any, what: str) -> int:
    """Send one frame; returns its wire byte count."""
    if not faults.REGISTRY.active():
        nb = group.send_to(peer, msg)
    else:
        def op():
            faults.check(_F_SEND, peer=peer, what=what)
            return group.send_to(peer, msg)
        nb = default_policy(**_FRAME_RETRY).run(op, what=f"{what}:send")
    return nb if nb is not None else _frame_bytes(msg)


def _recv_frame(group, peer: int, what: str) -> Any:
    if not faults.REGISTRY.active():
        return group.recv_from(peer)

    def op():
        faults.check(_F_RECV, peer=peer, what=what)
        return group.recv_from(peer)
    return default_policy(**_FRAME_RETRY).run(op, what=f"{what}:recv")


def pair_rounds(P: int, me: int) -> List[int]:
    """This process's partner in each round of a 1-factorization of
    ``P`` processes (the circle method; an odd ``P`` has a bye, -1): every
    pair of processes meets in exactly one round."""
    n = P + (P % 2)
    out = []
    for r in range(n - 1):
        if me == n - 1:
            partner = next(i for i in range(n - 1)
                           if (2 * r - i) % (n - 1) == i)
        else:
            j = (2 * r - me) % (n - 1)
            partner = n - 1 if j == me else j
        out.append(partner if partner < P else -1)
    return out


def multiprocess(mex) -> bool:
    """Is the host plane split across processes? A multi-process mesh
    without a host control plane raises here: each process holds only
    its workers' items and could not ship the rest."""
    if getattr(mex, "num_processes", 1) <= 1:
        return False
    _net(mex)
    return True


def _net(mex):
    net = getattr(mex, "host_net", None)
    if net is None or net.num_workers != mex.num_processes:
        raise RuntimeError(
            "a multi-process host-storage pipeline needs the host control "
            "plane: set THRILL_TPU_HOSTLIST/RANK/SECRET so every process "
            "joins the TCP group")
    return net


def local_worker_set(mex) -> set:
    """Workers this process holds host items for: all in one process,
    its own block across processes."""
    if multiprocess(mex):
        return set(mex.local_workers)
    return set(range(mex.num_workers))


def host_exchange(mex, shards: HostShards, dest_fn: Callable[[Any], int],
                  reason: str = "host-exchange") -> HostShards:
    """Every item to worker ``dest_fn(item) % W``. Each receiver gets its
    items in source-worker rank order, each source's in its order (the
    CatStream order, thrill/data/cat_stream.hpp:155). Across processes
    this process buckets its local workers' items and ships each other
    process one framed ``{dest_worker: {src_worker: [items]}}``."""
    W = shards.num_workers
    if not multiprocess(mex):
        buckets: List[List[Any]] = [[] for _ in range(W)]
        moved = 0
        with span_of(getattr(mex, "tracer", None), "host", "host_exchange",
                     reason=reason, mode="local"):
            for src, items in enumerate(shards.lists):
                for it in items:
                    w = dest_fn(it) % W
                    buckets[w].append(it)
                    moved += w != src
        mex.stats_exchanges += 1
        mex.stats_items_moved += moved
        return HostShards(W, buckets)

    net = _net(mex)
    wp = mex.worker_process
    me = mex.process_index
    P = mex.num_processes
    outgoing: List[dict] = [dict() for _ in range(P)]
    moved = 0
    for sw in mex.local_workers:
        for it in shards.lists[sw]:
            dw = int(dest_fn(it)) % W
            moved += dw != sw
            outgoing[int(wp[dw])].setdefault(dw, {}).setdefault(
                sw, []).append(it)
    received = [outgoing[me]]
    wire_bytes = 0
    group = net.group
    with span_of(getattr(mex, "tracer", None), "host", "host_exchange",
                 reason=reason, mode="serial"), \
            poison_on_error(group, "host_exchange"), \
            group._at("host_exchange"):
        for peer in pair_rounds(P, me):
            if peer < 0:
                continue
            # the lower rank of a pair sends first: two blocking senders
            # never wait on each other
            if me < peer:
                wire_bytes += _send_frame(group, peer, outgoing[peer],
                                          "host_exchange")
                received.append(_recv_frame(group, peer, "host_exchange"))
            else:
                received.append(_recv_frame(group, peer, "host_exchange"))
                wire_bytes += _send_frame(group, peer, outgoing[peer],
                                          "host_exchange")
    lists: List[List[Any]] = [[] for _ in range(W)]
    for w in mex.local_workers:
        per_src: dict = {}
        for msg in received:
            per_src.update(msg.get(w, {}))
        for sw in sorted(per_src):
            lists[w].extend(per_src[sw])
    mex.stats_exchanges += 1
    mex.stats_items_moved += moved
    mex.stats_bytes_wire_host = getattr(mex, "stats_bytes_wire_host",
                                        0) + wire_bytes
    log = getattr(mex, "logger", None)
    if log is not None and log.enabled:
        log.line(event="host_exchange", reason=reason, items_sent=moved,
                 processes=P, bytes=wire_bytes, mode="cat",
                 async_send=False)
    return HostShards(W, lists)


def ensure_replicated(mex, shards: HostShards,
                      reason: str = "host-global") -> HostShards:
    """Every worker's items on every process (the shards themselves in
    one process). Each worker's list is taken from its owner only."""
    if not multiprocess(mex):
        return shards
    net = _net(mex)
    W = shards.num_workers
    local = {w: shards.lists[w] for w in mex.local_workers
             if shards.lists[w]}
    with poison_on_error(net.group, "host_replicate"):
        gathered = net.all_gather(local)
    lists: List[List[Any]] = [[] for _ in range(W)]
    for msg in gathered:
        for w, items in msg.items():
            lists[int(w)] = list(items)
    log = getattr(mex, "logger", None)
    if log is not None and log.enabled:
        log.line(event="host_replicate", reason=reason,
                 items=sum(len(l) for l in lists))
    return HostShards(W, lists)


def localize(mex, shards: HostShards) -> HostShards:
    """Each process keeps its own workers' lists (all of them in one
    process)."""
    if not multiprocess(mex):
        return shards
    local = set(mex.local_workers)
    return HostShards(shards.num_workers,
                      [shards.lists[w] if w in local else []
                       for w in range(shards.num_workers)])


def split_even(mex, items: List[Any], W: int) -> HostShards:
    """A global item list, the same on every process, split evenly over
    ``W`` workers by ``dense_range_bounds``; each process keeps its own
    workers' lists."""
    return localize(mex, HostShards(1, [items]).repartition(W))


def barrier(mex) -> None:
    """Every process reaches this point before any goes on (nothing in
    one process): a writer's files are all written when it returns."""
    if multiprocess(mex):
        net = _net(mex)
        with poison_on_error(net.group, "barrier"):
            net.barrier()


def global_counts(mex, shards: HostShards) -> np.ndarray:
    """Every worker's item count, agreed across processes."""
    if not multiprocess(mex):
        return shards.counts
    net = _net(mex)
    counts = np.zeros(shards.num_workers, dtype=np.int64)
    local = {w: len(shards.lists[w]) for w in mex.local_workers}
    with poison_on_error(net.group, "global_counts"):
        gathered = net.all_gather(local)
    for msg in gathered:
        for w, n in msg.items():
            counts[int(w)] = int(n)
    return counts


def global_total(mex, shards: HostShards) -> int:
    if not multiprocess(mex):
        return shards.total
    return int(_net(mex).all_reduce(
        sum(len(shards.lists[w]) for w in mex.local_workers)))


def global_lists(mex, lists: List[list]) -> List[list]:
    """Every worker's entry of the per-worker ``lists`` (the local
    workers' filled), gathered over the host control plane across
    processes: the fingerprints of the duplicate and location
    detections, which every process must agree on."""
    if not multiprocess(mex):
        return lists
    out: List[list] = [[] for _ in range(len(lists))]
    with poison_on_error(_net(mex).group, "global_lists"):
        gathered = _net(mex).all_gather(
            {w: lists[w] for w in mex.local_workers})
    for msg in gathered:
        for w, v in msg.items():
            out[int(w)] = v
    return out


def all_items(mex, shards: HostShards) -> List[Any]:
    """Every item in worker-rank order, on every process."""
    return [it for l in ensure_replicated(mex, shards, "all-items").lists
            for it in l]


def net_fold(mex, local: Any, op: Callable[[Any, Any], Any],
             empty: bool = False) -> Any:
    """The rank-ordered fold of every process's partial (``local``
    ignored when ``empty``); ValueError when every process was empty."""
    if not multiprocess(mex):
        if empty:
            raise ValueError("fold over an empty DIA")
        return local
    net = _net(mex)
    with poison_on_error(net.group, "net_fold"):
        vals = net.all_gather(_MISSING if empty else local)
    vals = [v for v in vals if not (isinstance(v, str) and v == _MISSING)]
    if not vals:
        raise ValueError("fold over an empty DIA")
    acc = vals[0]
    for v in vals[1:]:
        acc = op(acc, v)
    return acc


def host_to_device(mex, shards: HostShards) -> DeviceShards:
    """HostShards to DeviceShards across processes: the capacity (the
    shapes must match), every worker's count and the item schema (a
    process whose workers are all empty still builds zero rows of the
    right shape) are agreed first."""
    from ..common import tree as pt
    counts = global_counts(mex, shards)
    net = _net(mex)
    sample = next((shards.lists[w][0] for w in mex.local_workers
                   if shards.lists[w]), None)
    samples = net.all_gather(_MISSING if sample is None else sample)
    sample = next((s for s in samples
                   if not (isinstance(s, str) and s == _MISSING)), None)
    if sample is None:
        raise ValueError("cannot infer schema of an entirely empty DIA")
    empty = pt.tree_map(lambda a: np.asarray([a])[:0], sample)
    local = set(mex.local_workers)
    per_worker = [columnarize(shards.lists[w])
                  if w in local and shards.lists[w] else empty
                  for w in range(shards.num_workers)]
    return DeviceShards.from_worker_arrays(mex, per_worker, counts=counts)
