"""The host-storage data plane on one controller (counterpart of the
single-controller part of the reference package's
``data/multiplexer.py``; Thrill: thrill/data/multiplexer.cpp:282-440).

Every worker's item list lives in this process, so the exchange buckets
items in process and the replication helpers are identities. A mesh of
several processes (``num_processes > 1``) raises NotImplementedError:
its TCP data plane is ROADMAP.md queue A "Still to port" item 6.

Tracing: every host exchange is a ``host`` span ``host_exchange`` with
its ``reason`` and ``mode`` (``local``: in-process bucketing). The
reference opens its span only across processes, around the frames it
sends; one controller has no frames, and the span times the bucketing.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np

from ..common.trace import span_of
from .shards import HostShards


def _one_controller(mex, what: str) -> None:
    if getattr(mex, "num_processes", 1) > 1:
        raise NotImplementedError(
            f"{what} across processes is not ported yet: multi-process "
            f"host storage is ROADMAP.md queue A 'Still to port' item 6")


def host_exchange(mex, shards: HostShards, dest_fn: Callable[[Any], int],
                  reason: str = "host-exchange") -> HostShards:
    """Every item to worker ``dest_fn(item) % W``. Each receiver gets its
    items in source-worker rank order, each source's in its order (the
    CatStream order, thrill/data/cat_stream.hpp:155). Items that change
    worker count into the mesh's exchange traffic."""
    _one_controller(mex, f"host_exchange ({reason})")
    W = shards.num_workers
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


def ensure_replicated(mex, shards: HostShards,
                      reason: str = "host-global") -> HostShards:
    """Every worker's items on every process: the shards themselves."""
    _one_controller(mex, f"ensure_replicated ({reason})")
    return shards


def localize(mex, shards: HostShards) -> HostShards:
    """Each process keeps its own workers' lists: all of them."""
    _one_controller(mex, "localize")
    return shards


def global_counts(mex, shards: HostShards) -> np.ndarray:
    _one_controller(mex, "global_counts")
    return shards.counts


def global_total(mex, shards: HostShards) -> int:
    _one_controller(mex, "global_total")
    return shards.total


def all_items(mex, shards: HostShards) -> List[Any]:
    """Every item in worker-rank order."""
    return [it for l in ensure_replicated(mex, shards, "all-items").lists
            for it in l]


def net_fold(mex, local: Any, op: Callable[[Any, Any], Any],
             empty: bool = False) -> Any:
    """The fold of every process's partial: this process's ``local``;
    ValueError when it is ``empty``."""
    _one_controller(mex, "net_fold")
    if empty:
        raise ValueError("fold over an empty DIA")
    return local
