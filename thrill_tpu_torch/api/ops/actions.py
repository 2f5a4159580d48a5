"""Actions: graph sinks that run the graph and return results
(counterpart of Size, AllGather, AllGatherArrays, Gather, Print, Sum,
Min, Max and AllReduce in the reference package's
``api/ops/actions.py``). On host storage Sum, Min, Max and AllReduce
fold the items in Python, in worker-rank order, as the reference does.
Across processes every action gathers from every process: device rows
through :meth:`MeshExec.gather_workers`, host items through the
multiplexer (``all_items``, ``global_total``), so every process returns
the one-process result."""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from ...common import tree as pt
from ...core import unsigned
from ...data import multiplexer
from ...data.shards import HostShards, itemize
from ...parallel.mesh import current_mex
from .reduce import _type_max, _type_min


def _pull(dia):
    return dia._link().pull(consume=True)


def Size(dia) -> int:
    shards = _pull(dia)
    if isinstance(shards, HostShards):
        return multiplexer.global_total(dia.context.mesh_exec, shards)
    return shards.total


def AllGatherArrays(dia):
    """The items as one pytree of tensors ``[total, ...]`` on the
    device, worker-rank order, sliced from the shards without a host
    copy. Host storage gives numpy-stacked leaves of the same tree
    shape, and an empty host DIA ``[]``: its item structure is unknown
    without items. The deferred checks drain first, so no result of an
    unchecked hinted join leaves through the columns. While a loop
    capture runs (api/loop.py) the slicing is one program, so a loop
    that closes through this action (k-means' centers) can be replayed
    (reference: ``thrill_tpu/api/ops/actions.py:80-103``)."""
    shards = _pull(dia)
    mex = dia.context.mesh_exec
    mex.drain_checks()
    if isinstance(shards, HostShards) and mex.multiprocess:
        shards = multiplexer.ensure_replicated(mex, shards,
                                               "allgather-arrays")
    if mex.loop_recorder is not None and not isinstance(shards, HostShards):
        counts = tuple(int(c) for c in shards.global_counts)
        leaves, td = pt.flatten(shards.tree)
        prog = mex.program(("allgather_arrays", shards.cap, counts, td,
                            tuple((l.dtype, tuple(l.shape[2:]))
                                  for l in leaves)), _concat_program)
        return pt.unflatten(td, prog(leaves, counts))
    return _gather_arrays(shards)


def _concat_program(leaves, counts):
    """Program: each leaf's valid rows of every worker (every process's,
    across processes), concatenated."""
    mex = current_mex()
    return [_concat_valid(l if mex is None else mex.gather_workers(l),
                          counts) for l in leaves]


def _concat_valid(leaf, counts):
    parts = [leaf[w, :c] for w, c in enumerate(counts) if c]
    if not parts:
        return leaf[0, :0]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _gather_arrays(shards):
    if isinstance(shards, HostShards):
        items = [it for l in shards.lists for it in l]
        if not items:
            return []
        flat = [pt.flatten(it) for it in items]
        return pt.unflatten(flat[0][1], [
            np.stack([f[0][i] for f in flat])
            for i in range(len(flat[0][0]))])
    mex = shards.mesh_exec
    counts = [int(c) for c in shards.global_counts]
    return pt.tree_map(lambda l: _concat_valid(mex.gather_workers(l),
                                               counts), shards.tree)


def AllGather(dia) -> list:
    """The items as a host list in worker-rank order: host items as
    they are; device scalar leaves as Python numbers, array leaves as
    numpy rows, in the item's own pytree shape."""
    return _items(dia.context.mesh_exec, _pull(dia), "allgather-action")


def _items(mex, shards, reason: str) -> list:
    """The items on the host; leaving device storage logs
    ``event=device_to_host`` with ``reason``, as every demotion does."""
    if isinstance(shards, HostShards):
        shards = multiplexer.ensure_replicated(mex, shards, reason)
    if isinstance(shards, HostShards):
        return [it for l in shards.lists for it in l]
    # through the mesh's fetch: counted, and the deferred checks drain
    mex = shards.mesh_exec
    mex.drain_checks()
    out = itemize(pt.tree_map(mex.fetch, _gather_arrays(shards)))
    log = mex.logger
    if log is not None and log.enabled:
        log.line(event="device_to_host", reason=reason, items=len(out))
    return out


def Gather(dia, root: int = 0) -> list:
    """The items of the whole DIA, delivered to worker ``root`` (Thrill:
    ``api/gather.hpp``). One process is every worker here, so it gets
    them all, in worker-rank order."""
    return _items(dia.context.mesh_exec, _pull(dia), "gather-action")


def Print(dia, label: str = "", limit: int = 100) -> None:
    """Print the item count and the first ``limit`` items."""
    items = AllGather(dia)
    head = items[:limit]
    suffix = (f" ... (+{len(items) - limit} more)" if len(items) > limit
              else "")
    print(f"[{label or 'DIA'}] n={len(items)}: {head}{suffix}")


def _device_reduce(shards, mode: str, keep_device: bool = False):
    """Each worker folds its valid rows, then the W partials fold in
    worker order, every process's partials gathered first (the
    reference's masked local fold plus psum/pmin/pmax; integer sums in
    int64, as there). Leaves come back
    as tensors on the device, or as host values: Python numbers for
    scalar leaves, numpy arrays otherwise."""
    mask = shards.valid_mask()
    gather = shards.mesh_exec.gather_workers

    def fold(leaf):
        m = mask.reshape(mask.shape + (1,) * (leaf.dim() - 2))
        if mode == "sum":
            return gather(torch.where(m, leaf, torch.zeros(
                (), dtype=leaf.dtype, device=leaf.device)).sum(dim=1)
                          ).sum(dim=0)
        fill = _type_max(leaf.dtype) if mode == "min" else _type_min(
            leaf.dtype)
        x = torch.where(m, leaf, torch.full((), fill, dtype=leaf.dtype,
                                            device=leaf.device))
        if mode == "min":
            return gather(x.amin(dim=1)).amin(dim=0)
        return gather(x.amax(dim=1)).amax(dim=0)

    with unsigned.scope_for(shards.tree):
        out = pt.tree_map(fold, shards.tree)
    if keep_device:
        return out
    host = [shards.mesh_exec.fetch(t) for t in pt.leaves(out)]
    return pt.unflatten(pt.flatten(out)[1],
                        [h.item() if h.ndim == 0 else h for h in host])


def Sum(dia, initial: Any = 0, device: bool = False) -> Any:
    """The item-wise sum; ``initial`` for an empty DIA, else added to the
    sum unless it is zero or None (a matching pytree, or one scalar for
    every leaf). ``device=True`` returns tensors on the device, to be fed
    back into a Bind without a host copy (device storage only). Host
    items fold with ``+`` from ``initial``."""
    shards = _pull(dia)
    if isinstance(shards, HostShards):
        items = multiplexer.all_items(dia.context.mesh_exec, shards)
        return functools.reduce(lambda a, b: a + b, items, initial)
    if shards.total == 0:
        return initial
    reduced = _device_reduce(shards, "sum", keep_device=device)
    if initial is None or (np.isscalar(initial) and initial == 0):
        return reduced
    if pt.flatten(initial)[1] == pt.flatten(reduced)[1]:
        return pt.tree_map(lambda r, i: r + i, reduced, initial)
    return pt.tree_map(lambda r: r + initial, reduced)


def MinMax(dia, is_min: bool) -> Any:
    shards = _pull(dia)
    if isinstance(shards, HostShards):
        mex = dia.context.mesh_exec
        items = multiplexer.all_items(mex, shards)
        pick = min if is_min else max
        try:
            return multiplexer.net_fold(mex, pick(items) if items else None,
                                        pick, empty=not items)
        except ValueError:
            raise ValueError("Min/Max of empty DIA") from None
    if shards.total == 0:
        raise ValueError("Min/Max of empty DIA")
    return _device_reduce(shards, "min" if is_min else "max")


def AllReduce(dia, fn: Callable, initial: Any = None) -> Any:
    """A generic associative fold of every item, on the host, in
    worker-rank order."""
    items = _items(dia.context.mesh_exec, _pull(dia), "allreduce-action")
    if not items:
        if initial is None:
            raise ValueError("AllReduce of empty DIA without initial")
        return initial
    acc = items[0] if initial is None else fn(initial, items[0])
    for it in items[1:]:
        acc = fn(acc, it)
    return acc
