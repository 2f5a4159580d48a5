"""Source operations: Generate, Distribute/EqualToDIA and ConcatToDIA
(counterpart of the reference package's ``api/ops/sources.py``).

Storage is "device" (columnar tensors) or "host" (per-worker Python
lists of items of any type). Left unset, it is inferred as in the
reference: columnar input (an array, a tensor, a dict of them) and
items whose leaves are all numbers (ints, floats, bools, numpy scalars
or arrays, in tuples and dicts) go to the device, as columns; other
items go to the host; an empty sequence takes the default, the device.
ConcatToDIA defaults to the host, as the reference's does.

Across processes (``RunDistributed``) Generate and Distribute take the
same input on every process and each process keeps its own workers'
part; ConcatToDIA keeps the lists of the local workers (the local
portion) and drops the rest.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...data.multiplexer import local_worker_set, localize
from ...data.shards import (DeviceShards, HostShards, columnarize,
                            round_up_pow2)
from ..dia import DIA
from ..dia_base import DIABase
from ..stack import _broadcast_outputs

_NUMERIC = (int, float, bool, np.generic, np.ndarray)


class GenerateNode(DIABase):
    """Indices ``[0, size)`` split evenly; on the device ``fn`` maps a
    batch of int64 indices to items, on the host one index."""

    def __init__(self, ctx, size: int, fn: Optional[Callable],
                 storage: str) -> None:
        super().__init__(ctx, "Generate")
        self.size = int(size)
        self.fn = fn
        self.storage = storage

    def compute(self):
        mex = self.context.mesh_exec
        W = mex.num_workers
        bnd = dense_range_bounds(self.size, W)
        if self.storage == "host":
            fn = self.fn or (lambda i: i)
            local = local_worker_set(mex)
            return HostShards(W, [[fn(i) for i in range(bnd[w], bnd[w + 1])]
                                  if w in local else [] for w in range(W)])
        counts = np.diff(bnd)
        cap = round_up_pow2(int(counts.max()))
        lo, Wl = mex.worker_base, mex.num_local
        # one program, as the reference's (a loop capture records it)
        prog = mex.program(("generate", self.fn, Wl, cap), _generate)
        return DeviceShards(mex, prog(mex.put_small(bnd[lo:lo + Wl]),
                                      self.fn, Wl, cap, mex.device),
                            counts[lo:lo + Wl])


class DistributeNode(DIABase):
    """A global collection split evenly, order preserved: on the device,
    columnar input as it is and a sequence of items as columns; on the
    host, the items themselves."""

    def __init__(self, ctx, items, storage: Optional[str]) -> None:
        super().__init__(ctx, "Distribute")
        # a generator is read once: materialize it before the probe
        if not _is_columnar(items) and not isinstance(items, (list, tuple)):
            items = list(items)
        self.storage = _storage(storage, items)
        self.items = (list(items) if self.storage == "host"
                      else _columnarize(items))

    def compute(self):
        mex = self.context.mesh_exec
        if self.storage == "host":
            W = mex.num_workers
            bnd = dense_range_bounds(len(self.items), W)
            local = local_worker_set(mex)
            return HostShards(W, [self.items[bnd[w]:bnd[w + 1]]
                                  if w in local else [] for w in range(W)])
        return DeviceShards.from_global_numpy(mex, self.items)


class ConcatToDIANode(DIABase):
    """Worker ``w``'s list placed exactly on worker ``w``."""

    def __init__(self, ctx, per_worker, storage: Optional[str]) -> None:
        super().__init__(ctx, "ConcatToDIA")
        W = ctx.num_workers
        lists = [list(l) for l in per_worker]
        if len(lists) < W:
            lists += [[] for _ in range(W - len(lists))]
        elif len(lists) > W:
            # the extra lists fold into the last worker, in order
            lists = lists[:W - 1] + [[it for l in lists[W - 1:] for it in l]]
        self.lists = lists
        self.storage = _check_storage(storage or "host", "ConcatToDIA")

    def compute(self):
        shards = localize(self.context.mesh_exec,
                          HostShards(self.context.num_workers, self.lists))
        if self.storage == "device":
            return shards.to_device(self.context.mesh_exec)
        return shards


def _is_columnar(items) -> bool:
    """Columnar input: a global array or tensor, or a dict pytree of
    equal-length ones (struct of arrays). Lists and tuples are item
    sequences."""
    if isinstance(items, np.ndarray) or hasattr(items, "dtype"):
        return True
    if isinstance(items, dict):
        leaves = pt.leaves(items)
        return bool(leaves) and all(
            isinstance(l, np.ndarray) or hasattr(l, "dtype") for l in leaves)
    return False


def _infer_storage(items) -> str:
    """"device" for columnar input, an empty sequence, or numeric items
    (probed on the first); "host" otherwise."""
    if _is_columnar(items):
        return "device"
    for probe in items:
        leaves = pt.leaves(probe)
        return ("device" if leaves and all(isinstance(l, _NUMERIC)
                                           for l in leaves) else "host")
    return "device"


def _check_storage(storage: str, op: str) -> str:
    if storage not in ("device", "host"):
        raise ValueError(f"{op}: unknown storage {storage!r}")
    return storage


def _storage(asked: Optional[str], items) -> str:
    return _check_storage(asked or _infer_storage(items), "Distribute")


def _columnarize(items):
    """Columnar input as it is (a tensor, on the card too, is not
    fetched), or a sequence of item pytrees as one numpy column a
    leaf."""
    if _is_columnar(items):
        return pt.tree_map(lambda l: l if isinstance(l, torch.Tensor)
                           else np.asarray(l), items)
    items = list(items)
    if not items:
        raise ValueError("cannot infer schema of empty device DIA; "
                         "use storage='host'")
    return columnarize(items)


def Generate(ctx, size, fn=None, storage=None) -> DIA:
    return DIA(GenerateNode(ctx, size, fn,
                            _check_storage(storage or "device", "Generate")))


def Distribute(ctx, items, storage=None) -> DIA:
    return DIA(DistributeNode(ctx, items, storage))


def ConcatToDIA(ctx, per_worker, storage=None) -> DIA:
    """Worker ``w`` holds ``per_worker[w]``; missing workers hold no
    items, lists past the last worker fold into it, in order. Host
    storage unless ``storage="device"``."""
    return DIA(ConcatToDIANode(ctx, per_worker, storage))


def _generate(starts: torch.Tensor, fn, W: int, cap: int, device):
    """Program: ``fn`` of every worker's global indices as ``[W, cap,
    ...]`` leaves (the indices themselves without ``fn``)."""
    idx = (starts[:, None]
           + torch.arange(cap, device=device)[None, :]).reshape(-1)
    tree = idx if fn is None else _broadcast_outputs(fn(idx), W * cap,
                                                     device)
    return pt.tree_map(lambda l: l.reshape((W, cap) + tuple(l.shape[1:])),
                       tree)
