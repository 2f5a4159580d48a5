"""Source operations: Generate, Distribute/EqualToDIA and ConcatToDIA,
device storage only (counterpart of the reference package's
``api/ops/sources.py``).

A list, a tuple or a generator of numeric item pytrees (ints, floats,
bools, numpy scalars or arrays, tuples and dicts of them) becomes
columns, as in the reference. Items that need host storage (strings,
objects) and ``storage="host"`` raise: the port has no host storage yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...data.shards import DeviceShards, round_up_pow2
from ..dia import DIA
from ..dia_base import DIABase
from ..stack import _broadcast_outputs

_NUMERIC = (int, float, bool, np.generic, np.ndarray)


class GenerateNode(DIABase):
    """Indices ``[0, size)`` split evenly; ``fn`` maps a batch of int64
    indices to items."""

    def __init__(self, ctx, size: int, fn: Optional[Callable]) -> None:
        super().__init__(ctx, "Generate")
        self.size = int(size)
        self.fn = fn

    def compute(self) -> DeviceShards:
        mex = self.context.mesh_exec
        W = mex.num_workers
        bnd = dense_range_bounds(self.size, W)
        counts = np.diff(bnd)
        cap = round_up_pow2(int(counts.max()))
        idx = (mex.put_small(bnd[:W])[:, None]
               + torch.arange(cap, device=mex.device)[None, :]).reshape(-1)
        tree = idx if self.fn is None else _broadcast_outputs(
            self.fn(idx), W * cap, mex.device)
        tree = pt.tree_map(
            lambda l: l.reshape((W, cap) + tuple(l.shape[1:])), tree)
        return DeviceShards(mex, tree, counts)


class DistributeNode(DIABase):
    """A global collection split evenly, order preserved: columnar input
    (an array, a tensor, or a dict of equal-length ones) as it is, a
    sequence of numeric items as columns."""

    def __init__(self, ctx, items, storage: Optional[str]) -> None:
        super().__init__(ctx, "Distribute")
        # a generator is read once: materialize it before the probe
        if not _is_columnar(items) and not isinstance(items, (list, tuple)):
            items = list(items)
        _check_device_storage(storage, _infer_storage(items), "Distribute")
        self.items = _columnarize(items)

    def compute(self) -> DeviceShards:
        return DeviceShards.from_global_numpy(self.context.mesh_exec,
                                              self.items)


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
        items = [it for l in lists for it in l]
        _check_device_storage(storage, _infer_storage(items), "ConcatToDIA")
        self.counts = np.array([len(l) for l in lists], dtype=np.int64)
        self.items = _columnarize(items)

    def compute(self) -> DeviceShards:
        return DeviceShards.from_global_numpy(self.context.mesh_exec,
                                              self.items, self.counts)


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


def _check_device_storage(asked: Optional[str], inferred: str,
                          op: str) -> None:
    if asked not in (None, "device", "host"):
        raise ValueError(f"{op}: unknown storage {asked!r}")
    if asked == "host" or inferred == "host":
        raise NotImplementedError(
            f"{op}: host storage (items of any Python type, and "
            f"storage='host') is not ported yet; it is ROADMAP queue A "
            f"'Still to port' item 1. The port takes numeric items: "
            f"ints, floats, bools, numpy scalars or arrays, and tuples "
            f"and dicts of them")


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
    rows = [pt.flatten(it) for it in items]
    td = rows[0][1]
    cols = [np.asarray([r[0][i] for r in rows])
            for i in range(len(rows[0][0]))]
    return pt.unflatten(td, cols)


def Generate(ctx, size, fn=None) -> DIA:
    return DIA(GenerateNode(ctx, size, fn))


def Distribute(ctx, items, storage=None) -> DIA:
    return DIA(DistributeNode(ctx, items, storage))


def ConcatToDIA(ctx, per_worker, storage=None) -> DIA:
    """Worker ``w`` holds ``per_worker[w]``; missing workers hold no
    items, lists past the last worker fold into it, in order. The
    reference's default is host storage; the port has none yet, so it
    builds device shards straight from the per-worker counts, for
    numeric items only."""
    return DIA(ConcatToDIANode(ctx, per_worker, storage))
