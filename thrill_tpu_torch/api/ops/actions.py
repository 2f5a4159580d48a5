"""Actions: graph sinks that run the graph and return results
(counterpart of Size, AllGather, AllGatherArrays, Sum, Min, Max and
AllReduce in the reference package's ``api/ops/actions.py``)."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ...common import tree as pt
from .reduce import _type_max, _type_min


def _pull(dia):
    return dia._link().pull(consume=True)


def Size(dia) -> int:
    return _pull(dia).total


def AllGatherArrays(dia):
    """The items as one pytree of tensors ``[total, ...]`` on the
    device, worker-rank order, sliced from the shards without a host
    copy."""
    shards = _pull(dia)
    counts = [int(c) for c in shards.counts]

    def cat(leaf):
        parts = [leaf[w, :c] for w, c in enumerate(counts) if c]
        if not parts:
            return leaf[0, :0]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    return pt.tree_map(cat, shards.tree)


def AllGather(dia) -> list:
    """The items as a host list: scalar leaves as Python numbers, array
    leaves as numpy rows, in the item's own pytree shape."""
    leaves, td = pt.flatten(pt.tree_map(
        lambda t: t.detach().cpu().numpy(), AllGatherArrays(dia)))
    cols = [l.tolist() if l.ndim == 1 else list(l) for l in leaves]
    if td is pt.LEAF:
        return cols[0]
    return [pt.unflatten(td, list(vals)) for vals in zip(*cols)]


def _device_reduce(shards, mode: str, keep_device: bool = False):
    """Each worker folds its valid rows, then the W partials fold (the
    reference's masked local fold plus psum/pmin/pmax; integer sums in
    int64, as there). Leaves come back
    as tensors on the device, or as host values: Python numbers for
    scalar leaves, numpy arrays otherwise."""
    mask = shards.valid_mask()

    def fold(leaf):
        m = mask.reshape(mask.shape + (1,) * (leaf.dim() - 2))
        if mode == "sum":
            return torch.where(m, leaf, torch.zeros((), dtype=leaf.dtype,
                                                    device=leaf.device)
                               ).sum(dim=1).sum(dim=0)
        fill = _type_max(leaf.dtype) if mode == "min" else _type_min(
            leaf.dtype)
        x = torch.where(m, leaf, torch.full((), fill, dtype=leaf.dtype,
                                            device=leaf.device))
        if mode == "min":
            return x.amin(dim=1).amin(dim=0)
        return x.amax(dim=1).amax(dim=0)

    out = pt.tree_map(fold, shards.tree)
    if keep_device:
        return out
    host = [t.detach().cpu().numpy() for t in pt.leaves(out)]
    return pt.unflatten(pt.flatten(out)[1],
                        [h.item() if h.ndim == 0 else h for h in host])


def Sum(dia, initial: Any = 0, device: bool = False) -> Any:
    """The item-wise sum; ``initial`` for an empty DIA, else added to the
    sum unless it is zero or None (a matching pytree, or one scalar for
    every leaf). ``device=True`` returns tensors on the device, to be fed
    back into a Bind without a host copy."""
    shards = _pull(dia)
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
    if shards.total == 0:
        raise ValueError("Min/Max of empty DIA")
    return _device_reduce(shards, "min" if is_min else "max")


def AllReduce(dia, fn: Callable, initial: Any = None) -> Any:
    """A generic associative fold of every item, on the host."""
    items = AllGather(dia)
    if not items:
        if initial is None:
            raise ValueError("AllReduce of empty DIA without initial")
        return initial
    acc = items[0] if initial is None else fn(initial, items[0])
    for it in items[1:]:
        acc = fn(acc, it)
    return acc
