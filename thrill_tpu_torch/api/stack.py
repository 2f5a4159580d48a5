"""Local operation (LOp) stacks: Map, Filter and the device FlatMap as
batched column functions (counterpart of the reference package's
``api/stack.py``).

A DIA handle carries a tuple of StackOps; the consuming operator applies
them to its parent's shards in one go. ``fn`` sees the item pytree with
a leading item axis over all workers' rows (``[W * cap, ...]`` leaves):
elementwise lambdas (``lambda x: x * 2``, ``lambda r: r["key"]``) read
as per-item code, and scalar outputs are broadcast to the item axis.
A ``flat_map`` op's ``fn(tree) -> (tree[n, k, ...], valid[n, k])``
expands every item into ``k`` candidates, of which the valid ones stay.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ..common import tree as pt
from ..data.shards import DeviceShards, compact_valid


class Bind:
    """A stack function with bound array operands: ``Bind(fn, *operands)``
    behaves like ``lambda t: fn(t, *operands)``, the operands (pytrees of
    arrays, tensors or numbers) becoming tensors on the device of the
    items it is called on, with their values at the call. There is no
    trace cache to key: the reference binds operands so that its compiled
    programs take them as arguments; here Bind only carries them."""

    __slots__ = ("fn", "operands")

    def __init__(self, fn: Callable, *operands: Any) -> None:
        self.fn = fn
        self.operands = operands

    def __call__(self, tree):
        leaves = [l for l in pt.leaves(tree) if isinstance(l, torch.Tensor)]
        dev = leaves[0].device if leaves else torch.device("cpu")
        return self.fn(tree, *pt.tree_map(
            lambda o: torch.as_tensor(o, device=dev), self.operands))


@dataclasses.dataclass(frozen=True)
class StackOp:
    kind: str                      # 'map' | 'filter' | 'flat_map'
    fn: Callable
    # flat_map only: the static expansion factor k
    factor: int = 1


Stack = Tuple[StackOp, ...]


def _broadcast_outputs(tree: Any, n: int, device: torch.device) -> Any:
    """Tensor leaves on ``device`` with a leading item axis of ``n``."""
    def fix(leaf):
        t = torch.as_tensor(leaf, device=device)
        if t.dim() == 0 or t.shape[0] != n:
            t = t.expand((n,) + tuple(t.shape))
        return t
    return pt.tree_map(fix, tree)


def call_batched(fn: Callable, trees, W: int, cap: int,
                 device: torch.device) -> Any:
    """``fn(*trees)`` of ``[W, cap, ...]`` trees over one ``[W * cap]``
    item axis of all workers' rows (a tuple of the trees when ``fn`` is
    None), its outputs back as ``[W, cap, ...]`` leaves."""
    flat = [pt.tree_map(lambda l: l.reshape((W * cap,) + tuple(l.shape[2:])),
                        t) for t in trees]
    out = _broadcast_outputs(fn(*flat) if fn else tuple(flat), W * cap,
                             device)
    return pt.tree_map(lambda l: l.reshape((W, cap) + tuple(l.shape[1:])),
                       out)


def apply_stack_device(shards: DeviceShards, stack: Stack) -> DeviceShards:
    """Run a Map/Filter/FlatMap stack over every worker's rows; rows a
    Filter or a FlatMap drops are compacted away once, at the end. A
    FlatMap of factor ``k`` multiplies the capacity by ``k``, each
    item's candidates side by side."""
    mex = shards.mesh_exec
    W, cap = shards.num_workers, shards.cap
    n = W * cap
    tree = pt.tree_map(lambda l: l.reshape((n,) + tuple(l.shape[2:])),
                       shards.tree)
    mask = shards.valid_mask().reshape(n)
    filtered = False
    for op in stack:
        if op.kind == "map":
            tree = _broadcast_outputs(op.fn(tree), n, mex.device)
        elif op.kind == "filter":
            mask = mask & torch.as_tensor(op.fn(tree),
                                          device=mex.device).to(torch.bool)
            filtered = True
        elif op.kind == "flat_map":
            out, valid = op.fn(tree)
            k = op.factor
            valid = torch.as_tensor(valid, device=mex.device).to(torch.bool)
            if tuple(valid.shape[:2]) != (n, k):
                raise ValueError(f"flat_map valid mask must be [n, {k}], "
                                 f"got {tuple(valid.shape)}")
            tree = pt.tree_map(lambda l: torch.as_tensor(
                l, device=mex.device).reshape((n * k,) + tuple(l.shape[2:])),
                out)
            mask = (mask[:, None] & valid).reshape(n * k)
            n, cap = n * k, cap * k
            filtered = True
        else:
            raise ValueError(op.kind)
    tree = pt.tree_map(lambda l: l.reshape((W, cap) + tuple(l.shape[1:])),
                       tree)
    if not filtered:
        return DeviceShards(mex, tree, shards.counts.copy())
    tree, counts = compact_valid(tree, mask.reshape(W, cap))
    return DeviceShards(mex, tree, mex.fetch(counts).astype(np.int64))
