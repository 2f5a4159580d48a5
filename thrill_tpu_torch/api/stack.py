"""Local operation (LOp) stacks: Map and Filter as batched column
functions (counterpart of the reference package's ``api/stack.py``).

A DIA handle carries a tuple of StackOps; the consuming operator applies
them to its parent's shards in one go. ``fn`` sees the item pytree with
a leading item axis over all workers' rows (``[W * cap, ...]`` leaves):
elementwise lambdas (``lambda x: x * 2``, ``lambda r: r["key"]``) read
as per-item code, and scalar outputs are broadcast to the item axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ..common import tree as pt
from ..data.shards import DeviceShards, compact_valid


@dataclasses.dataclass(frozen=True)
class StackOp:
    kind: str                      # 'map' | 'filter'
    fn: Callable


Stack = Tuple[StackOp, ...]


def _broadcast_outputs(tree: Any, n: int, device: torch.device) -> Any:
    """Tensor leaves on ``device`` with a leading item axis of ``n``."""
    def fix(leaf):
        t = torch.as_tensor(leaf, device=device)
        if t.dim() == 0 or t.shape[0] != n:
            t = t.expand((n,) + tuple(t.shape))
        return t
    return pt.tree_map(fix, tree)


def apply_stack_device(shards: DeviceShards, stack: Stack) -> DeviceShards:
    """Run a Map/Filter stack over every worker's rows; rows a Filter
    drops are compacted away once, at the end."""
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
        else:
            raise ValueError(op.kind)
    tree = pt.tree_map(lambda l: l.reshape((W, cap) + tuple(l.shape[1:])),
                       tree)
    if not filtered:
        return DeviceShards(mex, tree, shards.counts.copy())
    tree, counts = compact_valid(tree, mask.reshape(W, cap))
    return DeviceShards(mex, tree, mex.fetch(counts).astype(np.int64))
