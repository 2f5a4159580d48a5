"""Source operations: Generate and Distribute, device storage only
(counterpart of the reference package's ``api/ops/sources.py``)."""

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
    """A global columnar collection (an array, or a pytree of
    equal-length arrays or tensors) split evenly, order preserved."""

    def __init__(self, ctx, items) -> None:
        super().__init__(ctx, "Distribute")
        self.items = items

    def compute(self) -> DeviceShards:
        return DeviceShards.from_global_numpy(self.context.mesh_exec,
                                              self.items)


def Generate(ctx, size, fn=None) -> DIA:
    return DIA(GenerateNode(ctx, size, fn))


def Distribute(ctx, items) -> DIA:
    return DIA(DistributeNode(ctx, items))
