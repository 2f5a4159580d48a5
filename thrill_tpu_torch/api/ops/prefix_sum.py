"""PrefixSum / ExPrefixSum (counterpart of the reference package's
``api/ops/prefix_sum.py``): each worker's masked cumulative sum plus the
sum of the earlier workers' totals, leaf by leaf (floats in their dtype,
integers in int64, as in the reference). A generic ``fn``, or host
storage, folds sequentially over the items in global order on the host,
as the reference does (device input is demoted first).

Stitched (api/fusion.py), the scan is a segment over the chain's mask:
the earlier workers' totals are a cumulative sum over the worker
dimension inside the program, so no count is read on the host. Across
processes the earlier workers' totals come from every process
(``mesh.worker_exscan``)."""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...data import multiplexer
from ...data.shards import DeviceShards, HostShards
from ...parallel.mesh import current_mex, worker_exscan
from ..dia import DIA
from ..dia_base import DIABase


def _scan(leaf: torch.Tensor, mask: torch.Tensor, initial: Any,
          inclusive: bool) -> torch.Tensor:
    m = mask.reshape(mask.shape + (1,) * (leaf.dim() - 2))
    xm = torch.where(m, leaf, torch.zeros((), dtype=leaf.dtype,
                                          device=leaf.device))
    incl = torch.cumsum(xm, dim=1, dtype=leaf.dtype)            # [W, cap]
    totals = incl[:, -1]
    # each worker's offset: the totals of the workers before it, summed
    # as the reference sums them (integers in int64, which the result
    # then takes), every process's workers across processes
    prev = worker_exscan(totals, current_mex())
    scan = incl if inclusive else incl - xm
    if isinstance(initial, (int, float)):
        # a fill on the device: no host-to-device copy inside a chain
        init = torch.full((), initial, dtype=leaf.dtype, device=leaf.device)
    else:
        init = torch.as_tensor(initial, device=leaf.device).to(leaf.dtype)
    return scan + prev[:, None] + init


def _scan_tree(tree, mask, initial, inclusive):
    return pt.tree_map(lambda l: _scan(l, mask, initial, inclusive), tree)


class PrefixSumNode(DIABase):
    def __init__(self, ctx, link, fn: Optional[Callable], initial: Any,
                 inclusive: bool) -> None:
        super().__init__(ctx, "PrefixSum" if inclusive else "ExPrefixSum",
                         [link])
        self.fn = fn
        self.initial = initial
        self.inclusive = inclusive

    def _fuse_segment(self):
        """The masked scan as a segment (reference:
        ``thrill_tpu/api/ops/prefix_sum.py:34-63``)."""
        from .. import fusion
        initial, inclusive = self.initial, self.inclusive

        def trace(fctx, tree, mask, _bound):
            return pt.tree_map(lambda l: _scan(l, mask, initial, inclusive),
                               tree), mask

        return fusion.Segment(
            label=self.label,
            token=("prefix_sum_fused", inclusive,
                   np.asarray(initial).tobytes()),
            trace=trace, preserves_counts=True, dia_id=self.id)

    def compute_plan(self):
        from .. import fusion
        if self.fn is not None:
            return None              # a generic fold: host path only
        plan = fusion.pull_plan(self.parents[0])
        if not plan.stitchable:
            return fusion.wrap(self._compute_on(plan.finish()))
        plan.append(self._fuse_segment())
        return plan

    def compute(self):
        plan = self.compute_plan()
        if plan is not None:
            return plan.finish()
        return self._compute_on(self.parents[0].pull())

    def _compute_on(self, shards):
        if isinstance(shards, HostShards) or self.fn is not None:
            if isinstance(shards, DeviceShards):
                shards = shards.to_host_shards("prefixsum-nonnumeric-op")
            return self._compute_host(shards)
        if shards.cap == 0:
            return shards
        mex = shards.mesh_exec
        prog = mex.program(("prefix_sum", self.inclusive,
                            np.asarray(self.initial).tobytes()), _scan_tree)
        tree = prog(shards.tree, shards.valid_mask(), self.initial,
                    self.inclusive)
        return DeviceShards(mex, tree, shards.counts_like())

    def _compute_host(self, shards: HostShards) -> HostShards:
        """Reference: ``thrill_tpu/api/ops/prefix_sum.py:82-110``."""
        mex = self.context.mesh_exec
        replicated = multiplexer.ensure_replicated(mex, shards,
                                                   "prefixsum-host")
        fn = self.fn or (lambda a, b: a + b)
        out = []
        acc = self.initial
        for items in replicated.lists:
            lst = []
            for it in items:
                if self.inclusive:
                    acc = fn(acc, it)
                    lst.append(acc)
                else:
                    lst.append(acc)
                    acc = fn(acc, it)
            out.append(lst)
        return multiplexer.localize(mex, HostShards(shards.num_workers, out))


def PrefixSum(dia: DIA, fn=None, initial: Any = 0, inclusive=True) -> DIA:
    return DIA(PrefixSumNode(dia.context, dia._link(), fn, initial,
                             inclusive))
