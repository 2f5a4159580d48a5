"""PrefixSum / ExPrefixSum (counterpart of the reference package's
``api/ops/prefix_sum.py``): each worker's masked cumulative sum plus the
sum of the earlier workers' totals, leaf by leaf (floats in their dtype,
integers in int64, as in the reference). A generic ``fn``, or host
storage, folds sequentially over the items in global order on the host,
as the reference does (device input is demoted first)."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ...common import tree as pt
from ...data import multiplexer
from ...data.shards import DeviceShards, HostShards
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
    # then takes)
    prev = torch.cumsum(totals, dim=0) - totals
    scan = incl if inclusive else incl - xm
    init = torch.as_tensor(initial, device=leaf.device).to(leaf.dtype)
    return scan + prev[:, None] + init


class PrefixSumNode(DIABase):
    def __init__(self, ctx, link, fn: Optional[Callable], initial: Any,
                 inclusive: bool) -> None:
        super().__init__(ctx, "PrefixSum" if inclusive else "ExPrefixSum",
                         [link])
        self.fn = fn
        self.initial = initial
        self.inclusive = inclusive

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards) or self.fn is not None:
            if isinstance(shards, DeviceShards):
                shards = shards.to_host_shards("prefixsum-nonnumeric-op")
            return self._compute_host(shards)
        if shards.cap == 0:
            return shards
        mask = shards.valid_mask()
        tree = pt.tree_map(lambda l: _scan(l, mask, self.initial,
                                           self.inclusive), shards.tree)
        return DeviceShards(shards.mesh_exec, tree, shards.counts.copy())

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
