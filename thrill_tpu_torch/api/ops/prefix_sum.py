"""PrefixSum / ExPrefixSum (counterpart of the reference package's
``api/ops/prefix_sum.py``): each worker's masked cumulative sum plus the
sum of the earlier workers' totals, leaf by leaf (floats in their dtype,
integers in int64, as in the reference).
The reference runs a generic ``fn`` as a sequential fold on host
storage, which the port does not have."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ...common import tree as pt
from ...data.shards import DeviceShards
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
        if fn is not None:
            raise ValueError(
                f"{self.label}: a custom fn folds on host storage, which the "
                f"port does not have; the device form sums each leaf")
        self.initial = initial
        self.inclusive = inclusive

    def compute(self) -> DeviceShards:
        shards = self.parents[0].pull()
        if shards.cap == 0:
            return shards
        mask = shards.valid_mask()
        tree = pt.tree_map(lambda l: _scan(l, mask, self.initial,
                                           self.inclusive), shards.tree)
        return DeviceShards(shards.mesh_exec, tree, shards.counts.copy())


def PrefixSum(dia: DIA, fn=None, initial: Any = 0, inclusive=True) -> DIA:
    return DIA(PrefixSumNode(dia.context, dia._link(), fn, initial,
                             inclusive))
