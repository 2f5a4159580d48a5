"""Union: the DIAs' items without an order between them (counterpart of
the reference package's ``api/ops/union.py``; Thrill: api/union.hpp:53).
Each worker concatenates its local pieces; nothing is exchanged."""

from __future__ import annotations

from typing import List

from ...data.shards import HostShards
from ..dia import DIA
from ..dia_base import DIABase
from .concat import _local_concat, host_lists


class UnionNode(DIABase):
    def __init__(self, ctx, links) -> None:
        super().__init__(ctx, "Union", links)

    def compute(self):
        pulls = [l.pull() for l in self.parents]
        if any(isinstance(p, HostShards) for p in pulls):
            hosts = host_lists(pulls, "union-mixed-storage")
            W = hosts[0].num_workers
            return HostShards(W, [[it for h in hosts for it in h.lists[w]]
                                  for w in range(W)])
        if len(pulls) == 1:
            return pulls[0]
        return _local_concat(pulls)


def Union(a: DIA, *others: DIA) -> DIA:
    return DIA(UnionNode(a.context, [a._link()] +
                         [o._link() for o in others]))


def UnionMany(dias: List[DIA]) -> DIA:
    if not dias:
        raise ValueError("UnionMany needs at least one DIA")
    return DIA(UnionNode(dias[0].context, [d._link() for d in dias]))
