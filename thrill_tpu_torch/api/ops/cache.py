"""Cache and Collapse (counterpart of the reference package's
``api/ops/cache.py``): materialization barriers. Each node holds its
parent's result, with the parent's stack applied, until its own consume
budget is spent; Collapse also folds the stack so that the handle is a
plain DIA (the loop-variable pattern). Pulled by a sole consumer with
stitching on, either passes its parent's plan through (reference:
``thrill_tpu/api/ops/cache.py:18,35``)."""

from __future__ import annotations

from ..dia import DIA
from ..dia_base import DIABase


class CacheNode(DIABase):
    def __init__(self, ctx, link, label: str = "Cache") -> None:
        super().__init__(ctx, label, [link])

    def compute_plan(self):
        # a pass-through: the folded stack, and whatever the parent
        # deferred, ride into the consumer's stitched program
        from .. import fusion
        return fusion.pull_plan(self.parents[0])

    def compute(self):
        return self.parents[0].pull()


def Cache(dia: DIA) -> DIA:
    return DIA(CacheNode(dia.context, dia._link()))


def Collapse(dia: DIA) -> DIA:
    return DIA(CacheNode(dia.context, dia._link(), "Collapse"))
