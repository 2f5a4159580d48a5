"""Rebalance (counterpart of the reference package's
``api/ops/rebalance.py``; the node lives in concat.py)."""

from __future__ import annotations

from ..dia import DIA
from .concat import RebalanceNode


def Rebalance(dia: DIA) -> DIA:
    return DIA(RebalanceNode(dia.context, dia._link()))
