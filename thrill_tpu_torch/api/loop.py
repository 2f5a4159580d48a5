"""Iterate (counterpart of the reference package's ``api/loop.py``, its
plain per-iteration form).

``Iterate(ctx, body, carry, n)`` runs ``body`` ``n`` times with the
carry threaded through. The carry is a DIA (``body(dia) -> dia``, the
Collapse-loop idiom: each iteration's result is materialized and the
next iteration reads it through a source node) or a pytree of tensors
(``body(tree) -> tree``). The reference captures the first iteration's
dispatches and replays them; its replay is bit-identical to this plain
loop. Capture and replay on the card (CUDA graphs) and
``checkpoint_every`` are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..common import tree as pt
from ..data.shards import DeviceShards
from .dia import DIA
from .dia_base import DIABase


class _LoopCarryNode(DIABase):
    """Source node over the materialized carry of one iteration."""

    def __init__(self, ctx, shards: DeviceShards) -> None:
        super().__init__(ctx, "LoopCarry")
        self._carry = shards

    def compute(self) -> DeviceShards:
        shards, self._carry = self._carry, None
        return shards


def _carry_dia(ctx, shards: DeviceShards) -> DIA:
    return DIA(_LoopCarryNode(ctx, shards))


def Iterate(ctx, body: Callable, carry: Any, n: int, *, name: str = "loop",
            checkpoint_every: Optional[int] = None) -> Any:
    """Run ``body`` ``n`` times; returns the final carry in the form it
    was given (a DIA in, a DIA out). ``name`` labels the loop."""
    if checkpoint_every:
        raise NotImplementedError(
            f"Iterate({name!r}, checkpoint_every=...): the port has no "
            f"checkpoints yet")
    if n <= 0:
        return carry
    dia_mode = isinstance(carry, (DIA, DIABase, DeviceShards))
    if isinstance(carry, DIABase):
        carry = DIA(carry)
    if isinstance(carry, DIA):
        state = carry._link().pull(consume=True)
    elif dia_mode:
        state = carry
    else:
        dev = ctx.mesh_exec.device
        state = pt.tree_map(lambda x: torch.as_tensor(x, device=dev), carry)
    for _ in range(n):
        if dia_mode:
            out = body(_carry_dia(ctx, state))
            if isinstance(out, DIABase):
                out = DIA(out)
            state = out._link().pull(consume=True)
        else:
            state = body(state)
    return _carry_dia(ctx, state) if dia_mode else state
