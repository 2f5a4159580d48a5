"""Iterate (counterpart of the reference package's ``api/loop.py``, its
plain per-iteration form).

``Iterate(ctx, body, carry, n)`` runs ``body`` ``n`` times with the
carry threaded through. The carry is a DIA (``body(dia) -> dia``, the
Collapse-loop idiom: each iteration's result is materialized and the
next iteration reads it through a source node) or a pytree of tensors
(``body(tree) -> tree``). The reference captures the first iteration's
dispatches and replays them; its replay is bit-identical to this plain
loop. Capture and replay on the card (CUDA graphs) are not ported.

``checkpoint_every=k`` seals a DIA carry into a checkpoint epoch after
every k-th iteration but the last, when the Context has a checkpoint
manager (api/checkpoint.py); a resumed run restores the newest loop
epoch of ``name`` and goes on after it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..common import tree as pt
from ..data.shards import DeviceShards, HostShards
from .dia import DIA
from .dia_base import DIABase


class _LoopCarryNode(DIABase):
    """Source node over the materialized carry of one iteration."""

    def __init__(self, ctx, shards: DeviceShards) -> None:
        super().__init__(ctx, "LoopCarry")
        self._carry = shards

    def compute(self) -> DeviceShards:
        return self._carry

    def materialize(self, consume: bool = False):
        # the carry goes once the node holds its result (or has handed
        # it over): a retried compute still finds it
        out = super().materialize(consume)
        self._carry = None
        return out


def _carry_dia(ctx, shards: DeviceShards) -> DIA:
    return DIA(_LoopCarryNode(ctx, shards))


def Iterate(ctx, body: Callable, carry: Any, n: int, *, name: str = "loop",
            checkpoint_every: Optional[int] = None) -> Any:
    """Run ``body`` ``n`` times; returns the final carry in the form it
    was given (a DIA in, a DIA out). ``name`` labels the loop and its
    checkpoint epochs; ``checkpoint_every`` needs a DIA carry."""
    if n <= 0:
        return carry
    mgr = getattr(ctx, "checkpoint", None)
    dia_mode = isinstance(carry, (DIA, DIABase, DeviceShards, HostShards))
    if checkpoint_every and not dia_mode:
        # an epoch holds shards: a pytree carry cannot be sealed, and
        # skipping the seals would not give the durability asked for
        raise ValueError(
            "Iterate(checkpoint_every=...) requires a DIA/DeviceShards "
            "carry; pytree carries cannot be sealed into checkpoint "
            "epochs (wrap the state in a DIA, or drop checkpoint_every)")
    if isinstance(carry, DIABase):
        carry = DIA(carry)
    if isinstance(carry, DIA):
        state = carry._link().pull(consume=True)
    elif dia_mode:
        state = carry
    else:
        dev = ctx.mesh_exec.device
        state = pt.tree_map(lambda x: torch.as_tensor(x, device=dev), carry)
    seal = mgr is not None and bool(checkpoint_every) and dia_mode
    start = 0
    if seal:
        restored = mgr.try_restore_loop(name)
        if restored is not None:
            state, start = restored
            start += 1                  # go on after the sealed iteration
    for i in range(start, n):
        if dia_mode:
            out = body(_carry_dia(ctx, state))
            if isinstance(out, DIABase):
                out = DIA(out)
            state = out._link().pull(consume=True)
        else:
            state = body(state)
        if seal and (i + 1) % checkpoint_every == 0 and i + 1 < n:
            mgr.save_loop_state(name, i, state)
    return _carry_dia(ctx, state) if dia_mode else state
