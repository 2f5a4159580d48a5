"""Actions: graph sinks that run the graph and return results
(counterpart of Size, AllGather and AllGatherArrays in the reference
package's ``api/ops/actions.py``)."""

from __future__ import annotations

import torch

from ...common import tree as pt


def _pull(dia):
    return dia._link().pull(consume=True)


def Size(dia) -> int:
    return _pull(dia).total


def AllGatherArrays(dia):
    """The items as one pytree of tensors ``[total, ...]`` on the
    device, worker-rank order, sliced from the shards without a host
    copy."""
    shards = _pull(dia)
    counts = [int(c) for c in shards.counts]

    def cat(leaf):
        parts = [leaf[w, :c] for w, c in enumerate(counts) if c]
        if not parts:
            return leaf[0, :0]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    return pt.tree_map(cat, shards.tree)


def AllGather(dia) -> list:
    """The items as a host list: scalar leaves as Python numbers, array
    leaves as numpy rows, in the item's own pytree shape."""
    leaves, td = pt.flatten(pt.tree_map(
        lambda t: t.detach().cpu().numpy(), AllGatherArrays(dia)))
    cols = [l.tolist() if l.ndim == 1 else list(l) for l in leaves]
    if td is pt.LEAF:
        return cols[0]
    return [pt.unflatten(td, list(vals)) for vals in zip(*cols)]
