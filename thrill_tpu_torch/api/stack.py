"""Local operation (LOp) stacks: Map, Filter and the device FlatMap
(counterpart of the reference package's ``api/stack.py``).

A DIA handle carries a tuple of StackOps; the consuming operator applies
them to its parent's shards in one go.

* host storage: ``fn`` is applied per item, Thrill-style.
* device storage: ``fn`` sees the item pytree with a leading item axis
  over all workers' rows (``[W * cap, ...]`` leaves): elementwise
  lambdas (``lambda x: x * 2``, ``lambda r: r["key"]``) read as per-item
  code, and scalar outputs are broadcast to the item axis. A
  ``flat_map`` op's ``fn(tree) -> (tree[n, k, ...], valid[n, k])``
  expands every item into ``k`` candidates, of which the valid ones
  stay.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ..common import tree as pt
from ..data.shards import DeviceShards, HostShards, compact_valid


class Bind:
    """A stack function with bound array operands: ``Bind(fn, *operands)``
    behaves like ``lambda t: fn(t, *operands)``, the operands (pytrees of
    arrays, tensors or numbers) becoming tensors on the device of the
    items it is called on, with their values at the call. There is no
    trace cache to key: the reference binds operands so that its compiled
    programs take them as arguments; here Bind only carries them."""

    __slots__ = ("fn", "operands")

    def __init__(self, fn: Callable, *operands: Any) -> None:
        self.fn = fn
        self.operands = operands

    def __call__(self, tree):
        leaves = [l for l in pt.leaves(tree) if isinstance(l, torch.Tensor)]
        dev = leaves[0].device if leaves else torch.device("cpu")
        return self.fn(tree, *pt.tree_map(
            lambda o: torch.as_tensor(o, device=dev), self.operands))

    def call_item(self, item):
        """``fn(item, *operands)`` on one host item, operands as given."""
        return self.fn(item, *self.operands)


@dataclasses.dataclass(frozen=True)
class StackOp:
    kind: str                      # 'map' | 'filter' | 'flat_map'
    fn: Callable
    # flat_map only: the static expansion factor k
    factor: int = 1


Stack = Tuple[StackOp, ...]


def _broadcast_outputs(tree: Any, n: int, device: torch.device) -> Any:
    """Tensor leaves on ``device`` with a leading item axis of ``n``."""
    def fix(leaf):
        t = torch.as_tensor(leaf, device=device)
        if t.dim() == 0 or t.shape[0] != n:
            t = t.expand((n,) + tuple(t.shape))
        return t
    return pt.tree_map(fix, tree)


def call_batched(fn: Callable, trees, W: int, cap: int,
                 device: torch.device) -> Any:
    """``fn(*trees)`` of ``[W, cap, ...]`` trees over one ``[W * cap]``
    item axis of all workers' rows (a tuple of the trees when ``fn`` is
    None), its outputs back as ``[W, cap, ...]`` leaves."""
    flat = [pt.tree_map(lambda l: l.reshape((W * cap,) + tuple(l.shape[2:])),
                        t) for t in trees]
    out = _broadcast_outputs(fn(*flat) if fn else tuple(flat), W * cap,
                             device)
    return pt.tree_map(lambda l: l.reshape((W, cap) + tuple(l.shape[1:])),
                       out)


def _item_fn(fn: Callable) -> Callable:
    return fn.call_item if isinstance(fn, Bind) else fn


def apply_stack_host_item(item: Any, stack: Stack, emit: Callable) -> None:
    """Apply a stack to one host item, calling ``emit`` per output item
    (a host FlatMap's ``fn`` returns an iterable)."""
    if not stack:
        emit(item)
        return
    op, rest = stack[0], stack[1:]
    fn = _item_fn(op.fn)
    if op.kind == "map":
        apply_stack_host_item(fn(item), rest, emit)
    elif op.kind == "filter":
        if fn(item):
            apply_stack_host_item(item, rest, emit)
    elif op.kind == "flat_map":
        for out in fn(item):
            apply_stack_host_item(out, rest, emit)
    else:
        raise ValueError(op.kind)


def apply_stack_host(shards: HostShards, stack: Stack) -> HostShards:
    """Run a stack over every worker's item list, per item."""
    out = []
    for items in shards.lists:
        lst: list = []
        for it in items:
            apply_stack_host_item(it, stack, lst.append)
        out.append(lst)
    return HostShards(shards.num_workers, out)


def stack_cache_token(stack: Stack) -> Tuple:
    """What identifies a stack's program: each op's kind, function and
    factor (a Bind by its function, not its operands' values)."""
    return tuple((op.kind, op.fn.fn if isinstance(op.fn, Bind) else op.fn,
                  op.factor) for op in stack)


def stack_bound_operands(stack: Stack) -> list:
    """The operand pytrees of every Bind op, in stack order (a stitched
    program takes them as arguments)."""
    return [op.fn.operands for op in stack if isinstance(op.fn, Bind)]


def apply_stack_traced(tree: Any, mask: torch.Tensor, stack: Stack,
                       bound=None) -> Tuple[Any, torch.Tensor]:
    """Apply a stack to ``[W, cap, ...]`` leaves with their ``[W, cap]``
    valid mask, every worker's rows on one item axis; returns the new
    ``(tree, mask)``, nothing compacted. A FlatMap of factor ``k``
    multiplies the capacity by ``k``, each item's candidates side by
    side. ``bound``, when given, holds the Bind ops' operands as device
    tensors, in stack order."""
    W, cap = mask.shape
    n = W * cap
    dev = mask.device
    tree = pt.tree_map(lambda l: l.reshape((n,) + tuple(l.shape[2:])),
                       tree)
    mask = mask.reshape(n)
    bound_iter = iter(bound) if bound is not None else None
    for op in stack:
        fn = op.fn
        if isinstance(fn, Bind) and bound_iter is not None:
            fn = functools.partial(_call_bound, fn.fn, next(bound_iter))
        if op.kind == "map":
            tree = _broadcast_outputs(fn(tree), n, dev)
        elif op.kind == "filter":
            mask = mask & torch.as_tensor(fn(tree), device=dev).to(
                torch.bool)
        elif op.kind == "flat_map":
            out, valid = fn(tree)
            k = op.factor
            valid = torch.as_tensor(valid, device=dev).to(torch.bool)
            if tuple(valid.shape[:2]) != (n, k):
                raise ValueError(f"flat_map valid mask must be [n, {k}], "
                                 f"got {tuple(valid.shape)}")
            tree = pt.tree_map(lambda l: torch.as_tensor(
                l, device=dev).reshape((n * k,) + tuple(l.shape[2:])), out)
            mask = (mask[:, None] & valid).reshape(n * k)
            n, cap = n * k, cap * k
        else:
            raise ValueError(op.kind)
    tree = pt.tree_map(lambda l: l.reshape((W, cap) + tuple(l.shape[1:])),
                       tree)
    return tree, mask.reshape(W, cap)


def _call_bound(fn: Callable, operands, tree):
    return fn(tree, *operands)


def apply_stack_host_list(items, stack: Stack) -> list:
    """A stack over one worker's item list, per item."""
    out: list = []
    for it in items:
        apply_stack_host_item(it, stack, out.append)
    return out


def _stack_program(tree, mask, stack: Stack):
    tree, mask = apply_stack_traced(tree, mask, stack)
    if all(op.kind == "map" for op in stack):
        return tree, None
    return compact_valid(tree, mask)


def apply_stack_device(shards: DeviceShards, stack: Stack) -> DeviceShards:
    """Run a Map/Filter/FlatMap stack over every worker's rows as one
    program through the mesh's dispatch choke point; rows a Filter or a
    FlatMap drops are compacted away once, at the end."""
    mex = shards.mesh_exec
    prog = mex.program(("stack", stack_cache_token(stack)), _stack_program)
    tree, counts = prog(shards.tree, shards.valid_mask(), stack)
    if counts is None:
        return DeviceShards(mex, tree, shards.counts_like())
    return DeviceShards(mex, tree, mex.fetch(counts).astype(np.int64))
