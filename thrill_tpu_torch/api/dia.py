"""The DIA handle: a lazily evaluated distributed immutable array
(counterpart of the reference package's ``api/dia.py``).

A handle is a node plus a stack of local operations. ``Map``/``Filter``
and the device ``FlatMap`` extend the stack; the distributed ops cut it
with a new node; actions run the graph. ``Zip`` and ``InnerJoin`` take
several DIAs and live at module level, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .dia_base import DIABase, ParentLink
from .stack import Stack, StackOp


class DIA:
    def __init__(self, node: DIABase, stack: Stack = ()) -> None:
        self.node = node
        self.stack = stack

    @property
    def context(self):
        return self.node.context

    def _link(self) -> ParentLink:
        return ParentLink(self.node, self.stack)

    # -- local ops -----------------------------------------------------
    def Map(self, fn: Callable) -> "DIA":
        return DIA(self.node, self.stack + (StackOp("map", fn),))

    def Filter(self, fn: Callable) -> "DIA":
        return DIA(self.node, self.stack + (StackOp("filter", fn),))

    def FlatMap(self, fn: Callable, device_fn: Optional[Callable] = None,
                factor: int = 1) -> "DIA":
        """``device_fn(tree) -> (tree[n, k, ...], valid[n, k])`` with the
        static factor ``k``: every item expands into ``k`` candidates,
        the valid ones stay, in item order. The host form ``fn(item) ->
        iterable`` needs host storage, which the port does not have."""
        if device_fn is None:
            raise ValueError(
                "FlatMap: the port runs on device storage only; pass the "
                "batched device_fn(tree) -> (tree[n, k, ...], valid[n, k]) "
                "with its factor k")
        return DIA(self.node, self.stack + (StackOp("flat_map", device_fn,
                                                    int(factor)),))

    def BernoulliSample(self, p: float, seed: int = 0) -> "DIA":
        """Each item kept with probability ``p``, in order."""
        from .ops import sample as _sm
        return _sm.BernoulliSample(self, p, seed)

    # -- distributed ops -----------------------------------------------
    def Sort(self, key_fn: Optional[Callable] = None) -> "DIA":
        """Globally sorted by ``key_fn`` (batched, default identity);
        equal keys keep their global order."""
        from .ops import sort as _s
        return _s.Sort(self, key_fn)

    def SortStable(self, key_fn: Optional[Callable] = None) -> "DIA":
        """Sort: it orders by (key, global index), so it is stable."""
        from .ops import sort as _s
        return _s.Sort(self, key_fn)

    def Sample(self, k: int, seed: int = 0) -> "DIA":
        """A uniform sample of ``min(k, Size())`` items without
        replacement; each worker keeps its share in order."""
        from .ops import sample as _sm
        return _sm.Sample(self, k, seed)

    def ReduceByKey(self, key_fn: Callable, reduce_fn: Callable,
                    dup_detection=None) -> "DIA":
        """Combine items of equal ``key_fn`` with the associative
        ``reduce_fn``. ``dup_detection`` (reference:
        DuplicateDetectionTag) keeps globally unique keys on their
        worker instead of shuffling them; None, the default, leaves it to
        the cost model (core/preshuffle.py), True/False force it. Rows
        come out key-sorted per worker; dup detection changes which
        worker holds a unique key, not the result set."""
        from .ops import reduce as _r
        return _r.ReduceByKey(self, key_fn, reduce_fn, dup_detection)

    def ReducePair(self, reduce_fn: Callable) -> "DIA":
        """Items are (key, value) pairs; ``reduce_fn`` (a callable or
        "sum"/"min"/"max") combines values."""
        from .ops import reduce as _r
        return _r.ReducePair(self, reduce_fn)

    def ReduceToIndex(self, index_fn: Callable, reduce_fn: Callable,
                      size: int, neutral: Any = None) -> "DIA":
        """Dense output of ``size`` rows: row ``i`` folds the items with
        ``index_fn == i``, rows without items hold ``neutral`` (zeros
        when None). Worker ``w`` holds the range
        ``dense_range_bounds(size, W)[w:w+2]``."""
        from .ops import reduce as _r
        return _r.ReduceToIndex(self, index_fn, reduce_fn, size, neutral)

    def PrefixSum(self, fn: Callable = None, initial: Any = 0) -> "DIA":
        """Inclusive running sum over the global item order."""
        from .ops import prefix_sum as _p
        return _p.PrefixSum(self, fn, initial, inclusive=True)

    def ExPrefixSum(self, fn: Callable = None, initial: Any = 0) -> "DIA":
        """Exclusive running sum over the global item order."""
        from .ops import prefix_sum as _p
        return _p.PrefixSum(self, fn, initial, inclusive=False)

    def ZipWithIndex(self, zip_fn: Callable = None) -> "DIA":
        """``zip_fn(item, global_index)``, by default the pair."""
        from .ops import zip_ as _z
        return _z.ZipWithIndex(self, zip_fn)

    # -- consume control and materialization -----------------------------
    def Keep(self, n: int = 1) -> "DIA":
        self.node.keep(n)
        return self

    def Cache(self) -> "DIA":
        from .ops import cache as _ca
        return _ca.Cache(self)

    def Collapse(self) -> "DIA":
        from .ops import cache as _ca
        return _ca.Collapse(self)

    def Execute(self) -> "DIA":
        self.node.materialize()
        return self

    # -- actions -------------------------------------------------------
    def Size(self) -> int:
        from .ops import actions
        return actions.Size(self)

    def AllGather(self) -> list:
        from .ops import actions
        return actions.AllGather(self)

    def AllGatherArrays(self):
        """The items as one pytree of tensors ``[total, ...]`` on the
        device, in worker-rank order."""
        from .ops import actions
        return actions.AllGatherArrays(self)

    def AllReduce(self, fn: Callable, initial: Any = None) -> Any:
        from .ops import actions
        return actions.AllReduce(self, fn, initial)

    def Sum(self, fn: Callable = None, initial: Any = 0,
            device: bool = False) -> Any:
        """The sum of every item, leaf by leaf (``initial`` for an empty
        DIA); ``device=True`` keeps it as tensors on the device. A custom
        ``fn`` folds the items on the host (AllReduce)."""
        from .ops import actions
        if fn is not None:
            return actions.AllReduce(self, fn, initial)
        return actions.Sum(self, initial, device=device)

    def Min(self) -> Any:
        from .ops import actions
        return actions.MinMax(self, is_min=True)

    def Max(self) -> Any:
        from .ops import actions
        return actions.MinMax(self, is_min=False)


# -- free functions over several DIAs ------------------------------------------

def Zip(*dias: DIA, zip_fn: Callable = None, mode: str = "strict") -> DIA:
    """Item ``i`` of every DIA zipped by ``zip_fn`` (a tuple when None).
    ``mode``: "strict" (equal sizes), "cut" (the shortest) or "pad" (the
    longest; short DIAs give zero items)."""
    from .ops import zip_ as _z
    return _z.Zip(list(dias), zip_fn, mode)


def InnerJoin(left: DIA, right: DIA, left_key_fn: Callable,
              right_key_fn: Callable, join_fn: Callable,
              location_detection=None, out_size_hint=None,
              dense_right_index=None) -> DIA:
    """``join_fn(l, r)`` of every pair of items with equal keys.
    ``location_detection`` (reference: LocationDetectionTag) drops items
    whose key hash has no presence on the other side before the shuffle;
    None leaves it to the cost model (core/preshuffle.py), True/False
    force it. ``out_size_hint`` is accepted; the output is sized from the
    exact per-worker totals. ``dense_right_index=n``: the right side is
    a dense table of ``n`` rows whose key is its global position, and the
    join is a gather (``right_key_fn`` must be None)."""
    from .ops import join as _j
    return _j.InnerJoin(left, right, left_key_fn, right_key_fn, join_fn,
                        location_detection=location_detection,
                        out_size_hint=out_size_hint,
                        dense_right_index=dense_right_index)
