"""The DIA handle: a lazily evaluated distributed immutable array
(counterpart of the reference package's ``api/dia.py``).

A handle is a node plus a stack of local operations. ``Map``/``Filter``
and the device ``FlatMap`` extend the stack; the host ``FlatMap``, the
distributed ops and ToHost/ToDevice cut it with a new node; actions and
writers run the graph. ``Zip``, ``ZipWindow``, ``Merge``, ``InnerJoin``,
``Concat`` and ``Union`` of several DIAs also live at module level, as
in the reference.
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
        """Host: ``fn(item) -> iterable``. Device storage additionally
        takes the batched ``device_fn(tree) -> (tree[n, k, ...], valid[n,
        k])`` with the static factor ``k``: every item expands into ``k``
        candidates, the valid ones stay, in item order. Without it the
        pipeline moves to host storage here."""
        from .ops import lop_nodes
        if device_fn is None:
            return lop_nodes.flat_map_host(self, fn)
        return DIA(self.node, self.stack + (StackOp("flat_map", device_fn,
                                                    int(factor)),))

    def BernoulliSample(self, p: float, seed: int = 0) -> "DIA":
        """Each item kept with probability ``p``, in order."""
        from .ops import sample as _sm
        return _sm.BernoulliSample(self, p, seed)

    # -- distributed ops -----------------------------------------------
    def Sort(self, key_fn: Optional[Callable] = None,
             compare_fn: Optional[Callable] = None) -> "DIA":
        """Globally sorted by ``key_fn`` (batched, default identity);
        equal keys keep their global order. ``compare_fn(a, b)``, a
        less-than predicate on items, sorts on the host instead, as host
        storage does (the result is host storage)."""
        from .ops import sort as _s
        return _s.Sort(self, key_fn, compare_fn)

    def SortStable(self, key_fn: Optional[Callable] = None,
                   compare_fn: Optional[Callable] = None) -> "DIA":
        """Sort: it orders by (key, global index), so it is stable."""
        from .ops import sort as _s
        return _s.Sort(self, key_fn, compare_fn)

    def Merge(self, *others: "DIA", key_fn: Optional[Callable] = None
              ) -> "DIA":
        """This sorted DIA merged with the sorted ``others``; see the
        module-level :func:`Merge`."""
        return Merge(self, *others, key_fn=key_fn)

    def GroupByKey(self, key_fn: Callable, group_fn: Callable = None,
                   device_fn: Callable = None) -> "DIA":
        """``group_fn(key, items)`` once per key, on the host, or the
        batched segment fold ``device_fn(tree, segment_ids,
        num_segments)`` on the device (``api/ops/groupby.py`` states the
        contract: ids ``>= num_segments`` are dropped). Group order is
        unspecified (the device sorts groups by key words); the worker
        of a group is fixed by its key's hash."""
        from .ops import groupby
        return groupby.GroupByKey(self, key_fn, group_fn,
                                  device_fn=device_fn)

    def GroupToIndex(self, index_fn: Callable, group_fn: Callable = None,
                     size: int = 0, neutral: Any = None,
                     device_fn: Callable = None) -> "DIA":
        """Dense output of ``size`` rows: row ``i`` is ``group_fn(i,
        items)`` of the items with ``index_fn == i`` (or the batched
        ``device_fn``, as GroupByKey's), ``neutral`` where none."""
        from .ops import groupby
        return groupby.GroupToIndex(self, index_fn, group_fn, size, neutral,
                                    device_fn=device_fn)

    def Window(self, k: int, fn: Callable,
               device_fn: Optional[Callable] = None) -> "DIA":
        """``fn(index, window)`` of every ``k`` consecutive items; on the
        device ``device_fn`` maps the batched ``[n, k, ...]`` windows."""
        from .ops import window as _w
        return _w.Window(self, k, fn, device_fn, disjoint=False)

    def FlatWindow(self, k: int, fn: Callable = None,
                   device_fn: Optional[Callable] = None,
                   factor: int = 0) -> "DIA":
        """``fn(index, window) -> iterable`` per window; on the device
        ``device_fn(windows) -> (outputs [n, factor, ...], mask [n,
        factor])``."""
        from .ops import window as _w
        return _w.FlatWindow(self, k, fn, device_fn=device_fn,
                             factor=factor)

    def DisjointWindow(self, k: int, fn: Callable,
                       device_fn: Optional[Callable] = None,
                       partial_fn: Optional[Callable] = None) -> "DIA":
        """Windows of ``k`` items that do not overlap. ``partial_fn(start,
        items)`` receives the trailing block of fewer than ``k`` items
        (Thrill: api/window.hpp:389) and keeps the op on the host."""
        from .ops import window as _w
        return _w.Window(self, k, fn, device_fn, disjoint=True,
                         partial_fn=partial_fn)

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

    def Concat(self, other: "DIA") -> "DIA":
        """This DIA's items, then ``other``'s, evenly re-split."""
        from .ops import concat as _c
        return _c.Concat(self, other)

    def Union(self, *others: "DIA") -> "DIA":
        """Every DIA's items on their own workers, no order between
        DIAs guaranteed and no exchange."""
        from .ops import union as _u
        return _u.Union(self, *others)

    def Rebalance(self) -> "DIA":
        """The items in order, evenly re-split (after a skewing
        Filter, say)."""
        from .ops import rebalance as _rb
        return _rb.Rebalance(self)

    # -- consume control and materialization -----------------------------
    def ToHost(self) -> "DIA":
        """The items as per-worker Python lists (host storage)."""
        from .ops import lop_nodes
        return lop_nodes.to_host(self)

    def ToDevice(self) -> "DIA":
        """Host items (fixed-shape pytrees of numbers) as columnar
        device storage."""
        from .ops import lop_nodes
        return lop_nodes.to_device(self)

    def Keep(self, n: int = 1) -> "DIA":
        self.node.keep(n)
        return self

    def Cache(self) -> "DIA":
        from .ops import cache as _ca
        return _ca.Cache(self)

    def Collapse(self) -> "DIA":
        from .ops import cache as _ca
        return _ca.Collapse(self)

    def Checkpoint(self, name: Optional[str] = None) -> "DIA":
        """Materialize here and seal the result into a durable epoch
        when a checkpoint directory is set (api/checkpoint.py); a resumed
        run reloads the newest committed epoch and skips this node's
        upstream graph. Without a directory this is a plain
        materialization barrier."""
        from .checkpoint import make_checkpoint_node
        return make_checkpoint_node(self, name)

    def Execute(self) -> "DIA":
        self.node.materialize()
        return self

    def Dispose(self) -> None:
        """Free the node's result now; a later use raises RuntimeError."""
        self.node.dispose()

    def explain(self) -> str:
        """This DIA's upstream plan as an annotated tree (reference:
        ``api/dia.py:208``): its ops, fused segments, the exchange of
        each shuffle and every recorded decision with its reason and
        audit (``Context.explain`` renders every node). It reads the
        decision ledger and changes nothing."""
        from ..common.decisions import render_plan
        nodes, stack, seen = [], [self.node], set()
        while stack:
            n = stack.pop()
            if n.id in seen:
                continue
            seen.add(n.id)
            nodes.append(n)
            stack.extend(p.node for p in n.parents)
        return render_plan(
            [{"id": n.id, "label": n.label, "state": n.state,
              "parents": [p.node.id for p in n.parents]} for n in nodes],
            self.context.decisions.snapshot(), W=self.context.num_workers,
            title=f"{self.node.label}#{self.node.id}")

    # -- actions -------------------------------------------------------
    def Size(self) -> int:
        from .ops import actions
        return actions.Size(self)

    def AllGather(self) -> list:
        from .ops import actions
        return actions.AllGather(self)

    def Gather(self, root: int = 0) -> list:
        """Every item, delivered to worker ``root``."""
        from .ops import actions
        return actions.Gather(self, root)

    def Print(self, label: str = "", limit: int = 100) -> "DIA":
        from .ops import actions
        actions.Print(self, label, limit)
        return self

    def HyperLogLog(self, precision: int = 14) -> float:
        """Estimated number of distinct items, ``2^precision``
        registers."""
        from .ops import hll
        return hll.HyperLogLog(self, precision)

    # Future variants run when ``get()`` is called (Thrill: Future<T>).
    # Issuing one reserves a consume unit, so that actions run between
    # issue and get cannot starve it.
    def _future(self, thunk):
        from .future import ActionFuture
        self.node.keep(1)
        return ActionFuture(thunk)

    def SizeFuture(self):
        from .ops import actions
        return self._future(lambda: actions.Size(self))

    def AllGatherFuture(self):
        from .ops import actions
        return self._future(lambda: actions.AllGather(self))

    def SumFuture(self, fn: Callable = None, initial: Any = 0):
        from .ops import actions
        if fn is not None:
            return self._future(lambda: actions.AllReduce(self, fn,
                                                          initial))
        return self._future(lambda: actions.Sum(self, initial))

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

    # -- writers -------------------------------------------------------
    def WriteLines(self, path_pattern: str) -> None:
        """One text file per worker, ``str(item)`` a line."""
        from .ops import read_write
        read_write.WriteLines(self, path_pattern)

    def WriteLinesOne(self, path: str) -> None:
        """One text file of every item, in worker-rank order."""
        from .ops import read_write
        read_write.WriteLinesOne(self, path)

    def WriteBinary(self, path_pattern: str) -> None:
        """Raw fixed-size records, one file per worker."""
        from .ops import read_write
        read_write.WriteBinary(self, path_pattern)


# -- free functions over several DIAs ------------------------------------------

def Zip(*dias: DIA, zip_fn: Callable = None, mode: str = "strict") -> DIA:
    """Item ``i`` of every DIA zipped by ``zip_fn`` (a tuple when None).
    ``mode``: "strict" (equal sizes), "cut" (the shortest) or "pad" (the
    longest; short DIAs give zero items)."""
    from .ops import zip_ as _z
    return _z.Zip(list(dias), zip_fn, mode)


def ZipWindow(window: tuple, *dias: DIA, zip_fn: Callable = None,
              device_fn: Callable = None) -> DIA:
    """DIA ``i`` read in chunks of ``window[i]`` items; output item ``j``
    is ``zip_fn`` of chunk ``j`` of every DIA (the tuple of the chunks
    when both fns are None), up to the shortest."""
    from .ops import zip_ as _z
    return _z.ZipWindow(list(dias), window, zip_fn, device_fn)


def Merge(*dias: DIA, key_fn: Callable = None) -> DIA:
    """The items of DIAs each sorted by ``key_fn``, merged into one
    sorted DIA; equal keys order by argument position, then by their
    position in their DIA."""
    from .ops import merge as _m
    return _m.Merge(list(dias), key_fn)


def Concat(*dias: DIA) -> DIA:
    """The DIAs' items in argument order, evenly re-split."""
    from .ops import concat as _c
    return _c.ConcatMany(list(dias))


def Union(*dias: DIA) -> DIA:
    """The DIAs' items worker by worker, no exchange."""
    from .ops import union as _u
    return _u.UnionMany(list(dias))


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
