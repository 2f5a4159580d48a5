"""The port's sources against the reference package on the CPU.

``Distribute`` of item sequences (a list of ints, of tuples, of dicts, a
generator), ``EqualToDIA`` and ``ConcatToDIA`` must give the reference's
items, per-worker counts included, at W in {1, 2, 4}. What needs host
storage, which the port does not have yet, raises instead of falling
back.
"""

import jax
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt

WIDTHS = [1, 2, 4]

ITEM_LISTS = {
    "ints": lambda: [3, 1, 2],
    "floats and bools": lambda: [1.5, -2.0, 0.25, 7.0, 3.0],
    "tuples": lambda: [(1, 2.0), (0, 1.0), (5, -3.5), (2, 0.0), (9, 9.0)],
    "dicts": lambda: [{"a": i, "b": float(i) / 4, "c": i % 2 == 0}
                      for i in range(11)],
    "numpy rows": lambda: [np.array([i, 2 * i], dtype=np.int32)
                           for i in range(6)],
    "numpy scalars": lambda: [np.float32(i) / 3 for i in range(7)],
    "nested": lambda: [(i, {"x": np.int64(i * i), "y": (i, -i)})
                       for i in range(9)],
    "generator": lambda: (i * i for i in range(13)),
    "tuple of items": lambda: tuple(range(10, 0, -1)),
}


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _ref(W, job):
    jctx = _jax_ctx(W)
    try:
        return job(jctx)
    finally:
        jctx.close()


def _same(a, b):
    """Items equal leaf for leaf (numpy rows by value), types of scalars
    included."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, np.asarray(b))
    return type(a) is type(b) and a == b


def _port_counts(dia):
    return dia.node.materialize().counts.tolist()


def _ref_counts(dia):
    shards = dia.node.materialize()
    if hasattr(shards, "lists"):
        return [len(l) for l in shards.lists]
    return np.asarray(shards.counts).tolist()


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("kind", sorted(ITEM_LISTS))
def test_distribute_of_items_matches_reference(W, kind):
    # fault C6: the port raised on any Python list of items
    want = _ref(W, lambda c: c.Distribute(ITEM_LISTS[kind]()).AllGather())
    got = tt.Context(num_workers=W, device="cpu").Distribute(
        ITEM_LISTS[kind]()).AllGather()
    assert _same(want, got), (want, got)


@pytest.mark.parametrize("W", WIDTHS)
def test_distribute_of_items_splits_as_reference(W):
    items = [(i, float(i)) for i in range(23)]

    def job(c):
        d = c.Distribute(items).Keep()
        return _ref_counts(d), d.AllGather()

    want_counts, want = _ref(W, job)
    d = tt.Context(num_workers=W, device="cpu").Distribute(items).Keep()
    assert _port_counts(d) == want_counts
    assert _same(want, d.AllGather())


@pytest.mark.parametrize("W", WIDTHS)
def test_items_flow_through_the_pipeline(W):
    items = [(i % 5, float(i)) for i in range(40)]

    def job(c):
        return (c.Distribute(items).ReducePair("sum")
                .Sort(lambda kv: kv[0]).AllGather())

    want = _ref(W, job)
    got = job(tt.Context(num_workers=W, device="cpu"))
    assert _same(want, got)


def test_columnar_input_passes_through():
    ctx = tt.Context(num_workers=2, device="cpu")
    t = torch.arange(7, dtype=torch.int64) * 3
    got = ctx.Distribute({"t": t, "a": np.arange(7.0)}).AllGatherArrays()
    assert torch.equal(got["t"], t)
    assert torch.equal(got["a"], torch.arange(7.0, dtype=torch.float64))
    assert ctx.Distribute(t).AllGather() == t.tolist()


@pytest.mark.parametrize("W", WIDTHS)
def test_equal_to_dia_matches_reference(W):
    items = [{"k": i % 3, "v": np.float32(i)} for i in range(10)]
    want = _ref(W, lambda c: c.EqualToDIA(items).AllGather())
    got = tt.Context(num_workers=W, device="cpu").EqualToDIA(items)
    assert _same(want, got.AllGather())
    arr = np.arange(12, dtype=np.int64)
    assert (tt.Context(num_workers=W, device="cpu").EqualToDIA(arr)
            .AllGather() == _ref(W, lambda c: c.EqualToDIA(arr)
                                 .AllGather()))


CONCAT_LISTS = {
    "fewer than W": [[1, 2, 3]],
    "W lists": [[1, 2], [], [3], [4, 5, 6], [7]],
    "more than W": [[1], [2, 3], [4], [5, 6], [7], [], [8, 9], [10]],
}


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("case", sorted(CONCAT_LISTS))
def test_concat_to_dia_matches_reference(W, case):
    lists = CONCAT_LISTS[case]
    if case == "W lists":
        lists = (lists * 4)[:W]
    lists = [[(x, float(-x)) for x in l] for l in lists]

    def job(c):
        d = c.ConcatToDIA(lists).Keep()
        return _ref_counts(d), d.AllGather()

    want_counts, want = _ref(W, job)
    d = tt.Context(num_workers=W, device="cpu").ConcatToDIA(lists).Keep()
    assert _port_counts(d) == want_counts
    assert _same(want, d.AllGather())


def test_concat_to_dia_places_each_list_on_its_worker():
    ctx = tt.Context(num_workers=4, device="cpu")
    shards = ctx.ConcatToDIA([[5], [], [6, 7, 8, 9, 10]]).node.materialize()
    assert shards.counts.tolist() == [1, 0, 5, 0]
    per = shards.to_worker_arrays()
    assert [p.tolist() for p in per] == [[5], [], [6, 7, 8, 9, 10], []]


@pytest.mark.parametrize("op", ["Distribute", "EqualToDIA", "ConcatToDIA"])
def test_host_storage_raises(op):
    ctx = tt.Context(num_workers=2, device="cpu")
    call = getattr(ctx, op)
    wrap = (lambda x: [x, x]) if op == "ConcatToDIA" else (lambda x: x)
    with pytest.raises(NotImplementedError, match="host storage"):
        call(wrap([1, 2, 3]), storage="host")
    with pytest.raises(NotImplementedError, match="host storage"):
        call(wrap(["a", "b"]))
    with pytest.raises(NotImplementedError, match="host storage"):
        call(wrap([object()]))
    with pytest.raises(NotImplementedError, match="host storage"):
        call(wrap([(1, "x")]))


def test_empty_items_raise_the_reference_s_error():
    with pytest.raises(ValueError) as want:
        _ref(2, lambda c: c.Distribute([]).AllGather())
    with pytest.raises(ValueError) as got:
        tt.Context(num_workers=2, device="cpu").Distribute([]).AllGather()
    assert str(got.value) == str(want.value)


def test_overall_stats_counts_what_the_port_keeps():
    ctx = tt.Context(num_workers=4, device="cpu")
    ctx.Distribute([(i % 3, 1) for i in range(50)]).ReducePair(
        "sum").AllGather()
    s = ctx.overall_stats()
    assert set(s) == {"workers", "nodes_created", "exchanges", "items_moved",
                      "bytes_moved", "hbm_peak"}
    assert s["workers"] == 4 and s["nodes_created"] == 2
    assert s["exchanges"] == 1 and s["items_moved"] > 0
    assert s["bytes_moved"] >= 16 * s["items_moved"]
    assert s["hbm_peak"] == 0
