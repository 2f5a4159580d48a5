"""Host storage in the port against the reference package on the CPU:
the host sources, the per-item Map/Filter/FlatMap stack, ToHost and
ToDevice, and Size/AllGather/AllGatherArrays. Per-worker lists and
counts must equal the reference's exactly, item types included. Every
distributed op and device action runs on host storage too
(``HOST_OPS``; ``tests/test_torch_host_ops.py`` holds each at more
widths and sizes)."""

import jax
import numpy as np
import pytest

import thrill_tpu.api as japi
from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.stack import Bind
from thrill_tpu_torch.data.shards import DeviceShards, HostShards

WIDTHS = [1, 2, 4]


def _ref(W, job):
    jctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    try:
        return job(jctx)
    finally:
        jctx.close()


def _port(W, job):
    return job(tt.Context(num_workers=W, device="cpu"))


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _lists(dia):
    shards = dia.node.materialize()
    assert type(shards).__name__ == "HostShards"
    return [list(l) for l in shards.lists]


def _both(W, job):
    want, got = _ref(W, job), _port(W, job)
    assert _same(want, got), (want, got)
    return got


class Point:
    def __init__(self, x):
        self.x = x

    def __eq__(self, other):
        return type(other) is Point and other.x == self.x

    def __repr__(self):
        return f"Point({self.x})"


@pytest.mark.parametrize("W", WIDTHS)
def test_generate_host_matches_reference(W):
    got = _both(W, lambda c: _lists(c.Generate(11, lambda i: (i, str(i)),
                                               storage="host")))
    assert [len(l) for l in got] == np.diff(
        [(w * 11) // W for w in range(W + 1)]).tolist()
    _both(W, lambda c: c.Generate(7, storage="host").AllGather())


@pytest.mark.parametrize("W", WIDTHS)
def test_host_stack_map_filter_flatmap(W):
    def job(c):
        d = (c.Distribute(["a b", "", "c d e", "f"] * 3)
             .FlatMap(lambda s: s.split())
             .Filter(lambda w: w != "d")
             .Map(lambda w: (w, len(w))))
        return _lists(d)
    _both(W, job)


@pytest.mark.parametrize("W", WIDTHS)
def test_host_stack_on_the_edge_of_an_action(W):
    def job(c):
        d = c.Distribute([Point(i) for i in range(9)]).Map(
            lambda p: p.x * 10).Filter(lambda x: x % 20 == 0)
        return d.Size(), c.Distribute(
            [Point(i) for i in range(5)]).Map(lambda p: p.x).AllGather()
    _both(W, job)


def _scale(x, k):
    return x * k


@pytest.mark.parametrize("W", WIDTHS)
def test_bind_applies_per_host_item(W):
    def job(c, bind):
        return c.Generate(6, storage="host").Map(bind(_scale, 3)).AllGather()
    from thrill_tpu.api.stack import Bind as JBind
    assert _ref(W, lambda c: job(c, JBind)) == _port(W, lambda c: job(c, Bind))


@pytest.mark.parametrize("W", WIDTHS)
def test_flatmap_without_device_fn_demotes(W):
    def job(c):
        d = c.Generate(9).FlatMap(lambda x: [x] * (x % 3))
        return _lists(d)
    got = _both(W, job)
    assert all(type(x) is int for l in got for x in l)


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("src", ["ints", "tuples", "dict rows", "filtered"])
def test_to_host_itemizes_as_reference(W, src):
    make = {
        "ints": lambda c: c.Distribute(np.arange(10, dtype=np.int32)),
        "tuples": lambda c: c.Distribute([(i, 0.5 * i) for i in range(7)]),
        "dict rows": lambda c: c.Distribute({
            "a": np.arange(5), "b": np.ones((5, 2), dtype=np.float32)}),
        "filtered": lambda c: c.Generate(20).Filter(lambda x: x % 3 == 1),
    }[src]
    _both(W, lambda c: _lists(make(c).ToHost()))
    _both(W, lambda c: make(c).ToHost().AllGather())


@pytest.mark.parametrize("W", WIDTHS)
def test_to_device_columnarizes_as_reference(W):
    items = [(i, float(i) / 2, np.array([i, -i], dtype=np.int16))
             for i in range(9)]

    def job(c):
        d = c.Distribute(items, storage="host").ToDevice().Keep()
        shards = d.node.materialize()
        return (type(shards).__name__, shards.counts.tolist(),
                d.Map(lambda t: (t[0] + 1, t[1], t[2])).AllGather())
    _both(W, job)


@pytest.mark.parametrize("W", WIDTHS)
def test_to_device_with_empty_workers(W):
    def job(c):
        d = c.ConcatToDIA([[], [(1, 2.0)], [], [(3, 4.0), (5, 6.0)]]).Keep()
        dev = d.ToDevice().Keep()
        return dev.node.materialize().counts.tolist(), dev.AllGather()
    _both(W, job)


def test_to_device_of_nothing_raises():
    with pytest.raises(ValueError, match="cannot infer schema"):
        _port(2, lambda c: c.Distribute([], storage="host").ToDevice()
              .AllGather())


@pytest.mark.parametrize("W", WIDTHS)
def test_all_gather_arrays_of_host_storage(W):
    def job(c):
        a = c.Distribute([(i, 2.0 * i) for i in range(6)], storage="host")
        b = c.Distribute([], storage="host")
        s = c.Distribute([3, 1, 2], storage="host")
        return a.AllGatherArrays(), b.AllGatherArrays(), s.AllGatherArrays()
    got = _both(W, job)
    assert got[1] == []


@pytest.mark.parametrize("W", WIDTHS)
def test_size_and_keep_on_host_storage(W):
    def job(c):
        d = c.Distribute([Point(i) for i in range(13)]).Keep()
        return d.Size(), len(d.AllGather())
    _both(W, job)


def test_host_repartition_and_counts():
    h = HostShards(3, [[1, 2, 3, 4], [], [5]])
    assert h.counts.tolist() == [4, 0, 1] and h.total == 5
    assert h.repartition(2).lists == [[1, 2], [3, 4, 5]]
    assert h.repartition(4).lists == [[1], [2], [3], [4, 5]]


def test_from_worker_arrays_zeros_past_counts():
    mex = tt.MeshExec(num_workers=3, device="cpu")
    per = [{"a": np.arange(5) + 1}, {"a": np.arange(2) + 10},
           {"a": np.arange(0)}]
    sh = DeviceShards.from_worker_arrays(mex, per)
    assert sh.counts.tolist() == [5, 2, 0] and sh.cap == 8
    a = sh.tree["a"].numpy()
    assert a[0].tolist() == [1, 2, 3, 4, 5, 0, 0, 0]
    assert a[1].tolist() == [10, 11, 0, 0, 0, 0, 0, 0]
    assert not a[2].any()
    # counts cut the rows each worker gives
    sh = DeviceShards.from_worker_arrays(mex, per, counts=[1, 1, 0])
    assert sh.tree["a"].numpy()[:, 0].tolist() == [1, 10, 0]


HOST_OPS = {
    "ReduceByKey": lambda d, lib: d.ReduceByKey(lambda x: x, lambda a, b: a),
    "ReducePair": lambda d, lib: d.Map(lambda x: (x, 1)).ReducePair("sum"),
    "ReduceToIndex": lambda d, lib: d.ReduceToIndex(lambda x: x,
                                                    lambda a, b: a, 8),
    "GroupByKey": lambda d, lib: d.GroupByKey(lambda x: x,
                                              lambda k, xs: k),
    "Zip": lambda d, lib: lib.Zip(d.Keep(), d),
    "ZipWithIndex": lambda d, lib: d.ZipWithIndex(),
    "InnerJoin": lambda d, lib: lib.InnerJoin(d.Keep(), d, lambda x: x,
                                              lambda x: x, lambda a, b: a),
    "PrefixSum": lambda d, lib: d.PrefixSum(),
    "Sample": lambda d, lib: d.Sample(2),
    "BernoulliSample": lambda d, lib: d.BernoulliSample(0.5),
    "Sum": lambda d, lib: d.Sum(),
    "Min": lambda d, lib: d.Min(),
    "Max": lambda d, lib: d.Max(),
    "AllReduce": lambda d, lib: d.AllReduce(lambda a, b: a + b),
}


@pytest.mark.parametrize("op", sorted(HOST_OPS))
def test_ops_without_a_host_path_raise(op):
    """No op of ``HOST_OPS`` raises on host storage: each gives the
    reference's result, per-worker lists or value, at W = 2."""
    def job(lib):
        def run(ctx):
            out = HOST_OPS[op](ctx.Distribute([3, 1, 2, 5], storage="host"),
                               lib)
            return _lists(out) if hasattr(out, "node") else out
        return run

    want = _ref(2, job(japi))
    got = _port(2, job(tt))
    assert _same(want, got), (want, got)
