"""Every distributed op and device action of the port on host storage,
against the reference package on the CPU at W = 1, 2, 3, 4: ReduceByKey
(duplicate detection by the cost model, forced on and forced off),
ReducePair, ReduceToIndex, GroupByKey, Zip (host, and host with device:
mixed storage demotes), ZipWithIndex, PrefixSum/ExPrefixSum with a
generic fn, InnerJoin (location filter by the cost model, on and off;
dense right index), Sample, BernoulliSample, Sum, Min, Max, AllReduce.

Items are made from a numpy seed. Per-worker lists must equal the
reference's exactly, item types included (``_same``)."""

import collections

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.api import FieldReduce as JFieldReduce
from thrill_tpu.api import InnerJoin as JInnerJoin
from thrill_tpu.api import Zip as JZip
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.data import multiplexer
from thrill_tpu_torch.data.shards import HostShards

WIDTHS = [1, 2, 3, 4]


def _ref(W, job):
    jctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    try:
        return job(jctx, JLIB)
    finally:
        jctx.close()


def _port(W, job):
    return job(tt.Context(num_workers=W, device="cpu"), TLIB)


class JLIB:
    Zip = staticmethod(JZip)
    InnerJoin = staticmethod(JInnerJoin)


class TLIB:
    Zip = staticmethod(tt.Zip)
    InnerJoin = staticmethod(tt.InnerJoin)


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


def _words(n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [f"w{int(i)}" for i in rng.zipf(1.3, n) % vocab]


# -- ReduceByKey / ReducePair / ReduceToIndex ---------------------------------

FIELD_CASES = {
    "tuple key first": (("first", "sum"), ((("k", 0), 1.5), (("k", 0), 2.0))),
    "float min": (("first", "min"), (("a", 1.0), ("a", 0.5))),
    "dict int max": ({"w": "first", "c": "max"},
                     ({"w": "x", "c": 3}, {"w": "y", "c": 7})),
    "list sum": (("first", "sum"), (("a", [1]), ("a", [2]))),
}


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_field_reduce_on_host_items_matches_reference(case):
    """FieldReduce as a callable reads its spec as a prefix of the item
    tree and folds host numbers with numpy (ROADMAP.md fault C8)."""
    spec, (a, b) = FIELD_CASES[case]
    want = JFieldReduce(spec)(a, b)
    got = tt.FieldReduce(spec)(a, b)
    assert _same(want, got), (want, got)
    for lib in (JFieldReduce, tt.FieldReduce):
        with pytest.raises(TypeError, match="does not match"):
            lib(("first", "sum"))(("k", 1, 2), ("k", 3, 4))


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("dup", [None, True, False])
def test_reduce_by_key_matches_reference(W, dup):
    words = _words(3000, 700, 1)

    def job(ctx, lib):
        d = ctx.Distribute(words, storage="host").Map(lambda w: (w, 1))
        return _lists(d.ReduceByKey(lambda kv: kv[0],
                                    lambda a, b: (a[0], a[1] + b[1]),
                                    dup_detection=dup))

    got = _both(W, job)
    assert dict(it for l in got for it in l) == collections.Counter(words)


@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_pair_and_tuple_keys_match_reference(W):
    rng = np.random.default_rng(2)
    pairs = [((f"k{a}", int(b)), float(c)) for a, b, c in
             zip(rng.integers(0, 30, 500), rng.integers(0, 3, 500),
                 rng.random(500))]

    def job(ctx, lib):
        d = ctx.Distribute(pairs, storage="host").Keep()
        return (_lists(d.ReducePair("sum")),
                _lists(d.ReducePair(lambda a, b: max(a, b))))

    _both(W, job)


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("neutral", [None, ("none", -1)])
def test_reduce_to_index_matches_reference(W, neutral):
    rng = np.random.default_rng(3)
    items = [(f"s{int(i)}", int(i)) for i in rng.integers(0, 40, 300)]

    def job(ctx, lib):
        d = ctx.Distribute(items, storage="host")
        return _lists(d.ReduceToIndex(
            lambda t: t[1], lambda a, b: (min(a[0], b[0]), a[1]), 45,
            neutral=neutral))

    _both(W, job)


# -- GroupByKey ----------------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_group_by_key_matches_reference(W):
    words = _words(2000, 300, 4)

    def job(ctx, lib):
        d = ctx.Distribute(list(enumerate(words)), storage="host")
        return _lists(d.GroupByKey(lambda t: t[1],
                                   lambda k, ts: (k, [t[0] for t in ts])))

    got = _both(W, job)
    assert {k: len(v) for l in got for k, v in l} == \
        collections.Counter(words)


# -- Zip / ZipWithIndex ----------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("mode", ["strict", "cut", "pad"])
def test_zip_of_host_dias_matches_reference(W, mode):
    a = _words(57, 20, 5)
    b = [(float(i), str(i)) for i in range(57 if mode == "strict" else 41)]

    def job(ctx, lib):
        x = ctx.Distribute(a, storage="host")
        y = ctx.Distribute(b, storage="host")
        return _lists(lib.Zip(x, y, mode=mode))

    _both(W, job)


@pytest.mark.parametrize("W", WIDTHS)
def test_zip_of_host_and_device_demotes_the_device_items(W):
    a = _words(50, 20, 6)
    vals = {"v": np.arange(50, dtype=np.int64) * 3,
            "f": np.linspace(0, 1, 50, dtype=np.float32)}

    def job(ctx, lib):
        x = ctx.Distribute(a, storage="host")
        y = ctx.Distribute(vals)
        return _lists(lib.Zip(x, y, zip_fn=lambda s, t: (s, t)))

    got = _both(W, job)
    assert type(got[0][0][1]["v"]) is int


@pytest.mark.parametrize("W", WIDTHS)
def test_zip_with_index_matches_reference(W):
    a = _words(37, 10, 7)

    def job(ctx, lib):
        d = ctx.Distribute(a, storage="host").Keep()
        return (_lists(d.ZipWithIndex()),
                _lists(d.ZipWithIndex(lambda s, i: f"{i}:{s}")))

    _both(W, job)


# -- PrefixSum -----------------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_prefix_sums_with_a_generic_fn_match_reference(W):
    a = _words(45, 9, 8)

    def job(ctx, lib):
        d = ctx.Distribute(a, storage="host").Keep(3)
        return (_lists(d.PrefixSum(lambda x, y: x + y, initial="")),
                _lists(d.ExPrefixSum(lambda x, y: x + y[:1], initial="^")),
                _lists(d.Map(len).PrefixSum()),
                _lists(d.Map(len).ExPrefixSum(initial=5)))

    _both(W, job)


@pytest.mark.parametrize("W", WIDTHS)
def test_prefix_sum_of_device_items_with_a_fn_folds_on_the_host(W):
    def job(ctx, lib):
        return _lists(ctx.Generate(23).PrefixSum(lambda a, b: a * 3 + b,
                                                 initial=1))

    _both(W, job)


# -- InnerJoin -----------------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("ld", [None, True, False])
def test_inner_join_matches_reference(W, ld):
    rng = np.random.default_rng(9)
    left = [(f"k{int(k)}", i) for i, k in enumerate(rng.integers(0, 80,
                                                                 200))]
    right = [(f"k{int(k)}", float(i)) for i, k in
             enumerate(rng.integers(40, 160, 150))]

    def job(ctx, lib):
        lt = ctx.Distribute(left, storage="host")
        rt = ctx.Distribute(right, storage="host")
        return _lists(lib.InnerJoin(lt, rt, lambda t: t[0], lambda t: t[0],
                                    lambda a, b: (a[0], a[1], b[1]),
                                    location_detection=ld))

    got = _both(W, job)
    want = collections.Counter((l[0], l[1], r[1]) for l in left
                               for r in right if l[0] == r[0])
    assert collections.Counter(it for l in got for it in l) == want


@pytest.mark.parametrize("W", WIDTHS)
def test_inner_join_of_host_and_device_and_a_dense_table(W):
    n = 30
    rng = np.random.default_rng(10)
    keys = [int(k) for k in rng.integers(-2, n + 3, 90)]

    def job(ctx, lib):
        lt = ctx.Distribute([(k, str(k)) for k in keys], storage="host"
                            ).Keep(2)
        table = ctx.Generate(n, lambda i: i * 10)
        dense = lib.InnerJoin(lt, table, lambda t: t[0], None,
                              lambda a, b: (a[1], b), dense_right_index=n)
        mixed = lib.InnerJoin(lt, ctx.Generate(n), lambda t: t[0],
                              lambda x: x, lambda a, b: (b, a[1]))
        return _lists(dense), _lists(mixed)

    _both(W, job)


# -- Sample / BernoulliSample -------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_samples_match_reference_bit_for_bit(W):
    a = _words(500, 100, 11)

    def job(ctx, lib):
        d = ctx.Distribute(a, storage="host").Keep(3)
        return (_lists(d.Sample(40, seed=3)), _lists(d.Sample(600)),
                _lists(d.BernoulliSample(0.1, seed=5)))

    got = _both(W, job)
    assert sum(map(len, got[0])) == 40 and sum(map(len, got[1])) == 500


# -- actions -----------------------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_actions_of_host_items_match_reference(W):
    a = _words(60, 40, 12)

    def job(ctx, lib):
        s = ctx.Distribute(a, storage="host").Keep(4)
        n = s.Map(len).Keep(3)
        t = s.Map(lambda w: (len(w), w)).Keep(2)
        return (s.Sum(initial=""), s.Min(), s.Max(),
                s.AllReduce(lambda x, y: y + x), n.Sum(), n.Sum(initial=7),
                n.AllReduce(max, 100), t.Min(), t.Max())

    _both(W, job)


@pytest.mark.parametrize("W", WIDTHS)
def test_actions_of_an_empty_host_dia(W):
    def job(ctx, lib):
        d = ctx.Distribute(["a", "bb"], storage="host").Filter(
            lambda s: s == "").Keep(5)
        out = [d.Sum(), d.Sum(initial="x"), d.AllReduce(min, "q")]
        for action in (d.Min, d.Max):
            with pytest.raises(ValueError, match="empty"):
                action()
        with pytest.raises(ValueError, match="empty"):
            d.AllReduce(min)
        return out

    assert _both(W, job) == [0, "x", "q"]


# -- what stays unported raises by name ---------------------------------------------

def test_the_single_controller_data_plane():
    mex = tt.MeshExec(num_workers=3, device="cpu")
    shards = tt.Context(mesh_exec=mex).Distribute(
        list("abcdefg"), storage="host").node.materialize()
    assert [len(l) for l in shards.lists] == [2, 2, 3]
    ex = multiplexer.host_exchange(mex, shards, lambda s: ord(s) - 97)
    # source-rank order in each receiver; 5 of 7 items changed worker
    assert ex.lists == [["a", "d", "g"], ["b", "e"], ["c", "f"]]
    assert (mex.stats_exchanges, mex.stats_items_moved) == (1, 5)
    assert multiplexer.ensure_replicated(mex, shards) is shards
    assert multiplexer.localize(mex, shards) is shards
    assert multiplexer.global_counts(mex, shards).tolist() == [2, 2, 3]
    assert multiplexer.global_total(mex, shards) == 7
    assert multiplexer.all_items(mex, shards) == list("abcdefg")
    assert multiplexer.net_fold(mex, 5, max) == 5
    with pytest.raises(ValueError, match="empty"):
        multiplexer.net_fold(mex, None, max, empty=True)


def test_a_mesh_of_several_processes_raises_naming_item_6():
    """Item 6's first part ported the multiplexer's TCP half: a mesh of
    several processes without the host control plane (no
    THRILL_TPU_HOSTLIST) now raises naming the missing plane, where it
    raised naming item 6 (tests/test_torch_distributed.py runs the
    plane)."""
    mex = tt.MeshExec(num_workers=2, device="cpu", process_index=0,
                      num_processes=2)
    shards = HostShards(2, [["a"], ["b"]])
    for call in (lambda: multiplexer.host_exchange(mex, shards, len),
                 lambda: multiplexer.ensure_replicated(mex, shards),
                 lambda: multiplexer.localize(mex, shards),
                 lambda: multiplexer.global_counts(mex, shards),
                 lambda: multiplexer.global_total(mex, shards),
                 lambda: multiplexer.all_items(mex, shards),
                 lambda: multiplexer.net_fold(mex, 1, max)):
        with pytest.raises(RuntimeError, match="host control plane"):
            call()
