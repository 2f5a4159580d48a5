"""The port's Zip, ZipWithIndex, PrefixSum/ExPrefixSum, Sum/Min/Max,
device FlatMap, Cache/Collapse and Bind against the reference package on
the CPU.

The same items, made from a numpy seed, go through ``thrill_tpu`` and
``thrill_tpu_torch`` at W in {1, 2, 4}; per-worker counts and rows must
be identical, integers bit for bit. Floating-point prefix sums and sums
may associate differently (torch's sequential CPU scan against XLA's),
so they are held to ``rtol=1e-6, atol=1e-6`` (a few f32 ulps of sums of
at most 100 values of magnitude <= 1); f64 to ``1e-12``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thrill_tpu.api import Bind as JBind
from thrill_tpu.api import Context as JContext
from thrill_tpu.api import Zip as JZip
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt

WIDTHS = [1, 2, 4]


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


class _J:
    """The reference's spelling of what the jobs need."""
    Zip = staticmethod(JZip)
    Bind = staticmethod(JBind)
    stack1 = staticmethod(lambda xs: jnp.stack(xs, axis=1))
    f64 = jnp.float64


class _T:
    """The port's spelling."""
    Zip = staticmethod(tt.Zip)
    Bind = staticmethod(tt.Bind)
    stack1 = staticmethod(lambda xs: torch.stack(xs, dim=1))
    f64 = torch.float64


def _both(W, job):
    """(reference, port) of ``job(ctx, lib)``: the node's rows in
    worker-rank order and its per-worker counts."""
    jctx = _jax_ctx(W)
    try:
        j = job(jctx, _J).node.materialize()
        ref = (j.to_global_numpy(), np.asarray(j.counts).reshape(-1).copy())
    finally:
        jctx.close()
    t = job(tt.Context(num_workers=W, device="cpu"), _T).node.materialize()
    return ref, (t.to_global_numpy(), t.counts)


def _assert_same(ref, port, tol=0.0):
    (jrows, jcounts), (trows, tcounts) = ref, port
    assert np.array_equal(jcounts, tcounts)
    jl = jax.tree.leaves(jrows)
    tl = jax.tree.leaves(trows)
    assert jax.tree.structure(jrows) == jax.tree.structure(trows)
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape
        if tol and np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t, j, rtol=tol, atol=tol)
        else:
            assert np.array_equal(t, j)


def _items(n, seed):
    rng = np.random.default_rng(seed)
    return {"i": rng.integers(-1000, 1000, n).astype(np.int64),
            "f": rng.random(n).astype(np.float32),
            "b": rng.integers(0, 256, (n, 3)).astype(np.uint8)}


# -- Zip -----------------------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_zip_strict_realigns_to_the_first_partition(W):
    a = np.arange(50, dtype=np.int64)
    b = _items(34, 1)

    def job(ctx, lib):
        # the filter leaves 34 items spread unevenly over the workers;
        # the second DIA is realigned to that partition
        x = ctx.Distribute(a).Filter(lambda v: (v % 3 != 0) | (v < 3))
        y = ctx.Distribute(b)
        return lib.Zip(x, y, zip_fn=lambda u, t: {"u": u, "t": t})

    _assert_same(*_both(W, job))


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("mode", ["cut", "pad"])
def test_zip_unequal_sizes(W, mode):
    a = _items(25, 2)
    b = np.arange(100, 110, dtype=np.int64)
    c = np.arange(17, dtype=np.int32) * 7

    def job(ctx, lib):
        return lib.Zip(ctx.Distribute(a), ctx.Distribute(b),
                       ctx.Distribute(c), mode=mode)

    ref, port = _both(W, job)
    _assert_same(ref, port)
    n = 10 if mode == "cut" else 25
    assert int(port[1].sum()) == n


@pytest.mark.parametrize("W", [2, 4])
def test_zip_pad_gives_zero_items_where_the_exchange_leaves_copies(W):
    """The port's exchange fills the rows past each receive count with
    copies of shipped rows. In pad mode those rows are the pad items and
    must be zeros: here every worker but the first receives none of the
    short DIA's items."""
    long = np.arange(40, dtype=np.int64)
    short = {"v": np.arange(1, 6, dtype=np.int64) * 11,
             "w": np.full((5, 2), 9, dtype=np.uint8)}

    def job(ctx, lib):
        return lib.Zip(ctx.Distribute(long), ctx.Distribute(short),
                       zip_fn=lambda x, s: {"x": x, "v": s["v"],
                                            "w": s["w"]}, mode="pad")

    ref, port = _both(W, job)
    _assert_same(ref, port)
    rows = port[0]
    assert rows["v"][:5].tolist() == [11, 22, 33, 44, 55]
    assert not rows["v"][5:].any() and not rows["w"][5:].any()


def test_zip_cut_ships_no_dropped_tail():
    """The realign drops the items past the output size before its
    exchange (which clips valid destinations into [0, W)): only the five
    items that change worker travel, not the tail of the long DIA."""
    ctx = tt.Context(num_workers=2, device="cpu")
    z = tt.Zip(ctx.Generate(10), ctx.Generate(30, lambda i: i * 2),
               zip_fn=lambda a, b: b - a, mode="cut")
    assert z.AllGather() == list(range(10))
    assert ctx.mesh_exec.stats_items_moved == 5


@pytest.mark.parametrize("W", WIDTHS)
def test_zip_strict_refuses_unequal_sizes(W):
    ctx = tt.Context(num_workers=W, device="cpu")
    z = tt.Zip(ctx.Generate(5), ctx.Generate(6))
    with pytest.raises(ValueError, match="unequal sizes"):
        z.Size()


@pytest.mark.parametrize("W", WIDTHS)
def test_zip_with_index(W):
    vals = _items(23, 3)

    def job(ctx, lib):
        return ctx.Distribute(vals).Filter(
            lambda t: t["i"] % 4 != 1).ZipWithIndex()

    _assert_same(*_both(W, job))

    def job_fn(ctx, lib):
        return ctx.Generate(13).ZipWithIndex(lambda x, i: x * 100 + i)

    _assert_same(*_both(W, job_fn))


# -- PrefixSum / ExPrefixSum ---------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_prefix_sums(W):
    vals = _items(61, 4)
    vals.pop("b")
    vals["j"] = np.arange(61, dtype=np.int32)

    def incl(ctx, lib):
        return ctx.Distribute(vals).Filter(
            lambda t: t["i"] % 5 != 0).PrefixSum()

    def excl(ctx, lib):
        return ctx.Distribute(vals).ExPrefixSum(initial=100)

    _assert_same(*_both(W, incl), tol=1e-6)
    _assert_same(*_both(W, excl), tol=1e-6)


def test_prefix_sum_refuses_a_custom_fn():
    """A custom fn is not refused: device items are demoted and fold on
    the host, equal to the reference's."""
    def job(ctx, lib):
        d = ctx.Generate(9).Map(lambda x: x + 1)
        return d.PrefixSum(lambda a, b: a * b, initial=1).node.materialize()

    jctx = _jax_ctx(2)
    try:
        want = job(jctx, _J).lists
    finally:
        jctx.close()
    got = job(tt.Context(num_workers=2, device="cpu"), None).lists
    assert got == want
    assert [x for l in got for x in l][-1] == 362880


# -- Sum / Min / Max / AllReduce -----------------------------------------------

def _actions(ctx, vals, keep):
    d = ctx.Distribute(vals).Filter(keep).Keep(4)
    out = {"sum": d.Sum(), "sum100": d.Sum(initial=100),
           "min": d.Min(), "max": d.Max()}
    out["allreduce"] = d.AllReduce(lambda a, b: a + b, 0)
    return out


@pytest.mark.parametrize("W", WIDTHS)
def test_sum_min_max(W):
    rng = np.random.default_rng(5)
    ints = rng.integers(-10**12, 10**12, 77).astype(np.int64)
    floats = rng.random(77)
    i32 = rng.integers(-2**31, 2**31, 77).astype(np.int32)

    def keep(x):
        return x != x + 1

    for vals in (ints, floats, i32):
        jctx = _jax_ctx(W)
        try:
            ref = _actions(jctx, vals, keep)
        finally:
            jctx.close()
        got = _actions(tt.Context(num_workers=W, device="cpu"), vals, keep)
        for k in ref:
            if vals.dtype == np.float64:
                assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)
            else:
                assert got[k] == ref[k] and type(got[k]) is type(ref[k]), k
    # integer sums widen to int64 as the reference's do
    assert tt.Context(num_workers=W, device="cpu").Distribute(
        np.full(3, 2**31 - 1, dtype=np.int32)).Sum() == 3 * (2**31 - 1)


@pytest.mark.parametrize("W", WIDTHS)
def test_sum_of_pytrees_and_on_the_device(W):
    vals = _items(40, 6)

    def job(ctx):
        d = ctx.Distribute(vals).Map(
            lambda t: {"i": t["i"], "b": t["b"]}).Keep(2)
        return d.Sum(), d.Sum(initial={"i": 5, "b": 1})

    jctx = _jax_ctx(W)
    try:
        ref = job(jctx)
    finally:
        jctx.close()
    got = job(tt.Context(num_workers=W, device="cpu"))
    for r, g in zip(ref, got):
        assert g["i"] == r["i"]
        assert np.array_equal(g["b"], np.asarray(r["b"]))
    ctx = tt.Context(num_workers=W, device="cpu")
    dev = ctx.Distribute(vals).Sum(device=True)
    assert isinstance(dev["f"], torch.Tensor) and dev["f"].dim() == 0
    assert int(dev["i"]) == int(vals["i"].sum())


@pytest.mark.parametrize("W", WIDTHS)
def test_actions_on_an_empty_dia(W):
    def job(ctx):
        d = ctx.Distribute(np.arange(9, dtype=np.int64)).Filter(
            lambda x: x < 0).Keep(8)
        out = [d.Sum(), d.Sum(initial=7), d.AllReduce(lambda a, b: a + b,
                                                      3), d.Size()]
        for action in (d.Min, d.Max):
            with pytest.raises(ValueError, match="empty"):
                action()
        with pytest.raises(ValueError, match="empty"):
            d.AllReduce(lambda a, b: a + b)
        return out

    jctx = _jax_ctx(W)
    try:
        ref = job(jctx)
    finally:
        jctx.close()
    assert job(tt.Context(num_workers=W, device="cpu")) == ref == [0, 7, 3, 0]


# -- device FlatMap, Cache / Collapse, Bind -------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_device_flat_map(W):
    vals = np.arange(-20, 31, dtype=np.int64)

    def job(ctx, lib):
        def dev(x):
            return (lib.stack1([x, x * 10, -x]),
                    lib.stack1([x % 2 == 0, x % 3 != 0, x > 25]))

        return ctx.Distribute(vals).Filter(lambda x: x != 4).FlatMap(
            None, device_fn=dev, factor=3).Map(lambda x: x + 1)

    _assert_same(*_both(W, job))

    def job_tree(ctx, lib):
        def dev(t):
            return ({"i": lib.stack1([t["i"], t["i"] + 1]),
                     "b": lib.stack1([t["b"], t["b"]])},
                    lib.stack1([t["f"] < 0.5, t["f"] >= 0.25]))

        return ctx.Distribute(_items(19, 7)).FlatMap(None, dev, 2)

    _assert_same(*_both(W, job_tree))


def test_flat_map_needs_the_device_form():
    # without the batched device form, FlatMap takes the host form, as
    # in the reference: per-item lists on host storage
    jctx = _jax_ctx(2)
    try:
        want = jctx.Generate(5).FlatMap(lambda x: [x] * (x % 3)).node \
            .materialize().lists
    finally:
        jctx.close()
    ctx = tt.Context(num_workers=2, device="cpu")
    got = ctx.Generate(5).FlatMap(lambda x: [x] * (x % 3)).node.materialize()
    assert type(got).__name__ == "HostShards"
    assert got.lists == want == [[1], [2, 2, 4]]


def _fill(x, v):
    return x * 0 + v[0]


@pytest.mark.parametrize("W", WIDTHS)
def test_cache_collapse_and_bind(W):
    def job(ctx, lib):
        inv = np.array([0.25])
        d = ctx.Generate(11).Map(lib.Bind(_fill, inv)).Cache().Keep()
        e = d.Map(lambda x: x * 2).Collapse()
        return lib.Zip(d, e, zip_fn=lambda a, b: {"a": a, "b": b})

    _assert_same(*_both(W, job))
    ctx = tt.Context(num_workers=W, device="cpu")
    c = ctx.Generate(5).Map(lambda x: x * 3).Cache()
    assert c.AllGather() == [0, 3, 6, 9, 12]
    with pytest.raises(RuntimeError, match="consume budget"):
        c.AllGather()
