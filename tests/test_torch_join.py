"""The port's InnerJoin against the reference package on the CPU: the
dense-index gather join and the sort-merge join with location detection
off, on and left to the cost model, at W in {1, 2, 4}.

The same items, made from a numpy seed, go through ``thrill_tpu`` and
``thrill_tpu_torch``; per-worker counts and rows must be identical, bit
for bit (a join moves values and calls ``join_fn``, it sums nothing).
"""

import jax
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api import InnerJoin as JInnerJoin
from thrill_tpu.core import preshuffle as jpre
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.core import pallas_kernels as tpk
from thrill_tpu_torch.core import preshuffle as tpre

WIDTHS = [1, 2, 4]
BIG = np.iinfo(np.int64).max


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _both(W, job):
    """(reference, port) of ``job(ctx, InnerJoin)``: the join node's rows
    in worker-rank order and its per-worker counts."""
    jctx = _jax_ctx(W)
    try:
        j = job(jctx, JInnerJoin).node.materialize()
        ref = (j.to_global_numpy(), np.asarray(j.counts).reshape(-1).copy())
    finally:
        jctx.close()
    tctx = tt.Context(num_workers=W, device="cpu")
    t = job(tctx, tt.InnerJoin).node.materialize()
    return ref, (t.to_global_numpy(), t.counts), tctx


def _assert_same(ref, port):
    (jrows, jcounts), (trows, tcounts) = ref, port
    assert np.array_equal(jcounts, tcounts)
    assert jax.tree.structure(jrows) == jax.tree.structure(trows)
    for j, t in zip(jax.tree.leaves(jrows), jax.tree.leaves(trows)):
        j = np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert np.array_equal(t, j)


# -- dense-index join --------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_dense_index_join(W):
    n = 13
    keys = np.array([0, 3, 3, 12, 9, 2, 13, -1, 7, 40, 5, 0], dtype=np.int64)

    def job(ctx, join):
        left = ctx.Distribute({"k": keys, "x": keys * 10})
        right = ctx.Generate(n).Map(lambda g: {"g": g, "y": g * 100})
        return join(left, right, lambda t: t["k"], None,
                    lambda l, r: (l["x"], r["y"], r["g"]),
                    dense_right_index=n)

    ref, port, _ = _both(W, job)
    _assert_same(ref, port)
    # the keys 13, -1 and 40 lie outside [0, 13): no pair
    assert int(port[1].sum()) == 9


@pytest.mark.parametrize("W", WIDTHS)
def test_dense_index_join_all_in_range_keeps_rows_in_place(W):
    rng = np.random.default_rng(1)
    n = 37
    src = rng.integers(0, n, 200).astype(np.int64)

    def job(ctx, join):
        table = ctx.Generate(n).Map(lambda g: g * 3 + 1).Cache()
        return join(ctx.Distribute(src), table, lambda s: s, None,
                    lambda s, v: {"s": s, "v": v}, dense_right_index=n)

    _assert_same(*_both(W, job)[:2])


def test_dense_index_join_refuses_a_right_key():
    ctx = tt.Context(num_workers=2, device="cpu")
    with pytest.raises(ValueError, match="dense_right_index"):
        tt.InnerJoin(ctx.Generate(4), ctx.Generate(4), lambda x: x,
                     lambda x: x, lambda a, b: a, dense_right_index=4)


@pytest.mark.parametrize("W", [2, 4])
def test_dense_index_join_checks_the_dense_split(W):
    ctx = tt.Context(num_workers=W, device="cpu")
    right = ctx.Generate(8).Filter(lambda g: g < 4)
    j = tt.InnerJoin(ctx.Generate(3), right, lambda x: x, None,
                     lambda a, b: a, dense_right_index=4)
    with pytest.raises(ValueError, match="dense range split"):
        j.Size()


# -- sort-merge join ---------------------------------------------------------

def _tables(seed, nl=90, nr=70, keys=25):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, keys, nl).astype(np.int64),
            "a": rng.integers(-99, 99, nl).astype(np.int32),
            "f": rng.random(nl).astype(np.float32)}
    right = {"k": rng.integers(keys // 3, keys + keys // 3,
                               nr).astype(np.int64),
             "b": rng.integers(0, 256, (nr, 3)).astype(np.uint8)}
    return left, right


def _pairs(l, r):
    return {"k": l["k"], "a": l["a"], "f": l["f"], "b": r["b"],
            "rk": r["k"]}


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("ld", [None, True, False])
def test_sort_merge_join(W, ld):
    left, right = _tables(W)

    def job(ctx, join):
        lt = ctx.Distribute(left).Filter(lambda t: t["a"] % 7 != 0)
        return join(lt, ctx.Distribute(right), lambda t: t["k"],
                    lambda t: t["k"], _pairs, location_detection=ld)

    ref, port, tctx = _both(W, job)
    _assert_same(ref, port)
    rows = port[0]
    assert np.array_equal(rows["k"], rows["rk"])
    # every pair exactly once
    lk = left["k"][left["a"] % 7 != 0]
    want = sum(int((lk == k).sum()) for k in right["k"])
    assert int(port[1].sum()) == want
    if ld is None and W > 1:
        assert list(tctx.mesh_exec.prune_verdicts.values()) == [
            tpre._pays(len(lk) + len(right["k"]), 20, W, 2,
                       tpre.register_width(len(lk) + len(right["k"])),
                       tpre._DEFAULT_PRUNE_FRAC)]


@pytest.mark.parametrize("W", WIDTHS)
def test_location_detection_prunes_before_the_exchange(W):
    """Keys that exist on one side only are dropped before the shuffle;
    the pairs are those of the join without the filter, row for row."""
    rng = np.random.default_rng(11)
    left = {"k": rng.integers(0, 1000, 300).astype(np.int64)}
    right = {"k": np.concatenate([rng.integers(0, 40, 30),
                                  rng.integers(5000, 9000, 270)])}

    def run(ld):
        ctx = tt.Context(num_workers=W, device="cpu")
        before = tpk.presence_fill.launches
        j = tt.InnerJoin(ctx.Distribute(left), ctx.Distribute(right),
                         lambda t: t["k"], lambda t: t["k"],
                         lambda l, r: l["k"], location_detection=ld)
        shards = j.node.materialize()
        return (shards.to_global_numpy(), shards.counts,
                ctx.mesh_exec.stats_items_moved,
                tpk.presence_fill.launches - before)

    on, off = run(True), run(False)
    assert np.array_equal(on[0], off[0]) and np.array_equal(on[1], off[1])
    if W > 1:
        assert on[2] < off[2] / 4
        assert on[3] == 0      # the plain version on the CPU launches none
    else:
        assert on[2] == off[2] == 0


def _all_ones_keys_job(ctx, join):
    left = ctx.Distribute(np.array([1, 2, 3, BIG, 2], dtype=np.int64)).Map(
        lambda x: (x, x))
    right = ctx.Distribute(np.array([2, BIG, BIG], dtype=np.int64)).Map(
        lambda x: (x, x * 2))
    return join(left, right, lambda kv: kv[0], lambda kv: kv[0],
                lambda l, r: (l[0], r[1]))


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("ld", [None, True, False])
def test_all_ones_keys(W, ld):
    """A key whose word is all ones (int64 max) matches its equals and
    never the padding rows."""
    def job(ctx, join):
        return _all_ones_keys_job(
            ctx, lambda *a: join(*a, location_detection=ld))

    ref, port, _ = _both(W, job)
    _assert_same(ref, port)
    got = sorted(zip(port[0][0].tolist(), port[0][1].tolist()))
    assert got == [(2, 4), (2, 4), (BIG, BIG * 2 % 2**64 - 2**64),
                   (BIG, BIG * 2 % 2**64 - 2**64)]


@pytest.mark.parametrize("W", WIDTHS)
def test_join_of_empty_and_unmatched_sides(W):
    def job(ctx, join):
        left = ctx.Distribute(np.arange(10, dtype=np.int64)).Filter(
            lambda x: x < 0)
        return join(left, ctx.Generate(5), lambda x: x, lambda x: x,
                    lambda a, b: a + b)

    ref, port, _ = _both(W, job)
    _assert_same(ref, port)
    assert int(port[1].sum()) == 0

    def job2(ctx, join):
        return join(ctx.Generate(6), ctx.Generate(6).Map(lambda x: x + 100),
                    lambda x: x, lambda x: x, lambda a, b: a + b,
                    location_detection=True)

    ref, port, _ = _both(W, job2)
    _assert_same(ref, port)


def test_join_key_words_must_agree():
    ctx = tt.Context(num_workers=1, device="cpu")
    j = tt.InnerJoin(ctx.Generate(3), ctx.Generate(3),
                     lambda x: (x, x), lambda x: x, lambda a, b: a)
    with pytest.raises(ValueError, match="key words"):
        j.Size()


# -- the cost model ----------------------------------------------------------

@pytest.mark.parametrize("rows,item_bytes,W", [
    (0, 24, 4), (300, 20, 2), (4096, 24, 4), (1 << 20, 24, 4),
    (5 * (1 << 22), 24, 4), (5000, 8, 1)])
def test_location_verdict_matches_the_reference_formula(rows, item_bytes, W):
    mex = tt.MeshExec(num_workers=W, device="cpu")
    want = jpre._pays(rows, item_bytes, W, 2, jpre.register_width(rows),
                      jpre._DEFAULT_PRUNE_FRAC)
    assert tpre.auto_location_detect(mex, rows, item_bytes, "s") == want
    # sticky per site
    assert tpre.auto_location_detect(mex, 1, 1, "s") == want


def test_join_rows_estimate_is_exact():
    ctx = tt.Context(num_workers=4, device="cpu")
    left = ctx.Distribute({"a": np.arange(10), "b": np.zeros(10, np.int32)}
                          ).node.materialize()
    right = ctx.Distribute(np.zeros((7, 3), np.uint8)).node.materialize()
    assert tpre.join_rows_estimate(left, right) == (17, (12 + 3) // 2)


def test_location_filter_sends_int64_register_ids_to_the_kernel(monkeypatch):
    """The registers get the ids as ``umod`` makes them (int64) with bool
    flags, no int32 copy; one fill per side."""
    from thrill_tpu_torch.api.ops import join as tjoin
    seen = []

    def spy(h, valid, regs):
        seen.append((h.dtype, valid.dtype, tuple(h.shape), regs))
        return tpk.presence_fill_plain(h, valid, regs)

    monkeypatch.setattr(tjoin, "presence_fill", spy)
    ctx = tt.Context(num_workers=4, device="cpu")
    tt.InnerJoin(ctx.Generate(40), ctx.Generate(9), lambda x: x,
                 lambda x: x, lambda a, b: a,
                 location_detection=True).Size()
    assert seen == [(torch.int64, torch.bool, (4, 16), 4096),
                    (torch.int64, torch.bool, (4, 4), 4096)]
