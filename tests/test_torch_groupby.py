"""The port's GroupByKey, GroupToIndex and segment folds against the
reference package on the CPU.

The same items, made from a numpy seed, go through ``thrill_tpu`` and
``thrill_tpu_torch`` at W in {1, 2, 3, 4}.

* ``device_fn`` results: row for row, with the per-worker counts (both
  packages sort each worker's groups by key words after the same hash
  exchange). Integers bit for bit; f32 sums within ``rtol=1e-6,
  atol=1e-6`` (sums of at most a few hundred values below 1, added in
  another order).
* ``group_fn`` results: per-worker multisets. On the CPU the reference
  groups by hash (first-appearance order) and the port by key sort, an
  order the contract leaves open; the worker of each group is fixed by
  the hash in both.
* GroupToIndex: row for row, with and without ``neutral``.
* ``segment_sum/max/min/count``: equal to ``jax.ops.segment_*`` with ids
  out of range on both sides dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import tree as pt
from thrill_tpu_torch.core import segmented as tseg

WIDTHS = [1, 2, 3, 4]
TOL = 1e-6


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


class _J:
    seg_sum = staticmethod(jax.ops.segment_sum)
    seg_max = staticmethod(jax.ops.segment_max)
    seg_min = staticmethod(jax.ops.segment_min)
    i32 = jnp.int32

    @staticmethod
    def ones(x):
        return jnp.ones(x.shape[0], jnp.int32)


class _T:
    seg_sum = staticmethod(tseg.segment_sum)
    seg_max = staticmethod(tseg.segment_max)
    seg_min = staticmethod(tseg.segment_min)
    i32 = torch.int32

    @staticmethod
    def ones(x):
        return torch.ones(x.shape[0], dtype=torch.int32)


def _both(W, job):
    jctx = _jax_ctx(W)
    try:
        j = job(jctx, _J).node.materialize()
        ref = j.lists if hasattr(j, "lists") else (
            j.to_global_numpy(), np.asarray(j.counts).reshape(-1).copy())
    finally:
        jctx.close()
    t = job(tt.Context(num_workers=W, device="cpu"), _T).node.materialize()
    return ref, (t.lists if hasattr(t, "lists") else
                 (t.to_global_numpy(), t.counts))


def _assert_rows(ref, port):
    (jrows, jcounts), (trows, tcounts) = ref, port
    assert np.array_equal(jcounts, tcounts)
    jl, tl = jax.tree.leaves(jrows), pt.leaves(trows)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert b.dtype == a.dtype and b.shape == a.shape
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
        else:
            assert np.array_equal(b, a)


def _items(n, keys, seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-keys, keys, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32)}


def _fold(L):
    def device_fn(tree, seg, nseg):
        return {"k": L.seg_max(tree["k"], seg, num_segments=nseg),
                "n": L.seg_sum(L.ones(tree["v"]), seg, num_segments=nseg),
                "s": L.seg_sum(tree["v"], seg, num_segments=nseg),
                "lo": L.seg_min(tree["v"], seg, num_segments=nseg)}
    return device_fn


@pytest.mark.parametrize("W", WIDTHS)
def test_group_by_key_device_fn_matches_reference_row_for_row(W):
    items = _items(300, 20, W)

    def job(ctx, L):
        return ctx.Distribute(items).GroupByKey(lambda r: r["k"],
                                                device_fn=_fold(L))

    ref, port = _both(W, job)
    _assert_rows(ref, port)
    rows = port[0]
    assert sorted(rows["k"].tolist()) == sorted(set(items["k"].tolist()))
    assert int(rows["n"].sum()) == 300


@pytest.mark.parametrize("W", WIDTHS)
def test_group_by_key_device_fn_after_a_filter_matches_reference(W):
    """Padding rows (a Filter leaves counts below the capacity) are
    never folded into a group: the port gives them the dropped id
    ``num_segments``, the reference parks them in an unused slot."""
    items = _items(257, 9, 30 + W)

    def job(ctx, L):
        return ctx.Distribute(items).Filter(lambda r: r["v"] < 0.6) \
            .GroupByKey(lambda r: r["k"] * 3, device_fn=_fold(L))

    _assert_rows(*_both(W, job))


@pytest.mark.parametrize("W", WIDTHS)
def test_group_by_key_padding_rows_carry_the_dropped_id(W):
    """Every row past a worker's count reaches ``device_fn`` with id
    ``num_segments``; every live row with an id of its worker's range."""
    items = _items(257, 9, 40 + W)
    seen = {}

    def device_fn(tree, seg, nseg):
        seen.update(seg=seg.clone(), nseg=nseg)
        return tseg.segment_count(seg, nseg)

    ctx = tt.Context(num_workers=W, device="cpu")
    out = ctx.Distribute(items).Filter(lambda r: r["v"] < 0.6) \
        .GroupByKey(lambda r: r["k"], device_fn=device_fn)
    shards = out.node.materialize()
    seg, nseg = seen["seg"].numpy(), seen["nseg"]
    cap = nseg // W
    live = seg < nseg
    assert int(live.sum()) == int((items["v"] < 0.6).sum())
    assert (seg[~live] == nseg).all()
    assert (seg[live] // cap == np.flatnonzero(live) // cap).all()
    assert int(shards.counts.sum()) == len(set(
        items["k"][items["v"] < 0.6].tolist()))


@pytest.mark.parametrize("W", WIDTHS)
def test_group_by_key_group_fn_matches_reference_per_worker(W):
    items = _items(240, 15, 50 + W)

    def job(ctx, L):
        return ctx.Distribute(items).GroupByKey(
            lambda r: r["k"],
            lambda k, rs: (int(k), len(rs), round(sum(float(r["v"])
                                                      for r in rs), 4)))

    ref, port = _both(W, job)
    assert [sorted(l) for l in port] == [sorted(l) for l in ref]


@pytest.mark.parametrize("W", WIDTHS)
def test_group_by_key_tuple_keys_match_reference_per_worker(W):
    vals = np.arange(100, dtype=np.int64)

    def job(ctx, L):
        return ctx.Distribute(vals).Map(lambda x: (x % 3, x % 4, x)) \
            .GroupByKey(lambda t: (t[0], t[1]),
                        lambda k, ts: (k, sorted(int(t[2]) for t in ts)))

    ref, port = _both(W, job)
    assert [sorted(l) for l in port] == [sorted(l) for l in ref]


def test_group_by_key_of_host_storage_names_the_roadmap():
    """GroupByKey of host items gives the reference's groups; a
    ``device_fn`` alone, or no function, is refused by name."""
    def job(ctx, L):
        return ctx.Distribute(["a", "b", "a"]).GroupByKey(
            lambda s: s, lambda k, it: (k, len(it)))

    ref, port = _both(2, job)
    assert port == ref
    assert sorted(g for l in port for g in l) == [("a", 2), ("b", 1)]
    ctx = tt.Context(num_workers=2, device="cpu")
    with pytest.raises(ValueError, match="requires group_fn"):
        ctx.Distribute(["a"]).GroupByKey(
            lambda s: s, device_fn=lambda t, s, n: t).AllGather()
    with pytest.raises(ValueError, match="needs group_fn"):
        ctx.Generate(4).GroupByKey(lambda x: x).AllGather()


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("neutral", [None, -1])
def test_group_to_index_device_fn_matches_reference(W, neutral):
    """Indices out of range on both sides are dropped; index 3 and the
    top ones receive nothing."""
    rng = np.random.default_rng(70 + W)
    idx = rng.integers(-3, 40, 200).astype(np.int64)
    idx[idx == 3] = 4
    items = {"i": idx, "v": rng.random(200).astype(np.float32)}

    def job(ctx, L):
        def device_fn(tree, ids, nseg):
            return (L.seg_sum(tree["v"], ids, num_segments=nseg),
                    L.seg_sum(L.ones(tree["v"]), ids, num_segments=nseg))

        return ctx.Distribute(items).GroupToIndex(
            lambda r: r["i"], None, 45, neutral=neutral,
            device_fn=device_fn)

    ref, port = _both(W, job)
    _assert_rows(ref, port)
    s, n = port[0]
    assert len(s) == 45 and int(n[3]) == (-1 if neutral == -1 else 0)


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("neutral", [None, -1])
def test_group_to_index_host_path_matches_reference(W, neutral):
    vals = np.arange(30, dtype=np.int64)

    def job(ctx, L):
        return ctx.Distribute(vals).GroupToIndex(
            lambda x: x % 7 + (x % 7 > 2), lambda i, xs: sum(int(x)
                                                             for x in xs),
            9, neutral=neutral)

    ref, port = _both(W, job)
    assert port == ref


@pytest.mark.parametrize("fold", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int32])
def test_segment_folds_drop_ids_out_of_range_as_jax_does(fold, dtype):
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((64, 3)) * 100).astype(dtype)
    ids = rng.integers(-4, 12, 64).astype(np.int32)
    jfn = getattr(jax.ops, f"segment_{fold}")
    tfn = getattr(tseg, f"segment_{fold}")
    for d in (data, data[:, 0]):
        want = np.asarray(jfn(jnp.asarray(d), jnp.asarray(ids),
                              num_segments=9))
        got = tfn(torch.as_tensor(d), torch.as_tensor(ids), 9).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    counts = tseg.segment_count(torch.as_tensor(ids), 9).numpy()
    assert counts.tolist() == np.bincount(ids[(ids >= 0) & (ids < 9)],
                                          minlength=9).tolist()
