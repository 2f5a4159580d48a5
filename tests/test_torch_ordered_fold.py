"""The port's ordered float sums against the reference package on the CPU.

Every float "sum" outside the f32 segment-sum kernel is, in the
reference, a scatter-add that XLA applies in operand order
(``.at[pos].add``, ``jax.ops.segment_sum``). The port folds each run
left to right through ``core/ordered_fold.py``, whose plain version runs
here. Every comparison is bit for bit (``np.array_equal`` of the bytes):

* the plain fold against ``np.add.at``, ``.at[].add`` and
  ``jax.ops.segment_sum``, f64 ``[T]`` and ``[T, 8]``, f32 ``[T, 3]``,
  the halves, Zipf-hot ids, dropped ids and a run whose sum depends on
  the order (``1.0 + 1e16 - 1e16``);
* ReduceToIndex, ReduceByKey and GroupByKey's ``segment_sum`` through
  both packages at W = 1, 2, 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api.functors import FieldReduce as JFieldReduce
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.core import ordered_fold as of
from thrill_tpu_torch.core import segmented as tseg

WIDTHS = [1, 2, 4]
SEGS = 50


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _zipf_ids(rng, n, segs, drop):
    p = 1.0 / np.arange(1, segs + 1)
    ids = rng.choice(segs, size=n, p=p / p.sum()).astype(np.int64)
    if drop:
        ids[rng.random(n) < 0.1] = segs          # dropped past the end
        ids[rng.random(n) < 0.05] = -3           # and below
    return ids


def _values(rng, n, trail, dtype):
    v = rng.standard_normal((n,) + trail) * 10.0 ** rng.integers(
        -8, 9, (n,) + trail)
    v[:3] = np.reshape([1.0, 1e16, -1e16], (3,) + (1,) * len(trail))
    return v.astype(dtype)


CASES = [("f64", (), np.float64), ("f64x8", (8,), np.float64),
         ("f32x3", (3,), np.float32)]


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("name,trail,dtype", CASES)
def test_plain_fold_equals_the_references_ordered_scatter(name, trail, dtype,
                                                          drop):
    rng = np.random.default_rng(len(name) + drop)
    n = 4000
    ids = _zipf_ids(rng, n, SEGS, drop)
    ids[:3] = 7                     # the order-dependent run: 1 + 1e16 - 1e16
    vals = _values(rng, n, trail, dtype)
    got = of.ordered_fold(torch.as_tensor(vals), torch.as_tensor(ids),
                          SEGS).numpy()
    keep = (ids >= 0) & (ids < SEGS)
    want_np = np.zeros((SEGS,) + trail, dtype)
    np.add.at(want_np, ids[keep], vals[keep])
    # .at[] wraps negative ids: the reference parks dropped rows past the
    # end instead
    pos = np.where(keep, ids, SEGS)
    want_at = np.asarray(jnp.zeros((SEGS,) + trail, dtype).at[
        jnp.asarray(pos)].add(jnp.asarray(vals), mode="drop"))
    want_seg = np.asarray(jax.ops.segment_sum(
        jnp.asarray(vals), jnp.asarray(ids), num_segments=SEGS))
    assert _bits_equal(got, want_np)
    assert _bits_equal(got, want_at)
    assert _bits_equal(got, want_seg)


def test_the_order_dependent_run_keeps_its_order():
    vals = torch.tensor([1.0, 1e16, -1e16, 3.0], dtype=torch.float64)
    ids = torch.tensor([0, 0, 0, 1])
    got = of.ordered_fold(vals, ids, 2)
    assert got.tolist() == [0.0, 3.0]        # (1 + 1e16) - 1e16 == 0
    back = of.ordered_fold(vals.flip(0), ids.flip(0), 2)
    assert back.tolist() == [1.0, 3.0]       # (-1e16 + 1e16) + 1 == 1


@pytest.mark.parametrize("cols", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_folds_equal_the_references_scatter(dtype, cols):
    """The halves round after every add; the reference's CPU scatter of
    the same type agrees bit for bit."""
    rng = np.random.default_rng(3)
    ids = _zipf_ids(rng, 3000, 20, True)
    vals = rng.standard_normal((3000,) + cols).astype(np.float32)
    tv = torch.as_tensor(vals).to(dtype)
    got = of.ordered_fold(tv, torch.as_tensor(ids), 20)
    jdt = jnp.float16 if dtype == torch.float16 else jnp.bfloat16
    want = jax.ops.segment_sum(jnp.asarray(tv.float().numpy()).astype(jdt),
                               jnp.asarray(ids), num_segments=20)
    assert _bits_equal(got.float().numpy(),
                       np.asarray(want.astype(jnp.float32)))


def test_plain_fold_takes_runs_without_an_order():
    rng = np.random.default_rng(9)
    vals = torch.as_tensor(rng.standard_normal((40, 2)))
    offsets = torch.tensor([0, 0, 5, 6, 40])
    got = of.ordered_segment_sum(vals, None, offsets)
    want = torch.stack([_seq(vals[0:0]), _seq(vals[0:5]), _seq(vals[5:6]),
                        _seq(vals[6:40])])
    assert _bits_equal(got.numpy(), want.numpy())
    assert of.ordered_segment_sum.launches == 0       # the CPU's plain version


def _seq(rows):
    acc = torch.zeros(rows.shape[1:], dtype=rows.dtype)
    for r in rows:
        acc = acc + r
    return acc


def test_group_rows_is_stable_and_drops_out_of_range_ids():
    ids = torch.tensor([3, 1, 3, 9, 0, 1, -1, 3])
    order, offsets = of.group_rows(ids, 4)
    assert offsets.tolist() == [0, 1, 3, 3, 6]
    assert order[:6].tolist() == [4, 1, 5, 0, 2, 7]
    assert sorted(order[6:].tolist()) == [3, 6]


# -- through both packages ---------------------------------------------------

@pytest.fixture
def jitted_reference(monkeypatch):
    """The reference's jitted device engine (its native CPU engine sums in
    hash-group order)."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _both(W, job):
    jctx = _jax_ctx(W)
    try:
        j = job(jctx, JFieldReduce).node.materialize()
        ref = (j.to_global_numpy(), np.asarray(j.counts).reshape(-1).copy())
    finally:
        jctx.close()
    t = job(tt.Context(num_workers=W, device="cpu"),
            tt.FieldReduce).node.materialize()
    return ref, (t.to_global_numpy(), t.counts)


def _assert_bits(ref, port):
    (jrows, jcounts), (trows, tcounts) = ref, port
    assert np.array_equal(jcounts, tcounts)
    for k in jrows:
        assert _bits_equal(trows[k], np.asarray(jrows[k])), k


def _edges(n, size, seed):
    rng = np.random.default_rng(seed)
    d = _zipf_ids(rng, n, size, False)
    d[:3] = 11
    return {"d": d, "v": _values(rng, n, (), np.float64),
            "w": _values(rng, n, (8,), np.float64),
            "x": _values(rng, n, (3,), np.float32)}


@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_to_index_float_sums_are_the_references_bits(jitted_reference,
                                                             W):
    e = _edges(3000, 400, W)

    def job(ctx, FR):
        return ctx.Distribute(e).ReduceToIndex(
            lambda c: c["d"], FR({"d": "first", "v": "sum", "w": "sum",
                                  "x": "sum"}), 450)

    _assert_bits(*_both(W, job))


@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_by_key_float_sums_are_the_references_bits(jitted_reference,
                                                           W):
    e = _edges(2500, 120, 10 + W)

    def job(ctx, FR):
        return ctx.Distribute(e).ReduceByKey(
            lambda c: c["d"], FR({"d": "first", "v": "sum", "w": "sum",
                                  "x": "sum"}))

    _assert_bits(*_both(W, job))


class _JL:
    seg_sum = staticmethod(jax.ops.segment_sum)


class _TL:
    seg_sum = staticmethod(tseg.segment_sum)


@pytest.mark.parametrize("W", WIDTHS)
def test_group_by_key_segment_sum_is_the_references_bits(W):
    e = _edges(1500, 60, 20 + W)

    def fold(L):
        def device_fn(tree, seg, nseg):
            return {"d": L.seg_sum(tree["d"], seg, num_segments=nseg),
                    "v": L.seg_sum(tree["v"], seg, num_segments=nseg),
                    "w": L.seg_sum(tree["w"], seg, num_segments=nseg),
                    "x": L.seg_sum(tree["x"], seg, num_segments=nseg)}
        return device_fn

    def job(ctx, L):
        return ctx.Distribute(e).GroupByKey(lambda r: r["d"],
                                            device_fn=fold(L))

    jctx = _jax_ctx(W)
    try:
        j = job(jctx, _JL).node.materialize()
        ref = (j.to_global_numpy(), np.asarray(j.counts).reshape(-1).copy())
    finally:
        jctx.close()
    t = job(tt.Context(num_workers=W, device="cpu"), _TL).node.materialize()
    _assert_bits(ref, (t.to_global_numpy(), t.counts))
