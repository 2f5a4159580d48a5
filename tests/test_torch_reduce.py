"""The port's ReduceByKey / ReducePair / ReduceToIndex slice against the
reference package on the CPU.

The same items, made from a numpy seed, go through ``thrill_tpu`` and
``thrill_tpu_torch`` at W in {1, 2, 4}. The reference runs its jitted
device engine (``THRILL_TPU_HOST_RADIX=0``): its native CPU engine emits
rows in hash-group order and sums f32 in f64, while the port follows the
device engine. Rows and per-worker counts must then be identical, with
these tolerances:

* integer, bool and key columns: equal bit for bit;
* f32 sums of the FieldReduce engines: the port's plain versions add in
  the same sequential order as the reference on the CPU, but the
  contract is an unordered sum, so ``rtol=1e-5, atol=1e-5`` (a few f32
  ulps of sums of at most a few thousand values of magnitude <= 1);
* f32 folds of a black-box ``reduce_fn``: the port's Hillis-Steele scan
  and ``lax.associative_scan`` combine in different trees, same
  tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api.functors import FieldReduce as JFieldReduce
from thrill_tpu.common import hashing as jhash
from thrill_tpu.core import preshuffle as jpre
from thrill_tpu.core import segmented as jseg
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.dia import DIA as TDIA
from thrill_tpu_torch.api.dia_base import DIABase as TDIABase
from thrill_tpu_torch.common import hashing as thash
from thrill_tpu_torch.core import preshuffle as tpre
from thrill_tpu_torch.core import segmented as tseg
from thrill_tpu_torch.data import shards as tshards

WIDTHS = [1, 2, 4]
RTOL = ATOL = 1e-5


@pytest.fixture
def jitted_reference(monkeypatch):
    """The reference's jitted device engine instead of its native CPU
    engine (read per call by ``host_radix.available``)."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _both(W, job):
    """(reference shards, port shards) of ``job(ctx, FieldReduce)``."""
    jctx = _jax_ctx(W)
    try:
        j = job(jctx, JFieldReduce).node.materialize()
        ref = (j.to_global_numpy(), np.asarray(j.counts).copy())
    finally:
        jctx.close()
    t = job(tt.Context(num_workers=W, device="cpu"),
            tt.FieldReduce).node.materialize()
    return ref, (t.to_global_numpy(), t.counts)


def _assert_same(ref, port):
    (jrows, jcounts), (trows, tcounts) = ref, port
    assert np.array_equal(np.asarray(jcounts).reshape(-1), tcounts)
    jl, tl = jax.tree.leaves(jrows), jax.tree.leaves(
        trows if not isinstance(trows, tuple) else list(trows))
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
        else:
            assert np.array_equal(t, j)


def _words(n, seed, vocab=300):
    """16-byte zero-padded words with Zipf frequencies, plus counts."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 17, vocab)
    voc = rng.integers(97, 123, (vocab, 16)).astype(np.uint8)
    voc[np.arange(16)[None, :] >= lens[:, None]] = 0
    p = 1.0 / np.arange(1, vocab + 1)
    ids = rng.choice(vocab, size=n, p=p / p.sum())
    return {"w": voc[ids], "c": np.ones(n, np.int64),
            "x": rng.random(n).astype(np.float32)}


# -- hashing -----------------------------------------------------------------

def _hash_words(seed):
    rng = np.random.default_rng(seed)
    w = [rng.integers(0, 2**64, 777, dtype=np.uint64) for _ in range(3)]
    w[0][:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
    w[1][::2] |= np.uint64(1 << 63)            # top bit set
    return w


@pytest.mark.parametrize("nwords", [1, 2, 3])
def test_hash_key_words_matches_reference(nwords):
    w = _hash_words(nwords)[:nwords]
    want = np.asarray(jhash.hash_key_words([jnp.asarray(x) for x in w]))
    got = thash.hash_key_words([torch.from_numpy(x.view(np.int64))
                                for x in w])
    assert np.array_equal(got.numpy().view(np.uint64), want)
    # mix64 alone against the reference's numpy version
    assert np.array_equal(
        thash.mix64(torch.from_numpy(w[0].view(np.int64))).numpy()
        .view(np.uint64), jhash.np_mix64(w[0]))
    assert np.array_equal(thash.np_mix64(w[0]), jhash.np_mix64(w[0]))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 7, 4096, 1 << 17, 1000003,
                               1 << 31])
def test_umod_is_the_unsigned_remainder(m):
    h = np.concatenate(_hash_words(9))
    h[:3] = [2**64 - 1, 2**63, 2**63 + 5]
    got = thash.umod(torch.from_numpy(h.view(np.int64)), m).numpy()
    assert np.array_equal(got, (h % np.uint64(m)).astype(np.int64))
    # the reference's hash destination, h % uint64(W), at W = 3 and 4
    if m in (3, 4):
        hj = jhash.hash_key_words([jnp.asarray(h)])
        want = np.asarray(hj % jnp.uint64(m)).astype(np.int64)
        ht = thash.hash_key_words([torch.from_numpy(h.view(np.int64))])
        assert np.array_equal(thash.umod(ht, m).numpy(), want)
    # torch's signed % differs whenever the top bit is set
    if m == 3:
        assert int(thash.umod(torch.tensor([-1]), 3)) == 0
        assert int(torch.tensor([-1]) % 3) == 2


def test_umod_refuses_moduli_outside_its_range():
    with pytest.raises(ValueError):
        thash.umod(torch.zeros(2, dtype=torch.int64), 0)
    with pytest.raises(ValueError):
        thash.umod(torch.zeros(2, dtype=torch.int64), (1 << 31) + 1)


# -- functors and the cost model ---------------------------------------------

def test_field_reduce_equality_spec_and_errors():
    a = tt.FieldReduce({"w": "first", "c": "sum"})
    assert a == tt.FieldReduce({"c": "sum", "w": "first"})
    assert hash(a) == hash(tt.FieldReduce({"w": "first", "c": "sum"}))
    assert a != tt.FieldReduce({"w": "first", "c": "max"})
    from thrill_tpu_torch.common import tree as pt
    x = {"w": torch.tensor([1, 5]), "c": torch.tensor([3, -2])}
    y = {"w": torch.tensor([2, 2]), "c": torch.tensor([4, 9])}
    assert a.flat_spec(pt.flatten(x)[1]) == ["sum", "first"]
    assert a.flat_spec(pt.flatten((1, 2))[1]) is None
    out = tt.FieldReduce({"w": "min", "c": "max"})(x, y)
    assert out["w"].tolist() == [1, 2] and out["c"].tolist() == [4, 9]
    assert a(x, y)["c"].tolist() == [7, 7] and a(x, y)["w"] is x["w"]
    with pytest.raises(TypeError):
        tt.FieldReduce(("first", "sum"))((1, {"a": 2}), (1, {"a": 3}))
    with pytest.raises(ValueError):
        tt.FieldReduce({"w": "avg"})


@pytest.mark.parametrize("rows,item_bytes,W", [
    (0, 24, 4), (10, 24, 4), (4096, 24, 2), (1 << 20, 24, 4),
    (1 << 24, 24, 4), (5000, 8, 1), (123457, 40, 3)])
def test_cost_model_matches_reference(rows, item_bytes, W):
    assert tpre.register_width(rows) == jpre.register_width(rows)
    M = tpre.register_width(rows)
    for frac in (0.0, 0.5, 1.0):
        assert tpre._pays_est(rows, item_bytes, W, 1, M, frac) == \
            jpre._pays_est(rows, item_bytes, W, 1, M, frac)
        assert tpre._pays(rows, item_bytes, W, 1, M, frac) == \
            jpre._pays(rows, item_bytes, W, 1, M, frac)


def test_auto_verdict_sticks_per_site():
    mex = tt.MeshExec(num_workers=4, device="cpu")
    # 2^20 pre-reduced rows of 24 B: about 9.4 MB pruned vs 128 KB
    assert tpre.auto_dup_detect(mex, 1 << 20, 24, "site")
    # the verdict sticks, whatever the later estimate says
    assert tpre.auto_dup_detect(mex, 1, 24, "site")
    assert not tpre.auto_dup_detect(mex, 1, 24, "other")


# -- the segmented engines, function against function ------------------------

def _sorted_runs(n, seed, nvalid):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 40, n)).astype(np.uint64)
    keys[nvalid:] = 0                             # invalid rows: garbage
    valid = np.arange(n) < nvalid
    tree = {"i": rng.integers(-99, 99, n).astype(np.int32),
            "f": rng.normal(size=n).astype(np.float32),
            "b": rng.integers(0, 2, (n, 3)).astype(bool)}
    return keys, valid, tree


@pytest.mark.parametrize("specs", [
    {"i": "sum", "f": "sum", "b": "first"},
    {"i": "min", "f": "first", "b": "first"},
    {"i": "max", "f": "sum", "b": "first"}])
def test_segmented_reduce_fields_matches_reference(specs):
    keys, valid, tree = _sorted_runs(700, 1, 650)
    flat = [specs[k] for k in sorted(specs)]
    jw, jt, jrep = jseg.segmented_reduce_fields(
        [jnp.asarray(keys)], {k: jnp.asarray(v) for k, v in tree.items()},
        jnp.asarray(valid), flat)
    tw, tt_, trep = tseg.segmented_reduce_fields(
        [torch.from_numpy(keys.view(np.int64))[None]],
        {k: torch.from_numpy(v)[None] for k, v in tree.items()},
        torch.from_numpy(valid)[None], flat)
    rep = np.asarray(jrep)
    assert np.array_equal(trep[0].numpy(), rep)
    for k in tree:
        want = np.asarray(jt[k])[rep]
        got = tt_[k][0].numpy()[rep]
        if k == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        else:
            assert np.array_equal(got, want)


def test_generic_segmented_scan_matches_reference():
    keys, valid, tree = _sorted_runs(513, 2, 500)
    rng = np.random.default_rng(3)
    tree = {"m": rng.integers(-2, 3, 513).astype(np.int64),
            "c": tree["i"].astype(np.int64), "f": tree["f"]}

    def fn(mod):
        # composition of affine maps x -> m x + c: associative, not
        # commutative, exact in wrapping int64
        def reduce_fn(a, b):
            return {"m": a["m"] * b["m"], "c": b["m"] * a["c"] + b["c"],
                    "f": mod.maximum(a["f"], b["f"])}
        return reduce_fn

    _, jt, jrep = jseg.segmented_reduce(
        [jnp.asarray(keys)], {k: jnp.asarray(v) for k, v in tree.items()},
        jnp.asarray(valid), fn(jnp))
    _, tt_, trep = tseg.segmented_reduce(
        [torch.from_numpy(keys.view(np.int64))[None]],
        {k: torch.from_numpy(v)[None] for k, v in tree.items()},
        torch.from_numpy(valid)[None], fn(torch))
    rep = np.asarray(jrep)
    assert np.array_equal(trep[0].numpy(), rep)
    for k in tree:
        assert np.array_equal(tt_[k][0].numpy()[rep], np.asarray(jt[k])[rep])


# -- ReduceByKey -------------------------------------------------------------

@pytest.mark.parametrize("dup", [True, False])
@pytest.mark.parametrize("W", WIDTHS)
def test_word_count_matches_reference(jitted_reference, W, dup):
    recs = _words(3000, W)

    def job(ctx, FR):
        return ctx.Distribute(recs).ReduceByKey(
            lambda t: t["w"], FR({"w": "first", "c": "sum", "x": "sum"}),
            dup_detection=dup)

    ref, port = _both(W, job)
    _assert_same(ref, port)
    trows = port[0]
    assert trows["c"].sum() == 3000
    np.testing.assert_allclose(trows["x"].sum(), recs["x"].sum(), rtol=1e-4)


def test_dup_detection_keeps_unique_keys_local():
    """With detection on, a key that only one worker holds stays there;
    off, every key goes to its hash home. Both give the same set."""
    keys = np.concatenate([np.arange(1000, 1400), np.full(400, 7)])
    recs = {"k": keys.astype(np.int64), "c": np.ones(800, np.int64)}
    out = {}
    for dup in (True, False):
        ctx = tt.Context(num_workers=2, device="cpu")
        d = ctx.Distribute(recs).ReduceByKey(
            lambda t: t["k"], tt.FieldReduce({"k": "first", "c": "sum"}),
            dup_detection=dup)
        sh = d.node.materialize()
        out[dup] = sh.to_worker_arrays()
        assert ctx.mesh_exec.stats_exchanges == 1
        moved = ctx.mesh_exec.stats_items_moved
        if dup:
            # worker 0 holds keys 1000..1399, worker 1 the key 7: all unique
            assert moved == 0
            assert np.array_equal(out[dup][0]["k"], np.arange(1000, 1400))
        else:
            assert moved > 0
    for dup in out:
        got = np.concatenate([w["k"] for w in out[dup]])
        assert sorted(got.tolist()) == sorted(np.unique(keys).tolist())


@pytest.mark.parametrize("W", WIDTHS)
def test_word_count_auto_verdict_matches_reference(jitted_reference, W):
    recs = _words(2000, 10 + W)

    def job(ctx, FR):
        return ctx.Distribute(recs).Filter(lambda t: t["x"] < 0.9) \
            .ReduceByKey(lambda t: t["w"], FR({"w": "first", "c": "sum",
                                              "x": "first"}))

    _assert_same(*_both(W, job))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_pair_op_string_matches_reference(jitted_reference, W, op):
    rng = np.random.default_rng(20 + W)
    recs = {"k": rng.integers(-30, 30, 2500).astype(np.int64),
            "v": rng.integers(-1000, 1000, 2500).astype(np.int32)}
    _assert_same(*_both(W, lambda c, FR: c.Distribute(recs).Map(
        lambda r: (r["k"], r["v"])).ReducePair(op)))


@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_pair_callable_matches_reference(jitted_reference, W):
    rng = np.random.default_rng(30 + W)
    recs = {"k": rng.integers(0, 50, 2000).astype(np.int32),
            "n": rng.integers(0, 9, 2000).astype(np.int64),
            "f": rng.random(2000).astype(np.float32)}

    def job(ctx, FR):
        return ctx.Distribute(recs).Map(
            lambda r: (r["k"], {"n": r["n"], "f": r["f"]})).ReducePair(
            lambda a, b: {"n": a["n"] + b["n"], "f": a["f"] + b["f"]})

    _assert_same(*_both(W, job))


@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_pair_lambda_sum_matches_reference(jitted_reference, W):
    rng = np.random.default_rng(40 + W)
    recs = {"k": rng.integers(0, 64, 1500).astype(np.uint8),
            "v": rng.integers(0, 1 << 40, 1500).astype(np.int64)}
    _assert_same(*_both(W, lambda c, FR: c.Distribute(recs).Map(
        lambda r: (r["k"], r["v"])).ReducePair(lambda a, b: a + b)))


# -- ReduceToIndex -----------------------------------------------------------

def _edges(n, size, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, size + 1)
    d = rng.choice(size, size=n, p=p / p.sum())
    d[:5] = size - 1                             # the last index is hit
    return {"d": d.astype(np.int64), "v": rng.random(n).astype(np.float32),
            "i": rng.integers(-500, 500, n).astype(np.int32)}


@pytest.mark.parametrize("neutral", [None, {"d": 0, "v": 0.0, "i": 0},
                                     {"d": -1, "v": 2.5, "i": 7}])
@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_to_index_sum_matches_reference(jitted_reference, W, neutral):
    """The f32 "sum" is the segment-sum kernel's path."""
    e = _edges(3000, 700, W)

    def job(ctx, FR):
        return ctx.Distribute(e).ReduceToIndex(
            lambda c: c["d"], FR({"d": "first", "v": "sum", "i": "sum"}),
            777, neutral=neutral)

    ref, port = _both(W, job)
    _assert_same(ref, port)
    want = np.bincount(e["d"], weights=e["v"], minlength=777)
    np.testing.assert_allclose(port[0]["v"][want > 0], want[want > 0],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_to_index_first_min_max_matches_reference(jitted_reference, W):
    e = _edges(2500, 300, 10 + W)
    e["v"][::9] = -e["v"][::9]

    def job(ctx, FR):
        return ctx.Distribute(e).Filter(lambda c: c["i"] % 5 != 0) \
            .ReduceToIndex(lambda c: c["d"],
                           FR({"d": "max", "v": "first", "i": "min"}), 321,
                           neutral={"d": 3, "v": -1.0, "i": 0})

    _assert_same(*_both(W, job))


@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_to_index_float_min_max_matches_reference(jitted_reference, W):
    e = _edges(1800, 200, 20 + W)

    def job(ctx, FR):
        return ctx.Distribute(e).ReduceToIndex(
            lambda c: c["d"], FR({"d": "first", "v": "max", "i": "max"}),
            250)

    _assert_same(*_both(W, job))


@pytest.mark.parametrize("W", WIDTHS)
def test_reduce_to_index_generic_fn_matches_reference(jitted_reference, W):
    """A black-box reduce function takes the sorted fallback."""
    e = _edges(2000, 400, 30 + W)

    def job(ctx, FR):
        return ctx.Distribute(e).ReduceToIndex(
            lambda c: c["d"],
            lambda a, b: {"d": a["d"], "v": a["v"] + b["v"],
                          "i": a["i"] ^ b["i"]},
            450, neutral={"d": -1, "v": 0.5, "i": 1})

    _assert_same(*_both(W, job))


# -- the same shards through both packages -----------------------------------

class _Shards(TDIABase):
    """A port node whose result is given shards."""

    def __init__(self, ctx, shards):
        super().__init__(ctx, "Shards")
        self.shards = shards

    def compute(self):
        return self.shards


def _carried(W, recs, keep):
    """Reference shards after a Filter, and the same shards in the port."""
    jctx = _jax_ctx(W)
    jsh = jctx.Distribute(recs).Filter(keep)._link().pull()
    tree = {k: np.asarray(v) for k, v in jsh.tree.items()}
    tsh = tshards.from_numpy_shards(tree, np.asarray(jsh.counts), "cpu")
    return jctx, TDIA(_Shards(tt.Context(mesh_exec=tsh.mesh_exec), tsh))


@pytest.mark.parametrize("dup", [True, False])
@pytest.mark.parametrize("W", WIDTHS)
def test_same_shards_through_both_reduce_by_keys(jitted_reference, W, dup):
    recs = _words(2500, 50 + W)
    keep = lambda t: t["w"][:, 0] != 98
    red = {"w": "first", "c": "sum", "x": "sum"}
    jctx, tdia = _carried(W, recs, keep)
    try:
        j = jctx.Distribute(recs).Filter(keep).ReduceByKey(
            lambda t: t["w"], JFieldReduce(red),
            dup_detection=dup).node.materialize()
        ref = (j.to_global_numpy(), np.asarray(j.counts).copy())
    finally:
        jctx.close()
    t = tdia.ReduceByKey(lambda t: t["w"], tt.FieldReduce(red),
                         dup_detection=dup).node.materialize()
    _assert_same(ref, (t.to_global_numpy(), t.counts))


@pytest.mark.parametrize("W", WIDTHS)
def test_same_shards_through_both_reduce_to_index(jitted_reference, W):
    e = _edges(2200, 500, 60 + W)
    keep = lambda c: c["i"] > -300
    red = {"d": "first", "v": "sum", "i": "max"}
    jctx, tdia = _carried(W, e, keep)
    try:
        j = jctx.Distribute(e).Filter(keep).ReduceToIndex(
            lambda c: c["d"], JFieldReduce(red), 600).node.materialize()
        ref = (j.to_global_numpy(), np.asarray(j.counts).copy())
    finally:
        jctx.close()
    t = tdia.ReduceToIndex(lambda c: c["d"], tt.FieldReduce(red),
                           600).node.materialize()
    _assert_same(ref, (t.to_global_numpy(), t.counts))


def test_reduce_sizes_and_allgather():
    def job(ctx):
        d = ctx.Generate(1000, lambda i: (i * 7) % 13).Map(
            lambda k: (k, torch.ones_like(k))).ReducePair("sum").Keep()
        return d.Size(), sorted(d.AllGather())

    want = list(enumerate(np.bincount((np.arange(1000) * 7) % 13).tolist()))
    for size, items in tt.RunLocalTests(job, worker_counts=WIDTHS,
                                        device="cpu"):
        assert size == 13
        assert items == want


def test_dup_detection_at_256_workers_uses_int_registers():
    """From 256 workers a u8 holder count could wrap, so the registers
    are int32 scatter-max as in the reference; the result set is the
    same as without detection."""
    rng = np.random.default_rng(77)
    recs = {"k": rng.integers(0, 700, 1500).astype(np.int64),
            "c": np.ones(1500, np.int64)}
    got = {}
    for dup in (True, False):
        ctx = tt.Context(num_workers=256, device="cpu")
        out = ctx.Distribute(recs).ReduceByKey(
            lambda t: t["k"], tt.FieldReduce({"k": "first", "c": "sum"}),
            dup_detection=dup).node.materialize().to_global_numpy()
        order = np.argsort(out["k"])
        got[dup] = (out["k"][order], out["c"][order])
    keys, counts = np.unique(recs["k"], return_counts=True)
    for dup in got:
        assert np.array_equal(got[dup][0], keys)
        assert np.array_equal(got[dup][1], counts)
