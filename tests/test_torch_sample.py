"""The port's Sample, BernoulliSample, SortStable and MeshExec.jit_cached
against the reference package on the CPU, at W in {1, 2, 4}.

The port draws with ``torch.Generator``s and cannot reproduce
``jax.random``'s bits, so the sampling tests hold the contract: Sample's
per-worker takes equal the reference's for the same seed (both split
the budget with the same numpy hypergeometric draws), its rows are a
subset in their original order; BernoulliSample keeps each item with
probability p (counts within 5 sigma of the binomial mean), in order,
the same rows for the same seed. SortStable must equal the reference
row for row.
"""

import jax
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.common.sampling import hypergeometric_split as j_split
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.ops import sample as tsample
from thrill_tpu_torch.common.sampling import hypergeometric_split

WIDTHS = [1, 2, 4]


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _ctx(W):
    return tt.Context(num_workers=W, device="cpu")


def _per_worker(dia):
    return [a.tolist() for a in dia.node.materialize().to_worker_arrays()]


def _uneven(ctx, n):
    """Items 0..n-1 (their global index), unevenly spread: a Filter
    drops every third item of the first half."""
    return ctx.Generate(n).Filter(lambda x: (x >= n // 2) | (x % 3 != 0))


def test_hypergeometric_split_is_the_reference_s():
    for seed in range(20):
        counts = np.random.default_rng(seed).integers(0, 500, seed % 6 + 1)
        for k in (0, 1, 17, int(counts.sum()), int(counts.sum()) + 5):
            got = hypergeometric_split(np.random.default_rng(seed), k,
                                       counts)
            want = j_split(np.random.default_rng(seed), k, counts)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert got.sum() == min(k, counts.sum())


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("k,seed", [(1, 0), (37, 3), (200, 11), (599, 5)])
def test_sample_takes_match_reference(W, k, seed):
    n = 800
    jctx = _jax_ctx(W)
    try:
        jd = _uneven(jctx, n).Sample(k, seed=seed)
        want = np.asarray(jd.node.materialize().counts).tolist()
    finally:
        jctx.close()
    got = _per_worker(_uneven(_ctx(W), n).Sample(k, seed=seed))
    assert [len(r) for r in got] == want
    assert sum(want) == min(k, 800 - len(range(0, n // 2, 3)))


@pytest.mark.parametrize("W", WIDTHS)
def test_sample_is_an_ordered_subset_of_each_worker(W):
    ctx = _ctx(W)
    src = _uneven(ctx, 1000).Cache().Keep(3)
    inputs = _per_worker(src)
    for seed in (0, 1, 2):
        out = _per_worker(src.Sample(123, seed=seed))
        for w, (o, i) in enumerate(zip(out, inputs)):
            assert o == sorted(set(o)), "not in order or not distinct"
            assert set(o) <= set(i), f"worker {w} kept foreign rows"
        assert sum(len(o) for o in out) == 123


@pytest.mark.parametrize("W", WIDTHS)
def test_sample_edges(W):
    ctx = _ctx(W)
    src = ctx.Distribute({"a": np.arange(50), "b": -np.arange(50.0)}) \
        .Cache().Keep(3)
    everything = src.Sample(50, seed=4).AllGatherArrays()
    assert everything["a"].tolist() == list(range(50))
    assert everything["b"].tolist() == [-float(i) for i in range(50)]
    assert src.Sample(500, seed=4).Size() == 50
    assert src.Sample(0, seed=4).Size() == 0


def test_sample_is_uniform():
    """Each of 64 items lands in a sample of 8 with probability 1/8: over
    600 seeds every item's hits stay within 5 sigma of 75."""
    src = _ctx(4).Generate(64).Cache().Keep(600)
    hits = np.zeros(64, dtype=np.int64)
    for seed in range(600):
        hits[src.Sample(8, seed=seed).AllGather()] += 1
    p = 8 / 64
    sigma = np.sqrt(600 * p * (1 - p))
    assert np.abs(hits - 600 * p).max() <= 5 * sigma, hits


def test_sample_repeats_for_a_seed_and_varies_between_seeds():
    src = _ctx(2).Generate(5000).Cache().Keep(4)
    a = src.Sample(100, seed=9).AllGather()
    assert src.Sample(100, seed=9).AllGather() == a
    assert src.Sample(100, seed=10).AllGather() != a


@pytest.mark.parametrize("W", WIDTHS)
def test_bernoulli_sample_edges(W):
    src = _ctx(W).Distribute({"i": np.arange(300), "v": np.arange(300.0)}) \
        .Cache().Keep(2)
    assert src.BernoulliSample(0.0, seed=1).Size() == 0
    got = src.BernoulliSample(1.0, seed=1).AllGatherArrays()
    assert got["i"].tolist() == list(range(300))
    assert got["v"].tolist() == [float(i) for i in range(300)]


@pytest.mark.parametrize("W", WIDTHS)
def test_bernoulli_sample_keeps_each_item_with_probability_p(W):
    n, p = 40000, 0.25
    src = _uneven(_ctx(W), n).Cache().Keep(3)
    size = n - len(range(0, n // 2, 3))
    sigma = np.sqrt(size * p * (1 - p))
    for seed in (0, 1, 2):
        per = _per_worker(src.BernoulliSample(p, seed=seed))
        kept = sum(len(r) for r in per)
        assert abs(kept - size * p) <= 5 * sigma, kept
        for r in per:
            assert r == sorted(set(r))


def test_bernoulli_sample_seeds_and_worker_streams():
    W, per = 4, 4096
    src = _ctx(W).Generate(W * per).Cache().Keep(3)
    a = _per_worker(src.BernoulliSample(0.5, seed=7))
    assert _per_worker(src.BernoulliSample(0.5, seed=7)) == a
    assert _per_worker(src.BernoulliSample(0.5, seed=8)) != a
    # each worker draws its own stream: the kept local offsets differ
    local = [tuple(x - w * per for x in r) for w, r in enumerate(a)]
    assert len(set(local)) == W


def test_worker_uniforms_are_f64_on_the_mesh_device():
    mex = tt.MeshExec(num_workers=3, device="cpu")
    u = tsample.worker_uniforms(mex, 5, 1000)
    assert u.dtype == torch.float64 and u.shape == (3, 1000)
    assert u.device == mex.device
    assert ((u >= 0) & (u < 1)).all()
    assert torch.equal(u, tsample.worker_uniforms(mex, 5, 1000))
    assert not torch.equal(u, tsample.worker_uniforms(mex, 5, 1000,
                                                      stream=1))
    # f32 draws would take at most 2^24 values: f64 ones do not tie here
    assert len(torch.unique(u)) == u.numel()


@pytest.mark.parametrize("W", WIDTHS)
def test_sort_stable_matches_reference_row_for_row(W):
    rng = np.random.default_rng(W)
    n = 3000
    items = {"k": rng.integers(0, 5, n).astype(np.int64),
             "f": rng.integers(-3, 3, n).astype(np.float64) / 2,
             "p": np.arange(n, dtype=np.int64)}

    def job(c):
        a = c.Distribute(items).SortStable(key_fn=lambda t: t["k"])
        b = c.Distribute(items).SortStable(key_fn=lambda t: (t["f"], t["k"]))
        return a.AllGather(), b.AllGather()

    jctx = _jax_ctx(W)
    try:
        want = job(jctx)
    finally:
        jctx.close()
    got = job(_ctx(W))
    assert got == want
    ks = [t["k"] for t in got[0]]
    assert ks == sorted(ks)


def test_jit_cached_keys_a_callable_and_counts_its_calls():
    mex = tt.MeshExec(num_workers=2, device="cpu")
    f = mex.jit_cached(("update",), lambda a, b: a + b)
    assert mex.jit_cached(("update",), lambda a, b: a - b) is f
    g = mex.jit_cached(("other",), lambda a, b: a - b)
    assert g is not f
    assert f(2, 3) == 5 and f(torch.tensor(1), 1).item() == 2
    assert g(2, 3) == -1
    assert (f.calls, g.calls) == (2, 1)
    built = []
    h = mex.cached(("built",), lambda: built.append(1) or (lambda: 7))
    assert mex.cached(("built",), lambda: built.append(1)) is h
    assert built == [1] and h() == 7
