"""The port's Merge, exchange_presorted and multiway_merge against the
reference package on the CPU.

The same sorted inputs, made from a numpy seed, go through
``thrill_tpu`` and ``thrill_tpu_torch`` at W in {1, 2, 3, 4}: the merged
rows and the per-worker counts must be identical (integers, bit for
bit). The counts depend on the splitters, which the host picks from
samples in unsigned order: keys with the sign bit set (negative int64,
or unsigned keys of 2^63 and above) would move them if the port ordered
its int64 words as signed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api import Merge as JMerge
from thrill_tpu.core.multiway_merge import multiway_merge as jmm
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import tree as pt
from thrill_tpu_torch.core.multiway_merge import multiway_merge as tmm
from thrill_tpu_torch.data import exchange as texchange
from thrill_tpu_torch.data.shards import DeviceShards
from thrill_tpu_torch.parallel.mesh import MeshExec

WIDTHS = [1, 2, 3, 4]


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _both(W, job):
    """(reference, port) of ``job(ctx, Merge, unsigned)``: rows in
    worker-rank order and per-worker counts."""
    jctx = _jax_ctx(W)
    try:
        j = job(jctx, JMerge,
                lambda x: x.astype(jnp.uint64)).node.materialize()
        ref = (j.to_global_numpy(), np.asarray(j.counts).reshape(-1).copy())
    finally:
        jctx.close()
    t = job(tt.Context(num_workers=W, device="cpu"), tt.Merge,
            lambda x: x.view(torch.uint64)).node.materialize()
    return ref, (t.to_global_numpy(), t.counts)


def _assert_same(ref, port):
    (jrows, jcounts), (trows, tcounts) = ref, port
    assert np.array_equal(jcounts, tcounts)
    jl, tl = jax.tree.leaves(jrows), pt.leaves(trows)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert b.dtype == a.dtype and np.array_equal(b, a)


def _sorted_inputs(seed, sizes, lo, hi, unsigned=False):
    """Inputs of ``{"k", "p"}`` sorted by k (as unsigned when asked),
    ``p`` tagging input and position."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        k = rng.integers(lo, hi, n).astype(np.int64)
        order = np.argsort(k.view(np.uint64) if unsigned else k,
                           kind="stable")
        out.append({"k": k[order],
                    "p": (i << 32) + np.arange(n, dtype=np.int64)})
    return out


@pytest.mark.parametrize("W", WIDTHS)
def test_merge_of_three_inputs_with_heavy_ties_matches_reference(W):
    """Signed keys with negatives over 13 values: equal keys order by
    input, then position, and the counts equal the reference's."""
    ins = _sorted_inputs(W, [160, 90, 61], -6, 7)

    def job(ctx, Merge, _):
        return Merge(*[ctx.Distribute(x) for x in ins],
                     key_fn=lambda r: r["k"])

    ref, port = _both(W, job)
    _assert_same(ref, port)
    cat = {k: np.concatenate([x[k] for x in ins]) for k in ("k", "p")}
    order = np.lexsort((cat["p"], cat["k"]))
    assert np.array_equal(port[0]["p"], cat["p"][order])


@pytest.mark.parametrize("W", WIDTHS)
def test_merge_of_unsigned_keys_at_and_above_2_63_matches_reference(W):
    """Keys read as uint64: the negative int64 values are keys of 2^63
    and above, which sort after the others."""
    ins = _sorted_inputs(10 + W, [70, 130], -(1 << 62), 1 << 62,
                         unsigned=True)
    ins[0]["k"][-3:] = -1                   # the largest key, 2^64 - 1
    ins[1]["k"][:2] = 0

    def job(ctx, Merge, unsigned):
        return Merge(*[ctx.Distribute(x) for x in ins],
                     key_fn=lambda r: unsigned(r["k"]))

    ref, port = _both(W, job)
    _assert_same(ref, port)
    k = port[0]["k"].view(np.uint64)
    assert np.all(k[1:] >= k[:-1]) and k[-1] == 2**64 - 1


@pytest.mark.parametrize("W", WIDTHS)
def test_merge_with_empty_and_skewed_inputs_matches_reference(W):
    """One input filtered to a few rows on one worker, one plain."""
    ins = _sorted_inputs(20 + W, [50, 64], 0, 1000)

    def job(ctx, Merge, _):
        a = ctx.Distribute(ins[0]["k"]).Filter(lambda k: k < 200)
        b = ctx.Distribute(ins[1]["k"])
        return Merge(a, b)

    _assert_same(*_both(W, job))


@pytest.mark.parametrize("W", WIDTHS)
def test_merge_host_and_mixed_storage_match_reference(W):
    a = [1, 3, 5, 7, 7, 9]
    b = [1, 2, 7, 8]
    for storage in ("host", None):
        jctx = _jax_ctx(W)
        try:
            want = JMerge(jctx.Distribute(a, storage="host"),
                          jctx.Distribute(b, storage=storage)
                          ).node.materialize().lists
        finally:
            jctx.close()
        ctx = tt.Context(num_workers=W, device="cpu")
        got = tt.Merge(ctx.Distribute(a, storage="host"),
                       ctx.Distribute(b, storage=storage)
                       ).node.materialize().lists
        assert got == [[int(x) for x in l] for l in want]


def test_dia_merge_method_equals_the_free_function():
    ctx = tt.Context(num_workers=2, device="cpu")
    a = ctx.Distribute(np.arange(0, 20, 2, dtype=np.int64))
    b = ctx.Distribute(np.arange(1, 20, 2, dtype=np.int64))
    assert [int(x) for x in a.Merge(b).AllGather()] == list(range(20))


@pytest.mark.parametrize("seed", range(4))
def test_multiway_merge_matches_reference(seed):
    rng = np.random.default_rng(seed)
    runs = [sorted((int(k), i, j) for j, k in enumerate(
        rng.integers(0, 6, int(rng.integers(0, 12)))))
        for i in range(int(rng.integers(1, 6)))]
    key = (lambda t: t[0])
    assert list(tmm(runs, key)) == list(jmm(runs, key))
    assert list(tmm(runs)) == list(jmm(runs))


@pytest.mark.parametrize("W", WIDTHS)
def test_exchange_presorted_keeps_rank_order(W):
    """Each receiver gets its senders' runs in rank order, each run in
    its sender's order; counts are the send matrix's column sums."""
    rng = np.random.default_rng(W)
    mex = MeshExec(num_workers=W, device="cpu")
    counts = rng.integers(0, 40, W)
    cap = 64
    dest = np.full((W, cap), W, dtype=np.int64)
    for w in range(W):
        dest[w, :counts[w]] = np.sort(rng.integers(0, W, counts[w]))
    vals = rng.integers(0, 1 << 40, (W, cap)).astype(np.int64)
    S = np.stack([np.bincount(dest[w][dest[w] < W], minlength=W)
                  for w in range(W)]).astype(np.int64)
    out = texchange.exchange_presorted(
        mex, pt.flatten({"v": 0})[1], torch.as_tensor(dest),
        [torch.as_tensor(vals)], S)
    assert isinstance(out, DeviceShards)
    assert np.array_equal(out.counts, S.sum(axis=0))
    got = out.to_worker_arrays()
    for r in range(W):
        want = np.concatenate([vals[s][:counts[s]][dest[s][:counts[s]] == r]
                               for s in range(W)])
        assert np.array_equal(got[r]["v"], want)
