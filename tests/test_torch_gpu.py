"""The port's CUDA kernels, its Sort and its reduces on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the reference package, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import thrill_tpu_torch as tt
from thrill_tpu_torch.core import device_sort as tds
from thrill_tpu_torch.core import pallas_kernels as tpk
from thrill_tpu_torch.core import pallas_sort as tps


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# int64 ids at and beyond 32 bits: a kernel that cut them to int32 would
# count 2^32 + 1 in bin 1
_WIDE_IDS = [2**31 - 1, 2**31, 2**32, 2**32 + 1, 2**32 + 3, -2**31,
             -2**32 + 1, -1, 2**63 - 1, -2**63]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lo,hi,bins,dtype,sort", [
    ((4, 1 << 16), 0, 256, 256, np.int32, False),  # radix digits
    ((3, 4097), -9, 300, 256, np.int32, False),    # out of range, ragged
    ((4, 5000), 0, 5, 4, np.int32, False),   # send counts: 4 = invalid
    ((2, 8192), 3, 4, 256, np.int32, False),       # one digit everywhere
    ((0,), 0, 1, 8, np.int32, False),              # empty
    # the exchange's sorted int64 destinations with a sentinel tail
    ((4, 1 << 20), 0, 5, 4, np.int64, True),
    ((4, 1 << 20), 0, 5, 4, np.int64, False),      # random int64
    ((4, 1 << 20), 0, 5, 4, np.int32, True),       # Sort's int32 dests
    ((3, 4097), 0, 40, 32, np.int64, False),       # int64, scalar loads
    ((3, 70001), -2, 40, 33, np.int64, False),     # int64, out of range
    ((2, 0), 0, 1, 4, np.int64, False),            # empty rows
])
def test_cuda_kernels_match_plain(cuda_device, shape, lo, hi, bins, dtype,
                                  sort):
    rng = np.random.default_rng(9)
    d = rng.integers(lo, hi, size=shape).astype(dtype)
    if sort:
        d.sort(axis=-1)
    d = torch.as_tensor(d, device=cuda_device)
    launches = (tpk.partition_histogram.launches,
                tps.stable_partition_offsets.launches)
    assert torch.equal(tpk.partition_histogram(d, bins),
                       tpk.partition_histogram_plain(d, bins))
    offsets = dtype == np.int32               # the offsets take int32 ids
    if offsets:
        assert torch.equal(tps.stable_partition_offsets(d, bins),
                           tps.stable_partition_offsets_plain(d, bins))
    assert (tpk.partition_histogram.launches,
            tps.stable_partition_offsets.launches) == (
                launches[0] + 1, launches[1] + offsets)


@pytest.mark.gpu
@pytest.mark.parametrize("W,bins", [(4, 4), (2, 5), (4, 256)])
def test_histogram_ignores_int64_ids_beyond_32_bits(cuda_device, W, bins):
    rng = np.random.default_rng(W + bins)
    d = np.concatenate([np.tile(_WIDE_IDS, (W, 1)),
                        rng.integers(0, bins, (W, 5000))], axis=1)
    d = torch.as_tensor(rng.permuted(d.astype(np.int64), axis=1),
                        device=cuda_device)
    before = tpk.partition_histogram.launches
    got = tpk.partition_histogram(d, bins)
    assert tpk.partition_histogram.launches == before + 1
    assert torch.equal(got, tpk.partition_histogram_plain(d, bins))
    assert torch.equal(got[:, 1].cpu(), (d == 1).sum(dim=1).to(
        torch.int32).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["histogram", "presence_fill"])
def test_kernels_repeat_on_one_stream(cuda_device, kernel):
    # back-to-back launches of other shapes on one stream stay exact (the
    # presence fill's bitsets, which each launch leaves zeroed, serve the
    # next launch)
    rng = np.random.default_rng(17)
    for rows, n in ((4, 1 << 20), (2, 777), (6, 1 << 18), (1, 5)):
        d = torch.as_tensor(rng.integers(-1, 4100, (rows, n)),
                            device=cuda_device)
        valid = torch.as_tensor(rng.random((rows, n)) < 0.5,
                                device=cuda_device)
        for bins in (4, 5, 3, 4096, 100):
            if kernel == "histogram":
                assert torch.equal(tpk.partition_histogram(d % 7, bins),
                                   tpk.partition_histogram_plain(d % 7, bins))
            elif kernel == "presence_fill":
                assert torch.equal(tpk.presence_fill(d, valid, bins),
                                   tpk.presence_fill_plain(d, valid, bins))


def _keys_with_digit(rng, d, shift):
    """Random int64 words whose byte at ``shift`` is ``d``."""
    keys = rng.integers(-2**63, 2**63, d.shape, dtype=np.int64)
    keys.view(np.uint8).reshape(d.shape + (8,))[..., shift // 8] = d
    return keys


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "skewed", "ragged"])
def test_radix_pass_and_offsets_match_plain(cuda_device, case):
    # 2^20 keys per row: 256 tiles a row, over a wave of the card, so a
    # tile's look-back waits on tiles of other blocks
    rng = np.random.default_rng(13)
    W, n = 4, (1 << 20) + (4097 if case == "ragged" else 0)
    d = rng.integers(0, 256, (W, n)).astype(np.uint8)
    if case == "skewed":
        d[rng.random((W, n)) < 0.9] = 7
    shift = 16
    keys = torch.as_tensor(_keys_with_digit(rng, d, shift), device=cuda_device)
    perm = torch.as_tensor(np.argsort(rng.random((W, n)), axis=1).astype(
        np.int32), device=cuda_device)
    hist = tps.radix_upsweep(keys)[:, shift // 8]
    for p, gather in ((perm, False), (perm, True), (None, True)):
        before = tps.radix_pass.launches
        got = tps.radix_pass(keys, p, shift, hist, gather=gather)
        want = tps.radix_pass_plain(keys, p, shift, gather=gather)
        assert tps.radix_pass.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ids = torch.as_tensor(d.astype(np.int32), device=cuda_device)
    for bins in (256, 7):                     # 7: most ids are sentinels
        assert torch.equal(tps.stable_partition_offsets(ids, bins),
                           tps.stable_partition_offsets_plain(ids, bins))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ndigits", [((4, 1 << 20), 8), ((3, 70001), 3),
                                           ((1, 1), 8), ((2, 0), 8)])
def test_radix_upsweep_matches_plain(cuda_device, shape, ndigits):
    rng = np.random.default_rng(14)
    words = rng.integers(-2**63, 2**63, shape, dtype=np.int64)
    words[..., ::2] |= np.int64(-2**63)       # the sign bit set
    words[..., 1::3] &= np.int64(0xffff)      # equal high bytes
    w = torch.as_tensor(words, device=cuda_device)
    assert torch.equal(tps.radix_upsweep(w, ndigits),
                       tps.radix_upsweep_plain(w, ndigits))


@pytest.mark.gpu
def test_argsort_words_three_words_match_plain(cuda_device):
    rng = np.random.default_rng(15)
    W, n = 4, (1 << 20) + 3
    words = [rng.integers(-2**63, 2**63, (W, n), dtype=np.int64),
             rng.integers(0, 5, (W, n)).astype(np.int64) << 60,
             np.arange(W * n).reshape(W, n)]
    words[0][:, ::3] = words[0][:, :1]        # ties broken by later words
    words[1][:, ::2] = 0
    tw = [torch.as_tensor(np.ascontiguousarray(x), device=cuda_device)
          for x in words]
    passes = []
    assert torch.equal(tds.argsort_words(tw, passes=passes),
                       tds.plain_argsort_words(tw))
    assert passes[0][1] == 24


@pytest.mark.gpu
def test_radix_engine_matches_plain_engine(cuda_device):
    rng = np.random.default_rng(10)
    words = [torch.as_tensor(rng.integers(-2**63, 2**63, (4, 30000),
                                          dtype=np.int64), device=cuda_device),
             torch.as_tensor(rng.integers(0, 3, (4, 30000), dtype=np.int64),
                             device=cuda_device)]
    words[0][:, ::5] = 11                  # ties broken by the second word
    assert torch.equal(tds.argsort_words(words),
                       tds.plain_argsort_words(words))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 2, 4])
def test_terasort_on_the_card_matches_the_cpu(cuda_device, W):
    rng = np.random.default_rng(99 + W)
    recs = {"key": rng.integers(0, 256, (1 << 16, 10)).astype(np.uint8),
            "value": rng.integers(0, 256, (1 << 16, 90)).astype(np.uint8)}
    recs["key"][::3, :9] = 0               # equal keys: ties by index

    def job(ctx):
        return ctx.Distribute(recs).Filter(lambda r: r["value"][:, 0] != 7) \
            .Sort(key_fn=lambda r: r["key"]).AllGatherArrays()

    out = tt.Run(job, W, device=cuda_device)
    cpu = tt.Run(job, W, device="cpu")
    for k in recs:
        assert torch.equal(out[k].cpu(), cpu[k])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lo,hi,segs", [
    ((4, 1 << 16), 0, 4096, 4096),        # shared-memory accumulators
    ((4, 1 << 16), 0, 1 << 20, 1 << 20),  # global atomics
    ((3, 4097), -9, 300, 256),            # out of range, ragged rows
    ((2, 8192), 3, 4, 16),                # one segment everywhere
    ((0,), 0, 1, 8),                      # empty
])
def test_segment_sum_matches_plain(cuda_device, shape, lo, hi, segs):
    rng = np.random.default_rng(11)
    ids = torch.as_tensor(rng.integers(lo, hi, size=shape, dtype=np.int32),
                          device=cuda_device)
    vals = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                           device=cuda_device)
    before = tpk.segment_sum.launches
    got = tpk.segment_sum(ids, vals, segs)
    want = tpk.segment_sum_plain(ids, vals, segs)
    assert tpk.segment_sum.launches == before + 1
    # atomics add in another order: 1e-4 of the segment's absolute sum
    scale = tpk.segment_sum_plain(ids, vals.abs(), segs)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())


def _zipf(rng, n, segs):
    cdf = np.cumsum(1.0 / np.arange(1, segs + 1))
    return np.minimum(np.searchsorted(cdf / cdf[-1], rng.random(n)),
                      segs - 1).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zipf", "distinct", "sentinels", "ragged"])
def test_segment_sum_table_path_within_tolerance(cuda_device, case):
    # segments beyond the shared-memory path: the per-tile hash table
    rng = np.random.default_rng(16)
    S = 1 << 20
    if case == "zipf":                        # PageRank's hot pages
        ids = _zipf(rng, 1 << 22, S)[None]
    elif case == "distinct":                  # every id once: tiles of
        ids = rng.permutation(S).astype(np.int32)[None]  # distinct ids
    elif case == "sentinels":
        ids = rng.integers(-1, S + 100, (3, 70001)).astype(np.int32)
    else:                                     # n % 4 != 0: scalar loads
        ids = _zipf(rng, 2 * ((1 << 18) + 3), S).reshape(2, -1)
    vals = rng.normal(size=ids.shape).astype(np.float32)
    it = torch.as_tensor(ids, device=cuda_device)
    vt = torch.as_tensor(vals, device=cuda_device)
    before = tpk.segment_sum.launches
    got = tpk.segment_sum(it, vt, S)
    assert tpk.segment_sum.launches == before + 1
    want = tpk.segment_sum_plain(it, vt, S)
    scale = tpk.segment_sum_plain(it, vt.abs(), S)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lo,hi,regs,dtype,prefix", [
    ((4, 1 << 16), 0, 1 << 17, 1 << 17, np.int32, None),  # WordCount's M
    ((3, 4097), -9, 300, 256, np.int32, None),  # out of range, ragged rows
    ((0,), 0, 1, 8, np.int32, None),            # empty
    # WordCount's int64 register ids with a compacted valid prefix
    ((4, 1 << 20), 0, 1 << 17, 1 << 17, np.int64, 0.22),
    ((3, 4097), -9, 1000, 1000, np.int64, 0.5),  # ragged, odd M
    ((4, 1 << 20), -1, (1 << 17) + 1, 1 << 17, np.int64, None),  # unsorted
    ((2, 1 << 16), 0, 1 << 20, 1 << 20, np.int64, None),  # largest bitset
    ((2, 4096), 0, 4096, 4096, np.int64, 0.0),  # no valid row
])
def test_presence_fill_matches_plain(cuda_device, shape, lo, hi, regs, dtype,
                                     prefix):
    rng = np.random.default_rng(12)
    h = torch.as_tensor(rng.integers(lo, hi, size=shape).astype(dtype),
                        device=cuda_device)
    if prefix is None:
        valid = rng.random(shape) < 0.7
    else:
        valid = np.broadcast_to(np.arange(shape[-1]) < prefix * shape[-1],
                                shape).copy()
    valid = torch.as_tensor(valid, device=cuda_device)
    before = tpk.presence_fill.launches
    assert torch.equal(tpk.presence_fill(h, valid, regs),
                       tpk.presence_fill_plain(h, valid, regs))
    assert tpk.presence_fill.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("regs", [4, 1 << 17, 1 << 20])
def test_presence_fill_ignores_int64_ids_beyond_32_bits(cuda_device, regs):
    rng = np.random.default_rng(regs)
    rest = rng.integers(0, regs, (2, 3000))
    rest[(rest == 1) | (rest == 3)] = 0
    h = np.concatenate([np.tile(_WIDE_IDS, (2, 1)), rest], axis=1)
    h = torch.as_tensor(rng.permuted(h.astype(np.int64), axis=1),
                        device=cuda_device)
    valid = (torch.rand(h.shape, device=cuda_device) < 0.6) | (
        h.abs() >= 2**31 - 1)
    got = tpk.presence_fill(h, valid, regs)
    assert torch.equal(got, tpk.presence_fill_plain(h, valid, regs))
    assert int(got[:, 1].sum()) == 0 and int(got[:, 3].sum()) == 0


@pytest.mark.gpu
def test_presence_fill_refuses_registers_beyond_the_bitset(cuda_device):
    h = torch.zeros((2, 64), dtype=torch.int64, device=cuda_device)
    valid = torch.ones((2, 64), dtype=torch.bool, device=cuda_device)
    before = tpk.presence_fill.launches
    with pytest.raises(ValueError):
        tpk.presence_fill(h, valid, tpk.BITSET_REGS + 1)
    assert tpk.presence_fill.launches == before


@pytest.mark.gpu
def test_presence_fill_failed_launch_leaves_no_stale_bits(cuda_device,
                                                          monkeypatch):
    # a launch that fails after its fill set bits must not hand them to
    # the next launch on the stream
    rng = np.random.default_rng(18)
    h = torch.as_tensor(rng.integers(0, 4096, (4, 5000)), device=cuda_device)
    valid = torch.as_tensor(rng.random((4, 5000)) < 0.1, device=cuda_device)
    tpk.presence_fill(h, valid, 4096)         # the stream's bitsets exist

    def failing(*args):
        for bits in tpk._bitsets.values():
            bits.fill_(-1)                    # bits the expand never cleared
        return 1                              # cudaErrorInvalidValue

    monkeypatch.setattr(tpk, "_pres_lib", lambda: failing)
    before = tpk.presence_fill.launches
    with pytest.raises(RuntimeError):
        tpk.presence_fill(h, valid, 4096)
    assert tpk.presence_fill.launches == before
    monkeypatch.undo()
    assert torch.equal(tpk.presence_fill(h, valid, 4096),
                       tpk.presence_fill_plain(h, valid, 4096))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 2, 4])
def test_reduces_on_the_card_match_the_cpu(cuda_device, W):
    rng = np.random.default_rng(200 + W)
    n = 1 << 15
    recs = {"k": rng.integers(0, 3000, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32)}

    def job(ctx):
        d = ctx.Distribute(recs).Keep(2)
        wc = d.Map(lambda r: {"k": r["k"], "c": torch.ones_like(r["k"])}) \
            .ReduceByKey(lambda r: r["k"],
                         tt.FieldReduce({"k": "first", "c": "sum"}),
                         dup_detection=True).AllGatherArrays()
        pr = d.ReduceToIndex(lambda r: r["k"],
                             tt.FieldReduce({"k": "first", "v": "sum"}),
                             3500).AllGatherArrays()
        return wc, pr

    (wc, pr), (wc_c, pr_c) = tt.Run(job, W, cuda_device), tt.Run(job, W,
                                                                  "cpu")
    for k in ("k", "c"):
        assert torch.equal(wc[k].cpu(), wc_c[k])
    assert torch.equal(pr["k"].cpu(), pr_c["k"])
    assert torch.allclose(pr["v"].cpu(), pr_c["v"], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 4])
def test_join_with_location_detection_on_the_card(cuda_device, W):
    rng = np.random.default_rng(300 + W)
    left = {"k": rng.integers(0, 5000, 20000).astype(np.int64),
            "a": rng.integers(0, 99, 20000).astype(np.int32)}
    right = {"k": rng.integers(2500, 9000, 30000).astype(np.int64)}

    def job(ctx):
        return tt.InnerJoin(ctx.Distribute(left), ctx.Distribute(right),
                            lambda t: t["k"], lambda t: t["k"],
                            lambda l, r: {"k": r["k"], "a": l["a"]},
                            location_detection=True).AllGatherArrays()

    before = (tpk.presence_fill.launches, tpk.partition_histogram.launches)
    got = tt.Run(job, W, cuda_device)
    assert tpk.presence_fill.launches == before[0] + 2      # one per side
    assert tpk.partition_histogram.launches >= before[1] + 2
    want = tt.Run(job, W, "cpu")
    for k in ("k", "a"):
        assert torch.equal(got[k].cpu(), want[k])


@pytest.mark.gpu
def test_zip_pad_on_the_card(cuda_device):
    def job(ctx):
        return tt.Zip(ctx.Generate(1000), ctx.Generate(
            37, lambda i: {"v": i * 3 + 1, "w": i.to(torch.int32)}),
            zip_fn=lambda x, s: {"x": x, "v": s["v"], "w": s["w"]},
            mode="pad").AllGatherArrays()

    got, want = tt.Run(job, 4, cuda_device), tt.Run(job, 4, "cpu")
    for k in ("x", "v", "w"):
        assert torch.equal(got[k].cpu(), want[k])
    assert not got["v"][37:].any() and not got["w"][37:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_page_rank_on_the_card(cuda_device, W):
    from thrill_tpu_torch.examples import page_rank as tpr
    edges = tpr.zipf_graph(5000, 60000, seed=W)
    got = tpr.page_rank(tt.Context(num_workers=W, device=cuda_device), edges,
                        5000, 3)
    want = tpr.page_rank(tt.Context(num_workers=W, device="cpu"), edges,
                         5000, 3)
    # f64 scatter-adds on the card add in no fixed order
    assert np.abs(got - want).max() <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_sampling_on_the_card(cuda_device, W):
    from thrill_tpu_torch.api.ops import sample as tsample
    from thrill_tpu_torch.common.sampling import hypergeometric_split
    mex = tt.MeshExec(num_workers=W, device=cuda_device)
    u = tsample.worker_uniforms(mex, 3, 1 << 16)
    assert u.device.type == "cuda" and u.dtype == torch.float64
    ctx = tt.Context(mex)
    n = W * 50000
    src = ctx.Generate(n).Filter(lambda x: x % 5 != 0).Cache().Keep(4)
    inputs = [set(a.tolist()) for a in
              src.node.materialize().to_worker_arrays()]
    counts = [len(i) for i in inputs]
    tps.radix_upsweep.launches = 0
    smp = ctx.Generate(n).Filter(lambda x: x % 5 != 0).Sample(999, seed=8)
    per = [a.tolist() for a in smp.node.materialize().to_worker_arrays()]
    assert tps.radix_upsweep.launches > 0         # the score argsort
    takes = hypergeometric_split(np.random.default_rng(8), 999, counts)
    assert [len(p) for p in per] == takes.tolist()
    for p, i in zip(per, inputs):
        assert p == sorted(set(p)) and set(p) <= i
    p = 0.25
    kept = src.BernoulliSample(p, seed=2)
    per = [a.tolist() for a in kept.node.materialize().to_worker_arrays()]
    total = sum(counts)
    assert abs(sum(len(x) for x in per) - total * p) <= 5 * np.sqrt(
        total * p * (1 - p))
    for x, i in zip(per, inputs):
        assert x == sorted(set(x)) and set(x) <= i
    assert src.BernoulliSample(1.0, seed=2).Size() == total
    assert src.BernoulliSample(0.0, seed=2).Size() == 0


def _lloyd_np(pts, c, iters):
    for _ in range(iters):
        d2 = ((pts * pts).sum(1, keepdims=True) - 2.0 * pts @ c.T
              + (c * c).sum(1)[None, :])
        lab = d2.argmin(1)
        cnt = np.bincount(lab, minlength=len(c)).astype(np.float64)
        sums = np.stack([np.bincount(lab, weights=pts[:, j],
                                     minlength=len(c))
                         for j in range(pts.shape[1])], axis=1)
        c = np.where((cnt > 0)[:, None], sums / np.maximum(cnt, 1)[:, None],
                     c)
    return c


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_k_means_on_the_card(cuda_device, W):
    from thrill_tpu_torch.examples import k_means as tkm
    rng = np.random.default_rng(W)
    pts = rng.normal(size=(1 << 16, 8))
    got = tkm.k_means(tt.Context(num_workers=W, device=cuda_device), pts,
                      10, iterations=5, seed=1)
    c0 = pts[np.random.default_rng(1).choice(len(pts), 10, replace=False)]
    want = _lloyd_np(pts, c0, 5)
    assert np.abs(got - want).max() <= 1e-9 * (1 + np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_suffix_array_on_the_card(cuda_device, W):
    from thrill_tpu_torch.examples import suffix_sorting as tss
    text = np.random.default_rng(W).integers(97, 101, 1 << 16).astype(
        np.uint8)
    sa = tss.suffix_array(tt.Context(num_workers=W, device=cuda_device),
                          text)
    assert tss.check_sa(text, sa)
    got = tss.wavelet_tree(tt.Context(num_workers=W, device=cuda_device),
                           text[:5000])
    want = tss.wavelet_tree(tt.Context(num_workers=W, device="cpu"),
                            text[:5000])
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
