"""The port's CUDA kernels, its Sort, its reduces and its memory ladder on the card.

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


@pytest.fixture
def device_engines(monkeypatch):
    """The CPU run a test holds the card against takes the device
    engines, which the card runs: a CPU mesh otherwise takes the native
    engine (core/host_radix.py), whose rows come in first-appearance
    order and whose float sums group in another order."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")


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
def test_reduces_on_the_card_match_the_cpu(cuda_device, device_engines, W):
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


@pytest.mark.gpu
@pytest.mark.parametrize("max_word", [1, 5, 16])
def test_tokenizer_on_the_card_matches_the_cpu(cuda_device, max_word):
    from thrill_tpu_torch.core import text as ttext
    rng = np.random.default_rng(max_word)
    data = rng.choice(np.frombuffer(b"ab \t\n\r\x0b\x0c\xc3\xa9xyz",
                                    dtype=np.uint8), size=1 << 20)
    cpu = torch.from_numpy(data)
    starts = torch.tensor([0, 1000, 1000, 77777, 500000])
    for args in ((), (starts,)):
        want = ttext.tokenize_chunks(cpu, *args, max_word=max_word)
        got = ttext.tokenize_chunks(cpu.to(cuda_device),
                                    *[a.to(cuda_device) for a in args],
                                    max_word=max_word)
        assert got[0].device.type == "cuda"
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_files_round_trip_on_the_card(cuda_device, tmp_path, W):
    rng = np.random.default_rng(W)
    recs = rng.integers(0, 256, size=(3001, 100)).astype(np.uint8)
    for i, cut in enumerate(np.array_split(recs, 3)):
        (tmp_path / f"in{i}.bin").write_bytes(cut.tobytes())
    text = b" ".join(b"w%d" % (i % 97) for i in range(20000))
    (tmp_path / "t.txt").write_bytes(text)

    def job(dev):
        ctx = tt.Context(num_workers=W, device=dev)
        d = ctx.ReadBinary(str(tmp_path / "in*.bin"), dtype=np.uint8,
                           record_shape=(100,))
        out = tmp_path / str(dev) / "out-$$$$$.bin"
        d.Sort(lambda r: r[:, :10]).WriteBinary(str(out))
        words = ctx.ReadWordsPacked(str(tmp_path / "t.txt")).AllGatherArrays()
        return (b"".join(open(p, "rb").read() for p in sorted(
            (tmp_path / str(dev)).iterdir())), words["w"].cpu())

    got, want = job(cuda_device), job("cpu")
    assert got[0] == want[0] and len(got[0]) == recs.nbytes
    assert torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int64,
                                   torch.float64])
def test_segment_folds_on_the_card_match_the_cpu(cuda_device, dtype):
    """The batched segment helpers drop ids out of range on the card,
    where scatter_reduce_ would assert; one f32 column sums through the
    segment-sum kernel (B3)."""
    from thrill_tpu_torch.core import segmented as tseg
    rng = np.random.default_rng(3)
    n, segs = 1 << 18, 1 << 12
    ids = torch.as_tensor(rng.integers(-50, segs + 50, n))
    data = torch.as_tensor(rng.integers(-9, 9, (n, 2))).to(dtype)
    for d in (data[:, 0].contiguous(), data):
        launches = tpk.segment_sum.launches
        got = tseg.segment_sum(d.to(cuda_device), ids.to(cuda_device), segs)
        b3 = dtype == torch.float32 and d.dim() == 1
        assert tpk.segment_sum.launches == launches + b3
        assert torch.equal(got.cpu(), tseg.segment_sum(d, ids, segs))
        for fold in (tseg.segment_max, tseg.segment_min):
            assert torch.equal(fold(d.to(cuda_device), ids.to(cuda_device),
                                    segs).cpu(), fold(d, ids, segs))
    assert torch.equal(tseg.segment_count(ids.to(cuda_device), segs).cpu(),
                       tseg.segment_count(ids, segs))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 3, 4])
def test_window_halo_on_the_card_matches_the_cpu(cuda_device, W):
    x = np.random.default_rng(W).random(100003).astype(np.float32)

    def job(ctx):
        d = ctx.Distribute(x).Filter(lambda v: v < 0.9).Cache().Keep(3)
        return (d.Window(16, None, device_fn=lambda w: w.sum(1))
                .AllGatherArrays(),
                d.DisjointWindow(16, None, device_fn=lambda w: w.amax(1))
                .AllGatherArrays(),
                d.FlatWindow(2, device_fn=lambda w: (
                    (w[:, 1] - w[:, 0])[:, None], w[:, :1] < 0.5),
                    factor=1).AllGatherArrays(),
                dict(ctx.mesh_exec.device_runs))

    got = tt.Run(job, W, cuda_device)
    assert got[3] == {"Window": 1, "DisjointWindow": 1, "FlatWindow": 1}
    want = tt.Run(job, W, "cpu")
    assert got[0].device.type == "cuda"
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=1e-6)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_group_merge_and_hll_on_the_card_match_the_cpu(cuda_device, W):
    from thrill_tpu_torch.api.ops import hll as thll
    from thrill_tpu_torch.core import segmented as tseg
    rng = np.random.default_rng(W)
    items = {"k": rng.integers(0, 5000, 1 << 16),
             "v": rng.integers(0, 100, 1 << 16).astype(np.float32)}
    a = np.sort(rng.integers(-(1 << 40), 1 << 40, 30000))
    b = np.sort(rng.integers(-(1 << 40), 1 << 40, 20000))

    def job(ctx):
        g = ctx.Distribute(items).GroupByKey(
            lambda r: r["k"], device_fn=lambda t, s, n: (
                tseg.segment_max(t["k"], s, n), tseg.segment_sum(t["v"], s, n),
                tseg.segment_count(s, n))).node.materialize()
        m = tt.Merge(ctx.Distribute(a), ctx.Distribute(b)).node.materialize()
        regs = thll.device_registers(ctx.Distribute(items["k"])._link().pull(),
                                     12)
        return ([x.cpu() for x in g.tree], g.counts, m.to_global_numpy(),
                m.counts, regs.cpu())

    got, want = tt.Run(job, W, cuda_device), tt.Run(job, W, "cpu")
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[3], want[3])
    # integer-valued f32 sums below 2^24 are exact in any order
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g[:, :int(got[1].max())], w[:, :int(got[1].max())])
    assert np.array_equal(got[2], want[2])
    assert torch.equal(got[4], want[4])


@pytest.mark.gpu
def test_host_reduce_then_a_device_sort_on_the_card(cuda_device, monkeypatch):
    """Host ReduceByKey of string pairs, spilled into the default spill
    directory, then ``ToDevice().Sort()`` on the card by (count, hash):
    equal to Python's sort, with B1 and the radix pass launched."""
    import collections
    import os

    from thrill_tpu_torch.common.hashing import stable_host_hash
    monkeypatch.setenv("THRILL_TPU_HOST_TABLE_CAP", "64")
    monkeypatch.setenv("THRILL_TPU_SPILL_RESIDENT", "64K")
    rng = np.random.default_rng(5)
    words = [f"w{int(i)}" for i in rng.integers(0, 20000, 60000)]
    ctx = tt.Context(num_workers=4, device=cuda_device)
    assert os.access(ctx.config.spill_dir, os.W_OK)

    def signed(h):
        return h - (1 << 64) if h >= 1 << 63 else h

    red = ctx.Distribute(words, storage="host").Map(
        lambda w: (w, 1)).ReduceByKey(lambda kv: kv[0],
                                      lambda a, b: (a[0], a[1] + b[1]))
    rows = red.Map(lambda kv: {"c": kv[1],
                               "h": signed(stable_host_hash(kv[0]))})
    launches = (tpk.partition_histogram.launches, tps.radix_pass.launches)
    out = rows.ToDevice().Sort(key_fn=lambda t: (t["c"], t["h"])) \
        .AllGatherArrays()
    assert red.node._em_stats["disk_bytes"] > 0
    want = sorted((c, signed(stable_host_hash(w)))
                  for w, c in collections.Counter(words).items())
    assert out["c"].device.type == "cuda"
    assert list(zip(out["c"].cpu().tolist(), out["h"].cpu().tolist())) == want
    assert tpk.partition_histogram.launches > launches[0]
    assert tps.radix_pass.launches > launches[1]


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_spill_and_restore_of_cuda_leaves_is_bit_equal(cuda_device, W):
    """A governor limit below one node: caching the second spills the
    first through pinned staging into the native store, and its next
    pull uploads it again with every bit as it was (NaN payloads, int64
    words with the top bit set, bools, byte rows)."""
    from thrill_tpu_torch.common.config import Config
    from thrill_tpu_torch.mem.hbm import SpilledShards
    rng = np.random.default_rng(11)
    n = 100_003
    f32 = rng.standard_normal(n).astype(np.float32)
    f32.view(np.uint32)[::7] = 0x7fc00000 | rng.integers(0, 1 << 22, 14287,
                                                         dtype=np.uint32)
    data = {"k": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
            "f": f32, "d": rng.standard_normal(n),
            "b": rng.integers(0, 2, n).astype(bool),
            "r": rng.integers(0, 256, (n, 10)).astype(np.uint8)}
    ctx = tt.Context(num_workers=W, device=cuda_device,
                     config=Config(hbm_limit=1 << 20))
    a = ctx.Distribute(data).Keep(2)
    a.Execute()
    b = ctx.Distribute(np.arange(1 << 18, dtype=np.int64)).Keep()
    b.Execute()
    assert isinstance(a.node._shards, SpilledShards)
    assert ctx.hbm._pool.native
    got = a.AllGatherArrays()
    assert ctx.hbm.restore_count == 1 and got["k"].device.type == "cuda"
    for k, want in data.items():
        assert got[k].cpu().numpy().tobytes() == want.tobytes(), k
    ctx.close()


@pytest.mark.gpu
def test_a_real_oom_is_cured_by_rung_2(cuda_device):
    """Two cold 1 GiB results, and a ballast that leaves 2 GiB free: a
    Generate of 2^28 int64 (2 GiB, plus its 1 GiB index) runs out of card
    memory inside its compute, rung 2 spills the cold results and runs it
    again, and everything reads back exact."""
    ctx = tt.Context(num_workers=2, device=cuda_device)
    cold = [ctx.Generate(1 << 27).Keep() for _ in range(2)]
    for c in cold:
        c.Execute()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(cuda_device)[0]
    ballast = torch.empty(free - (2 << 30), dtype=torch.uint8,
                          device=cuda_device)
    try:
        big = ctx.Generate(1 << 28).Keep()
        big.Execute()
        s = ctx.overall_stats()
        assert s["oom_retries"] >= 1 and s["hbm_spills"] == 2
        assert s["pressure_spilled_bytes"] == 2 << 30
    finally:
        del ballast
        torch.cuda.empty_cache()
    assert big.Sum() == (1 << 28) * ((1 << 28) - 1) // 2
    for c in cold:
        assert c.Sum() == (1 << 27) * ((1 << 27) - 1) // 2
    assert ctx.overall_stats()["hbm_restores"] == 2
    ctx.close()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.float16, torch.bfloat16])
@pytest.mark.parametrize("cols", [(), (3,), (8,), (40,)])
@pytest.mark.parametrize("ordered", [True, False])
def test_ordered_segment_sum_matches_the_cpu_bit_for_bit(cuda_device, dtype,
                                                         cols, ordered):
    """Runs of every length (empty, one warp's, many block tiles: the
    hottest holds a third of the rows), read through an order or in
    place, give the CPU's sequential bits, and the same bits twice. The
    halves' sums stay finite: a NaN made on the card (inf - inf) has
    another sign bit than the CPU's (ROADMAP.md, fault C9)."""
    from thrill_tpu_torch.core import ordered_fold as tof
    rng = np.random.default_rng(len(cols) + ordered)
    n, segs = 200_000, 3000
    p = 1.0 / np.arange(1, segs + 1) ** 1.3
    ids = rng.choice(segs, size=n, p=p / p.sum())
    half = dtype in (torch.float16, torch.bfloat16)
    mag = (-3, 1) if half else (-6, 7)
    vals = torch.as_tensor(rng.standard_normal((n,) + cols) * 10.0 **
                           rng.integers(*mag, (n,) + cols)).to(dtype)
    if ordered:
        order, offs = tof.group_rows(torch.as_tensor(ids), segs)
    else:
        order = None
        offs = torch.as_tensor(np.concatenate(
            [[0], np.cumsum(np.bincount(ids, minlength=segs))]))
    want = tof.ordered_segment_sum(vals, order, offs)
    dev = [None if t is None else t.to(cuda_device)
           for t in (vals, order, offs)]
    launches = tof.ordered_segment_sum.launches
    got = [tof.ordered_segment_sum(*dev) for _ in range(2)]
    assert tof.ordered_segment_sum.launches == launches + 2
    for g in got:
        assert g.dtype == dtype and g.shape == want.shape
        assert g.cpu().view(torch.uint8).numpy().tobytes() == \
            want.view(torch.uint8).numpy().tobytes()


def _float_sum_site(site, ctx, data):
    from thrill_tpu_torch.core import segmented as tseg
    FR = tt.FieldReduce
    spec = {"d": "first", "v": "sum", "w": "sum", "x": "sum"}
    if site == "reduce_to_index":
        return ctx.Distribute(data).ReduceToIndex(
            lambda c: c["d"], FR(spec), 5000).AllGatherArrays()
    if site == "reduce_by_key":
        return ctx.Distribute(data).ReduceByKey(
            lambda c: c["d"], FR(spec)).AllGatherArrays()

    def device_fn(tree, seg, nseg):
        return {k: tseg.segment_sum(tree[k], seg, nseg)
                for k in ("v", "w", "x")}
    return ctx.Distribute(data).GroupByKey(
        lambda r: r["d"], device_fn=device_fn).AllGatherArrays()


@pytest.mark.gpu
@pytest.mark.parametrize("site", ["reduce_to_index", "reduce_by_key",
                                  "segment_sum"])
@pytest.mark.parametrize("W", [1, 4])
def test_float_sums_on_the_card_are_the_cpus_bits_run_after_run(
        cuda_device, device_engines, site, W):
    """ReduceToIndex's, ReduceByKey's and GroupByKey's float sums (f64
    scalars, f64 [8], f32 [3]: every sum outside B3) launch the ordered
    fold, and two runs on the card give the CPU's bits."""
    from thrill_tpu_torch.core import ordered_fold as tof
    rng = np.random.default_rng(W)
    n = 1 << 18
    p = 1.0 / np.arange(1, 4001)
    data = {"d": rng.choice(4000, size=n, p=p / p.sum()).astype(np.int64),
            "v": rng.standard_normal(n) * 1e8,
            "w": rng.standard_normal((n, 8)),
            "x": rng.standard_normal((n, 3)).astype(np.float32)}
    want = _float_sum_site(site, tt.Context(num_workers=W, device="cpu"),
                           data)
    for _ in range(2):
        launches = tof.ordered_segment_sum.launches
        got = _float_sum_site(site, tt.Context(num_workers=W,
                                               device=cuda_device), data)
        assert tof.ordered_segment_sum.launches > launches
        for k in ("v", "w", "x"):
            assert got[k].cpu().numpy().tobytes() == \
                want[k].numpy().tobytes(), k


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_a_device_epoch_saves_and_restores_through_the_ring(cuda_device, W,
                                                            tmp_path):
    """A device node sealed on the card leaves it through the governor's
    pinned staging ring and comes back through it on resume: the shard
    files equal the CPU run's byte for byte, and the restored leaves
    every bit of the originals (NaN payloads, top-bit int64, bools, byte
    rows), rows past each count zero."""
    from thrill_tpu_torch.common.config import Config
    rng = np.random.default_rng(12)
    n = 70_001
    f32 = rng.standard_normal(n).astype(np.float32)
    f32.view(np.uint32)[::5] = 0x7fc00001
    data = {"k": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
            "f": f32, "b": rng.integers(0, 2, n).astype(bool),
            "r": rng.integers(0, 256, (n, 10)).astype(np.uint8)}

    def job(ctx):
        got = ctx.Distribute(data).Checkpoint("ring").AllGatherArrays()
        return ({k: v.cpu().numpy() for k, v in got.items()},
                ctx.overall_stats())

    dirs = {dev: tmp_path / dev for dev in ("cpu", "cuda")}
    for dev, d in dirs.items():
        tt.Run(job, W, device=dev, config=Config(ckpt_dir=str(d)))
    files = sorted(p.name for p in (dirs["cpu"] / "epoch_000000").iterdir())
    assert files == sorted(
        p.name for p in (dirs["cuda"] / "epoch_000000").iterdir())
    for name in files:
        assert (dirs["cpu"] / "epoch_000000" / name).read_bytes() == \
            (dirs["cuda"] / "epoch_000000" / name).read_bytes(), name
    # the card's epoch restored on the card and on the CPU
    for dev in (cuda_device, "cpu"):
        got, stats = tt.Run(job, W, device=dev,
                            config=Config(ckpt_dir=str(dirs["cuda"])),
                            resume=True)
        assert stats["resume_skipped_ops"] == 1
        assert stats["recovery_time_s"] > 0
        for k, want in data.items():
            assert got[k].tobytes() == want.tobytes(), k


@pytest.mark.gpu
def test_a_restored_device_epoch_pads_with_zeros(cuda_device, tmp_path):
    from thrill_tpu_torch.api.checkpoint import CheckpointManager
    from thrill_tpu_torch.common.config import Config
    ctx = tt.Context(num_workers=4, device=cuda_device,
                     config=Config(ckpt_dir=str(tmp_path)))
    d = ctx.Distribute(np.arange(1, 10, dtype=np.int64)).Checkpoint()
    d.Execute()
    ctx.close()
    ctx = tt.Context(num_workers=4, device=cuda_device,
                     config=Config(ckpt_dir=str(tmp_path)), resume=True)
    assert isinstance(ctx.checkpoint, CheckpointManager)
    shards = ctx.Distribute(np.arange(1, 10, dtype=np.int64)).Checkpoint() \
        .node.materialize()
    assert shards.tree.device.type == "cuda"
    host = shards.tree.cpu().numpy()
    for w, c in enumerate(shards.counts):
        assert (host[w, c:] == 0).all()
    assert sorted(host[host > 0].tolist()) == list(range(1, 10))
    ctx.close()


@pytest.mark.gpu
def test_a_loop_resumes_on_the_card(cuda_device, tmp_path, monkeypatch):
    """Iterate(checkpoint_every=2) on the card: the resumed run restores
    the newest loop epoch, runs the iterations after it alone and gives
    the uninterrupted run's bits, which are the CPU's. The plain loop
    (``THRILL_TPU_LOOP_REPLAY=0``, as the reference's test): its body
    runs count the iterations; a replayed iteration runs no body."""
    from thrill_tpu_torch.common.config import Config
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", "0")
    runs = []

    def job(ctx):
        def body(d):
            runs.append(1)
            return d.Map(lambda x: x * 0.5 + 1.0)

        d = ctx.Distribute(np.linspace(0.0, 1.0, 1001))
        out = tt.Iterate(ctx, body, d, 6, name="gpu_loop",
                         checkpoint_every=2)
        return out.AllGatherArrays().cpu().numpy()

    cfg = Config(ckpt_dir=str(tmp_path))
    want = tt.Run(job, 4, device=cuda_device, config=cfg)
    assert len(runs) == 6
    runs.clear()
    got = tt.Run(job, 4, device=cuda_device, config=cfg, resume=True)
    assert len(runs) == 2
    assert got.tobytes() == want.tobytes()
    cpu = tt.Run(job, 4, device="cpu")
    assert got.tobytes() == cpu.tobytes()


@pytest.mark.gpu
def test_a_loop_resumes_with_replay_on_the_card(cuda_device, tmp_path,
                                                monkeypatch):
    """The same loop with replay on (the reference's
    ``test_loop_checkpoint_resume_with_replay``): each run captures once
    and replays its other iterations one by one (an epoch falls inside
    the loop, so no whole-loop graph); the resumed run restores the
    newest epoch, captures again, makes the two iterations after it and
    gives the uninterrupted run's bits, which are the plain loop's."""
    from thrill_tpu_torch.common.config import Config
    stats = []

    def job(ctx):
        d = ctx.Distribute(np.linspace(0.0, 1.0, 1001))
        out = tt.Iterate(ctx, lambda d: d.Map(lambda x: x * 0.5 + 1.0), d,
                         6, name="gpu_loop", checkpoint_every=2)
        got = out.AllGatherArrays().cpu().numpy()
        st = ctx.overall_stats()
        stats.append((st["loop_plan_builds"], st["loop_replays"],
                      st["loop_fori_iters"], st["loop_replay_fallbacks"],
                      ctx.mesh_exec.loop_reports[-1]["iters"]))
        return got

    cfg = Config(ckpt_dir=str(tmp_path))
    want = tt.Run(job, 4, device=cuda_device, config=cfg)
    got = tt.Run(job, 4, device=cuda_device, config=cfg, resume=True)
    assert stats == [(1, 5, 0, 0, 6), (1, 1, 0, 0, 2)]
    assert got.tobytes() == want.tobytes()
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", "0")
    plain = tt.Run(job, 4, device=cuda_device,
                   config=Config(ckpt_dir=str(tmp_path / "plain")))
    assert stats[-1][:4] == (0, 0, 0, 0)
    assert plain.tobytes() == want.tobytes()


@pytest.mark.gpu
def test_stitched_chain_syncs_only_for_the_radix_engine_and_the_action(
        cuda_device, monkeypatch):
    """Phase F1's chain (chip_smoke.py) at a small size, its source
    computed first: under ``torch.cuda.set_sync_debug_mode("error")``
    the stitched Map, Filter, Sort, ZipWithIndex and PrefixSum and the
    action that reads them make no host sync but the radix engine's one
    live-digit read and the action's counted fetch of the counts."""
    import chip_smoke as cs
    from thrill_tpu_torch.parallel.mesh import MeshExec
    n = 1 << 14
    ctx = tt.Context(num_workers=1, device="cuda")
    src = ctx.Generate(n, cs.f1_gen).Keep()
    src.Execute()
    src.node._shards.counts_device()              # uploaded before
    allowed = {"live_digits": 0, "fetch": 0}
    real_live, real_raw = tps.live_digits, MeshExec._fetch_raw

    def allow(name, fn):
        def call(*a, **k):
            allowed[name] += 1
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    monkeypatch.setattr(tps, "live_digits", allow("live_digits", real_live))
    monkeypatch.setattr(MeshExec, "_fetch_raw", allow("fetch", real_raw))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = (src.Map(cs.f1_map).Filter(cs.f1_keep).Sort(key_fn=cs.f1_key)
               .ZipWithIndex(cs.f1_index).PrefixSum().AllGatherArrays())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    mex = ctx.mesh_exec
    assert mex.stats_fused_dispatches == 1 and mex.stats_fused_ops == 4
    assert allowed == {"live_digits": 1, "fetch": 1}
    assert mex.stats_fetches == 1
    i = np.arange(n, dtype=np.int64)
    k = (i * 2654435761) % (1 << 32) + 7
    k = np.sort(k[k % 2 == 0])
    assert np.array_equal(out["k"].cpu().numpy(), np.cumsum(k))
    assert np.array_equal(out["i"].cpu().numpy(),
                          np.cumsum(np.arange(len(k))))
    ctx.close()


def _graph_of(fn):
    """``fn()`` captured in a CUDA graph after a warm-up on a side
    stream, replayed once: (the graph's outputs, the graph)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    return out, g


def _tensors_of(x):
    return [t for t in (x if isinstance(x, tuple) else (x,))
            if t is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["partition_histogram", "radix_upsweep",
                                    "radix_pass", "ordered_segment_sum",
                                    "segment_sum", "presence_fill"])
def test_kernels_inside_a_cuda_graph_are_bit_equal(cuda_device, kernel):
    """Each wrapper launches on the current stream, so a CUDA graph
    captures it; its replay is bit-equal to an eager launch and to the
    plain version (B3's f32 sum: within its usual tolerance of the plain
    one, its atomics' order being free)."""
    from thrill_tpu_torch.core import ordered_fold as tof
    rng = np.random.default_rng(11)
    n = 1 << 18
    ids = torch.as_tensor(rng.integers(0, 3000, size=(2, n)),
                          device=cuda_device)
    vals = torch.as_tensor(rng.normal(size=n), device=cuda_device)
    keys = ids.reshape(-1)
    order = torch.argsort(keys, stable=True)
    offs = torch.zeros(3001, dtype=torch.int64, device=cuda_device)
    offs[1:] = torch.cumsum(torch.bincount(keys, minlength=3000), 0)
    hist = tps.radix_upsweep(ids, 2)
    f32 = vals.repeat(2).float().reshape(2, -1)
    valid = ids % 3 > 0
    fns = {
        "partition_histogram": (lambda: tpk.partition_histogram(ids, 2048),
                                lambda: tpk.partition_histogram_plain(
                                    ids.cpu(), 2048)),
        "radix_upsweep": (lambda: tps.radix_upsweep(ids, 2),
                          lambda: tps.radix_upsweep_plain(ids.cpu(), 2)),
        "radix_pass": (lambda: tps.radix_pass(ids, None, 8, hist[:, 1]),
                       lambda: tps.radix_pass_plain(ids.cpu(), None, 8)),
        "ordered_segment_sum": (
            lambda: tof.ordered_segment_sum(vals.repeat(2), order, offs),
            lambda: tof.ordered_segment_sum_plain(
                vals.repeat(2).cpu(), order.cpu(), offs.cpu())),
        "segment_sum": (lambda: tpk.segment_sum(ids.int(), f32, 3000),
                        lambda: tpk.segment_sum_plain(ids.int().cpu(),
                                                      f32.cpu(), 3000)),
        "presence_fill": (lambda: tpk.presence_fill(ids, valid, 4096),
                          lambda: tpk.presence_fill_plain(
                              ids.cpu(), valid.cpu(), 4096)),
    }
    fn, plain_fn = fns[kernel]
    eager = fn()
    out, g = _graph_of(fn)
    plain = plain_fn()
    for a, b, c in zip(_tensors_of(out), _tensors_of(eager),
                       _tensors_of(plain)):
        if kernel == "segment_sum":
            assert torch.allclose(a.cpu(), c, rtol=1e-4, atol=1e-3)
            continue
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    g.replay()                   # a second replay: the same bits
    torch.cuda.synchronize()
    if kernel != "segment_sum":
        assert all(torch.equal(a, b) for a, b in zip(_tensors_of(out),
                                                     _tensors_of(eager)))


@pytest.mark.gpu
def test_sync_free_radix_argsort_reads_nothing(cuda_device):
    """With ``sync_free`` the radix engine sorts by every digit of the
    given bits and reads nothing back (no live-digit read, no sync under
    ``set_sync_debug_mode("error")``): the permutation of the plain
    engine, one pass a digit."""
    rng = np.random.default_rng(5)
    keys = torch.as_tensor(rng.integers(0, 1 << 20, size=(4, 1 << 16)),
                           device=cuda_device)
    reads, passes = tps.live_reads, tps.radix_pass.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        perm = tps.radix_argsort_device([keys], [20], sync_free=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tps.live_reads == reads
    assert tps.radix_pass.launches - passes == 3
    assert torch.equal(perm, tds.plain_argsort_words([keys]))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_page_rank_loop_graph_is_bit_equal(cuda_device, W, monkeypatch):
    """PageRank's Iterate on the card at a small size: iterations 2..5
    run as one CUDA graph (``loop_fori_iters`` 4, the graph's replay
    logged), bit-equal to per-iteration replay (release on) and to the
    plain loop."""
    from thrill_tpu_torch.api import loop as tloop
    from thrill_tpu_torch.examples import page_rank as tpr
    edges = tpr.zipf_graph(4096, 1 << 15, seed=W)
    graphs = []
    real = tloop._graph_loop

    def graph_loop(plan, carry, k):
        graphs.append(k)
        return real(plan, carry, k)

    monkeypatch.setattr(tloop, "_graph_loop", graph_loop)
    got = {}
    for mode, env in (("graph", {}),
                      ("replay", {"THRILL_TPU_LOOP_FORI": "0",
                                  "THRILL_TPU_LOOP_DONATE": "1"}),
                      ("plain", {"THRILL_TPU_LOOP_REPLAY": "0"})):
        for k in ("THRILL_TPU_LOOP_FORI", "THRILL_TPU_LOOP_DONATE",
                  "THRILL_TPU_LOOP_REPLAY"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        ctx = tt.Context(num_workers=W, device=cuda_device)
        got[mode] = tpr.page_rank(ctx, edges, 4096, 5)
        st = ctx.overall_stats()
        want = {"graph": (1, 0, 4), "replay": (1, 4, 0),
                "plain": (0, 0, 0)}[mode]
        assert (st["loop_plan_builds"], st["loop_replays"],
                st["loop_fori_iters"]) == want
        ctx.close()
    assert graphs == [4]
    assert got["graph"].tobytes() == got["replay"].tobytes() \
        == got["plain"].tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1 << 12, 1 << 24])
def test_auto_sort_engine_is_the_policy_s_and_exact(cuda_device, rows):
    """On the card ``argsort_words`` takes the radix engine at every
    size, where the measured cost model would take the plain engine for
    small sorts too, and gives the plain engine's permutation."""
    rng = np.random.default_rng(21)
    words = [torch.as_tensor(rng.integers(-2**63, 2**63, (4, rows // 4),
                                          dtype=np.int64), device=cuda_device)
             for _ in range(2)]
    engine, costs, _ = tds.sort_engine_policy(rows, 128, True, "cuda", 2)
    b = tps.radix_upsweep.launches
    assert torch.equal(tds.argsort_words(words),
                       tds.plain_argsort_words(words))
    assert tps.radix_upsweep.launches > b
    assert engine == "radix"
    assert (costs["plain"] < costs["radix"]) == (rows < (1 << 20))


@pytest.mark.gpu
def test_skewed_exchange_stays_dense_on_a_calibrated_mesh(cuda_device):
    """On the card the strategy is dense without a cost model: a mesh
    past the dispatch-latency spine's sample count keeps the dense plan
    for a 100:1 hot-pair send matrix (the 1-factor rounds lost every case
    of ``kernel_times.py --xchg-crossover``)."""
    from thrill_tpu_torch.data import exchange as ex
    ctx = tt.Context(num_workers=4, device=cuda_device)
    mex = ctx.mesh_exec
    mex._disp_lat_n = ex._BYTES_EQ_MIN_SAMPLES + 1
    mex._disp_lat_min = 1e-6
    S = np.zeros((4, 4), dtype=np.int64)
    S[:, 0] = 40_000
    S[3, 0] = 4_000_000                   # 100:1 on one pair
    assert ex.dense_all_to_all_applies(mex, S, 16)
    assert ctx.planner.exchange_strategy(S, 16, "dense")[0] == "dense"
    ctx.close()


@pytest.mark.gpu
def test_planned_exchange_on_the_card_is_bit_equal(cuda_device,
                                                   monkeypatch):
    """The planned exchange on the card: chunks, narrowing and the
    cached plan against the bulk synced full-width run, at W = 4."""
    from thrill_tpu_torch.data import exchange as ex
    rng = np.random.default_rng(22)
    n = 1 << 16
    cols = {"k": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            "v": rng.integers(-100, 100, n).astype(np.int64)}

    def run(env, runs):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        ctx = tt.Context(num_workers=4, device=cuda_device)
        outs = []
        for _ in range(runs):
            sh = ctx.Distribute(cols).node.materialize()
            out = ex.exchange(sh, lambda t, m, w: torch.remainder(t["k"], 4),
                              ("gpu_plan",))
            outs.append([{k: np.asarray(v) for k, v in t.items()}
                         for t in out.to_worker_arrays()])
        st = ctx.overall_stats()
        ctx.close()
        for k in env:
            monkeypatch.delenv(k)
        return outs, st

    want, _ = run({"THRILL_TPU_XCHG_CAP_CACHE": "0", "THRILL_TPU_OVERLAP": "0",
                   "THRILL_TPU_XCHG_NARROW": "0"}, 1)
    for K in ("1", "2", "4"):
        got, st = run({"THRILL_TPU_XCHG_CHUNKS": K}, 2)
        assert st["cap_cache_hits"] == 1
        assert st["bytes_wire_device"] < st["bytes_wire_device_raw"]
        for g in got:
            for a, b in zip(g, want[0]):
                assert all(np.array_equal(a[k], b[k]) for k in a)


# -- the streamed and ragged exchanges, the draws, the filter, the Sort -----

def _worker_rows(shards):
    return [{k: np.asarray(v) for k, v in t.items()}
            for t in shards.to_worker_arrays()]


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            "small": rng.integers(0, 200, n).astype(np.int64),
            "f": rng.normal(size=n)}


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 2, 4])
def test_stream_rounds_on_the_card_are_the_cpu_s(cuda_device, W):
    """Every round of the streamed exchange on the card: the rows and
    counts the CPU mesh yields."""
    from thrill_tpu_torch.data import exchange as ex
    cols = _cols(1 << 15, W)
    got = {}
    for dev in (cuda_device, "cpu"):
        ctx = tt.Context(num_workers=W, device=dev)
        sh = ctx.Distribute(cols).node.materialize()
        got[str(dev)] = [(_worker_rows(b), b.counts.tolist()) for b in
                         ex.exchange_stream(sh, lambda t, m, w: torch.remainder(
                             t["small"], W), ("gpu_stream",))]
        ctx.close()
    a, b = got[str(cuda_device)], got["cpu"]
    assert len(a) == len(b) == W
    for (ra, ca), (rb, cb) in zip(a, b):
        assert ca == cb
        for wa, wb in zip(ra, rb):
            assert all(np.array_equal(wa[k], wb[k]) for k in wa)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 4])
def test_streamed_reduce_on_the_card_is_the_cpu_s(cuda_device, W,
                                                  device_engines,
                                                  monkeypatch):
    monkeypatch.setenv("THRILL_TPU_REDUCE_STREAM", "1")
    rng = np.random.default_rng(W)
    w = (rng.zipf(1.3, 1 << 16) % 5000).astype(np.int64)
    got = {}
    for dev in (cuda_device, "cpu"):
        ctx = tt.Context(num_workers=W, device=dev)
        out = ctx.Distribute({"w": w, "c": np.ones_like(w)}).ReduceByKey(
            lambda t: t["w"], tt.FieldReduce({"w": "first", "c": "sum"}))
        got[str(dev)] = _worker_rows(out.node.materialize())
        ctx.close()
    for wa, wb in zip(got[str(cuda_device)], got["cpu"]):
        assert all(np.array_equal(wa[k], wb[k]) for k in wa)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 4])
def test_ragged_scatter_on_the_card_is_the_dense_exchange(cuda_device, W,
                                                          monkeypatch):
    """The ragged program's one scatter into the receivers' rows: the
    rows of the dense exchange, with and without narrowing."""
    from thrill_tpu_torch.data import exchange as ex
    cols = _cols(1 << 17, W + 3)

    def run(mode):
        monkeypatch.setenv("THRILL_TPU_EXCHANGE", mode)
        ctx = tt.Context(num_workers=W, device=cuda_device)
        outs = []
        for _ in range(2):
            sh = ctx.Distribute(cols).node.materialize()
            outs.append(_worker_rows(ex.exchange(
                sh, lambda t, m, w: torch.remainder(t["small"], W),
                ("gpu_ragged",))))
        st = ctx.overall_stats()
        ctx.close()
        return outs, st

    dense, _ = run("dense")
    ragged, st = run("ragged")
    assert st["bytes_wire_device"] < st["bytes_wire_device_raw"]
    for g, want in zip(ragged, dense):
        for wa, wb in zip(g, want):
            assert all(np.array_equal(wa[k], wb[k]) for k in wa)


@pytest.mark.gpu
def test_threefry_on_the_card_is_the_cpu_s(cuda_device):
    from thrill_tpu_torch.api.ops import sample as tsample
    from thrill_tpu_torch.common import threefry
    for seed in (0, 1, (1 << 31) - 1, (1 << 32) + 5, -3):
        keys = threefry.fold_in(threefry.prng_key(seed),
                                torch.arange(8, device=cuda_device))
        assert keys.cpu().tolist() == threefry.fold_in(
            threefry.prng_key(seed), torch.arange(8)).tolist()
        for bits in (32, 64):
            assert torch.equal(threefry.random_bits(keys, bits, (4097,)).cpu(),
                               threefry.random_bits(keys.cpu(), bits, (4097,)))
        for dt in (torch.float64, torch.float32):
            assert torch.equal(threefry.uniform(keys, (4097,), dt).cpu(),
                               threefry.uniform(keys.cpu(), (4097,), dt))
    u = tsample.worker_uniforms(tt.MeshExec(num_workers=4,
                                            device=cuda_device), 9, 1 << 16)
    assert torch.equal(u.cpu(), tsample.worker_uniforms(
        tt.MeshExec(num_workers=4, device="cpu"), 9, 1 << 16))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_samples_on_the_card_keep_the_cpu_items(cuda_device, W):
    vals = np.random.default_rng(4).integers(0, 1 << 40, 1 << 16)
    got = {}
    for dev in (cuda_device, "cpu"):
        ctx = tt.Context(num_workers=W, device=dev)
        src = ctx.Distribute(vals).Cache().Keep(2)
        got[str(dev)] = (
            [a.tolist() for a in src.Sample(64, seed=1 << 16).node
             .materialize().to_worker_arrays()],
            [a.tolist() for a in src.BernoulliSample(0.01, seed=5).node
             .materialize().to_worker_arrays()])
        ctx.close()
    assert got[str(cuda_device)] == got["cpu"]


@pytest.mark.gpu
def test_location_filter_counts_stay_on_the_card(cuda_device):
    """The join's location filter is one program whose counts stay on the
    device: no transfer until the exchange after it reads its send
    matrix."""
    from thrill_tpu_torch.api.ops import join as tjoin
    ctx = tt.Context(num_workers=4, device=cuda_device)
    mex = ctx.mesh_exec
    rng = np.random.default_rng(3)
    left = ctx.Distribute({"k": rng.integers(0, 5000, 1 << 14)}
                          ).node.materialize()
    right = ctx.Distribute({"k": rng.integers(2500, 9000, 1 << 14)}
                           ).node.materialize()
    left.counts, right.counts
    x0, d0 = mex.stats_transfers, mex.stats_dispatches
    fl, fr = tjoin._location_filter(left, right, lambda t: t["k"],
                                    lambda t: t["k"], ("gpu_ld",))
    assert mex.stats_transfers == x0 and mex.stats_dispatches == d0 + 1
    assert fl._counts_host is None and fr._counts_host is None
    lk = np.concatenate([a["k"] for a in fl.to_worker_arrays()])
    rk = np.concatenate([a["k"] for a in fr.to_worker_arrays()])
    # every key with a partner survives (false positives may stay)
    common = set(left.to_global_numpy()["k"].tolist()) & set(
        right.to_global_numpy()["k"].tolist())
    assert common <= set(lk.tolist()) and common <= set(rk.tolist())
    assert len(lk) <= left.total and len(rk) <= right.total
    ctx.close()


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 4])
def test_sample_sort_on_the_card_is_three_programs(cuda_device, W):
    rng = np.random.default_rng(W)
    recs = {"key": rng.integers(0, 256, (1 << 16, 10)).astype(np.uint8),
            "value": rng.integers(0, 256, (1 << 16, 6)).astype(np.uint8)}
    ctx = tt.Context(num_workers=W, device=cuda_device)
    src = ctx.Distribute(recs).Cache()
    src.Keep().Size()
    d0 = ctx.mesh_exec.stats_dispatches
    out = src.Sort(key_fn=lambda r: r["key"]).AllGatherArrays()
    assert ctx.mesh_exec.stats_dispatches - d0 == 3
    ctx.close()
    order = np.lexsort(recs["key"].T[::-1])
    assert np.array_equal(out["key"].cpu().numpy(), recs["key"][order])


# -- the tracer on the card (common/trace.py) ---------------------------

def _traced(run, W, env, monkeypatch):
    """``run(ctx)`` on a fresh W-worker card Context under ``env``: the
    result on the host, the choke point's counters, the kernels'
    launches and the tracer's lanes and records."""
    from thrill_tpu_torch.core import ordered_fold as tof
    kernels = (tpk.partition_histogram, tps.radix_upsweep, tps.radix_pass,
               tpk.segment_sum, tpk.presence_fill, tof.ordered_segment_sum)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ctx = tt.Context(num_workers=W, device="cuda")
    mex = ctx.mesh_exec
    l0 = [k.launches for k in kernels]
    c0 = (mex.stats_dispatches, mex.stats_fetches, mex.stats_transfers)
    out = run(ctx)
    torch.cuda.synchronize()
    got = {"res": out,
           "counts": (mex.stats_dispatches - c0[0],
                      mex.stats_fetches - c0[1],
                      mex.stats_transfers - c0[2]),
           "launches": [k.launches - b for k, b in zip(kernels, l0)],
           "lanes": dict(ctx.tracer.lane_counts),
           "ring": list(ctx.tracer.ring or ()),
           "fori": ctx.overall_stats()["loop_fori_iters"]}
    ctx.close()
    for k in env:
        monkeypatch.delenv(k)
    return got


def _pagerank(ctx):
    from thrill_tpu_torch.examples import page_rank as tpr
    return np.asarray(tpr.page_rank(ctx, tpr.zipf_graph(1 << 12, 1 << 14,
                                                        seed=4),
                                    1 << 12, iterations=4))


def _terasort(ctx):
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1 << 62, size=1 << 16, dtype=np.int64)
    return ctx.Distribute(keys).Sort().AllGatherArrays().cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("job,replay", [(_pagerank, "0"), (_pagerank, "1"),
                                        (_terasort, "1")])
def test_tracing_changes_no_count_on_the_card(cuda_device, monkeypatch,
                                              job, replay):
    """Traced and untraced W = 4 runs: bit-equal results, equal
    dispatches, counted fetches, transfers and launches; the dispatch
    lane counts the dispatches."""
    env = {"THRILL_TPU_LOOP_REPLAY": replay,
           "THRILL_TPU_TRACE_RING": "65536"}
    on = _traced(job, 4, env, monkeypatch)
    off = _traced(job, 4, {**env, "THRILL_TPU_TRACE": "0"}, monkeypatch)
    assert np.array_equal(on["res"], off["res"])
    assert on["counts"] == off["counts"]
    assert on["launches"] == off["launches"]
    assert on["lanes"]["dispatch"] == on["counts"][0]
    assert off["lanes"] == {}


@pytest.mark.gpu
def test_the_graph_window_is_one_replay_span(cuda_device, monkeypatch):
    """The whole-loop CUDA graph is still taken with tracing on, and its
    window is one ``replay`` span holding one ``loop_fori`` dispatch."""
    env = {"THRILL_TPU_TRACE_RING": "65536"}
    on = _traced(_pagerank, 4, env, monkeypatch)
    off = _traced(_pagerank, 4, {"THRILL_TPU_TRACE": "0"}, monkeypatch)
    assert on["fori"] == off["fori"] == 3
    loop = [r for r in on["ring"] if r["cat"] == "loop"]
    assert [r["name"] for r in loop] == ["capture", "replay"]
    window = [r["name"] for r in on["ring"] if r["cat"] == "dispatch"
              and r.get("parent") == loop[1]["span"]]
    assert window == ["loop_fori"]
    assert loop[1]["fori_iters"] == 3


@pytest.mark.gpu
def test_device_memory_stats_read_the_allocator(cuda_device):
    from thrill_tpu_torch.common import profile
    x = torch.empty(1 << 20, dtype=torch.uint8, device=cuda_device)
    got = profile._device_memory_stats(cuda_device)
    assert got["bytes_in_use"] == torch.cuda.memory_allocated()
    assert got["bytes_in_use"] >= x.numel()
    assert got["bytes_limit"] == \
        torch.cuda.get_device_properties(0).total_memory
    assert got["peak_bytes_in_use"] >= got["bytes_in_use"]
    assert profile._device_memory_stats("cpu") == {}
    del x


# -- a mesh of two processes on the one card (RunDistributed) ---------------

_DIST_CHILD = r'''
import hashlib, json, sys
import numpy as np, torch
import thrill_tpu_torch as tt
from thrill_tpu_torch.core import pallas_kernels as pk, pallas_sort as ps


def job(ctx):
    rng = np.random.default_rng(7)
    recs = {"key": rng.integers(0, 256, (1 << 16, 10), dtype=np.uint8),
            "val": np.arange(1 << 16, dtype=np.int64)}
    pk.partition_histogram.launches = ps.radix_pass.launches = 0
    out = ctx.Distribute(recs).Sort(key_fn=lambda r: r["key"]) \
        .AllGatherArrays()
    h = hashlib.sha256()
    for k in sorted(out):
        h.update(out[k].cpu().numpy().tobytes())
    pairs = sorted((int(k), int(v)) for k, v in ctx.Distribute(
        np.arange(1 << 15, dtype=np.int64)).Map(lambda x: (x % 97, x))
        .ReducePair(lambda a, b: a + b).AllGather())
    return {"sort": h.hexdigest(), "pairs": pairs,
            "launches": [pk.partition_histogram.launches,
                         ps.radix_pass.launches],
            "cross": ctx.mesh_exec.stats_bytes_cross,
            "device": str(ctx.mesh_exec.device)}


if sys.argv[1] == "one":
    print("RESULT " + json.dumps(tt.Run(job, 4)), flush=True)
else:
    print("RESULT " + json.dumps(tt.RunDistributed(
        job, coordinator_address=sys.argv[2], num_processes=2,
        process_id=int(sys.argv[3]), workers_per_process=2)), flush=True)
'''


def _run_children(tmp_path, argvs, env_of):
    import json
    import os
    import subprocess
    import sys
    child = tmp_path / "dist_child.py"
    child.write_text(_DIST_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(child)] + a, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=repo, **env_of(i)))
        for i, a in enumerate(argvs)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=300)
            assert p.returncode == 0, e[-3000:]
            out.append(json.loads([l for l in o.splitlines()
                                   if l.startswith("RESULT ")][-1][7:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.gpu
def test_two_processes_on_the_card_equal_one(cuda_device, tmp_path):
    """A Sort and a ReducePair on a mesh of two processes sharing the
    card (gloo, 2 workers each) are bit-equal to the one-process W = 4
    run; each process launches the histogram and the pass kernels and
    sends bytes to the other."""
    import socket
    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    hosts = " ".join(f"127.0.0.1:{p}" for p in ports[1:])
    one = _run_children(tmp_path, [["one"]], lambda i: {})[0]
    two = _run_children(
        tmp_path, [["two", f"127.0.0.1:{ports[0]}", str(r)]
                   for r in range(2)],
        lambda i: {"THRILL_TPU_HOSTLIST": hosts, "THRILL_TPU_RANK": str(i),
                   "THRILL_TPU_SECRET": "gpu-test"})
    for r in two:
        assert r["sort"] == one["sort"] and r["pairs"] == one["pairs"]
        assert r["device"].startswith("cuda")
        assert min(r["launches"]) > 0 and r["cross"] > 0
    assert one["cross"] == 0


_BUILD_CHILD = r'''
import json, sys, time
from thrill_tpu_torch.common import native_build
native_build.BUILD_DIR = sys.argv[2]
while time.time() < float(sys.argv[1]):
    time.sleep(0.005)
native_build.build_all()
print("RESULT " + json.dumps(sorted(native_build.build_logs)), flush=True)
'''


@pytest.mark.gpu
def test_two_processes_build_the_kernels_once(cuda_device, tmp_path):
    """Two processes that build every kernel at once into one build
    directory compile each source once between them (the file lock) and
    both load the libraries."""
    import json
    import os
    import subprocess
    import sys
    import time
    child = tmp_path / "build_child.py"
    child.write_text(_BUILD_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    start = str(time.time() + 3.0)
    procs = [subprocess.Popen([sys.executable, str(child), start,
                               str(tmp_path / "build")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    built = []
    for p in procs:
        o, e = p.communicate(timeout=600)
        assert p.returncode == 0, e[-3000:]
        built += json.loads([l for l in o.splitlines()
                             if l.startswith("RESULT ")][-1][7:])
    from thrill_tpu_torch.common import native_build
    assert sorted(built) == native_build.sources()
    libs = [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]
    assert len(libs) == len(native_build.sources())


# -- the op sweep across processes on the one card --------------------------

_OPS_CHILD = r'''
import hashlib, json, sys
import numpy as np, torch
import thrill_tpu_torch as tt
from thrill_tpu_torch.core import ordered_fold as of, pallas_kernels as pk
from thrill_tpu_torch.examples import page_rank as tpr


def job(ctx):
    edges = tpr.zipf_graph(1 << 12, 1 << 16, seed=3)
    of.ordered_segment_sum.launches = 0
    ranks = tpr.page_rank(ctx, edges, 1 << 12, 5)
    fold = of.ordered_segment_sum.launches
    loop = dict(ctx.mesh_exec.loop_reports[-1])
    rng = np.random.default_rng(4)
    left = {"k": rng.integers(0, 3000, 1 << 14), "a": np.arange(1 << 14)}
    right = {"k": rng.integers(1500, 6000, 1 << 13), "b": np.arange(1 << 13)}
    pk.presence_fill.launches = 0
    pairs = tt.InnerJoin(ctx.Distribute(left), ctx.Distribute(right),
                         lambda t: t["k"], lambda t: t["k"],
                         lambda a, b: {"k": a["k"], "a": a["a"],
                                       "b": b["b"]},
                         location_detection=True).AllGatherArrays()
    order = np.lexsort([pairs[c].cpu().numpy() for c in ("b", "a", "k")])
    h = hashlib.sha256()
    for c in ("k", "a", "b"):
        h.update(pairs[c].cpu().numpy()[order].tobytes())
    return {"ranks": hashlib.sha256(ranks.tobytes()).hexdigest(),
            "fold": fold, "loop": loop, "join": h.hexdigest(),
            "pairs": int(len(order)), "presence": pk.presence_fill.launches}


if sys.argv[1] == "one":
    print("RESULT " + json.dumps(tt.Run(job, 4)), flush=True)
else:
    print("RESULT " + json.dumps(tt.RunDistributed(
        job, coordinator_address=sys.argv[2], num_processes=2,
        process_id=int(sys.argv[3]), workers_per_process=2)), flush=True)
'''


@pytest.fixture(scope="module")
def op_sweep_runs(tmp_path_factory):
    """PageRank (f64, 5 iterations) and a device InnerJoin with the
    location filter, at W = 4 on one process and across two processes
    sharing the card (gloo, 2 workers each)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tmp = tmp_path_factory.mktemp("ops")
    child = tmp / "ops_child.py"
    child.write_text(_OPS_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    hosts = " ".join(f"127.0.0.1:{p}" for p in ports[1:])

    def run(argvs, env_of):
        procs = [subprocess.Popen(
            [sys.executable, str(child)] + a, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=repo, **env_of(i)))
            for i, a in enumerate(argvs)]
        out = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=300)
                assert p.returncode == 0, e[-3000:]
                out.append(json.loads([l for l in o.splitlines()
                                       if l.startswith("RESULT ")][-1][7:]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return out

    one = run([["one"]], lambda i: {})[0]
    two = run([["two", f"127.0.0.1:{ports[0]}", str(r)] for r in range(2)],
              lambda i: {"THRILL_TPU_HOSTLIST": hosts,
                         "THRILL_TPU_RANK": str(i),
                         "THRILL_TPU_SECRET": "gpu-test"})
    return one, two


@pytest.mark.gpu
def test_page_rank_across_processes_on_the_card_is_bit_equal(op_sweep_runs):
    """PageRank's f64 ranks across two processes are bit-equal to one
    process's: each process folds its pages' sums with the ordered fold,
    in the one-process order."""
    one, two = op_sweep_runs
    assert one["fold"] > 0
    for r in two:
        assert r["ranks"] == one["ranks"]
        assert r["fold"] > 0


@pytest.mark.gpu
def test_device_join_across_processes_on_the_card(op_sweep_runs):
    """A device InnerJoin with the location filter across two processes
    gives the one-process pairs, and each process fills its presence
    registers with B4."""
    one, two = op_sweep_runs
    assert one["presence"] >= 2 and one["pairs"] > 0
    for r in two:
        assert r["join"] == one["join"] and r["pairs"] == one["pairs"]
        assert r["presence"] >= 2


@pytest.mark.gpu
def test_the_loop_graph_is_off_across_processes(op_sweep_runs):
    """One process replays PageRank's tape as one CUDA graph; across
    processes the tape replays per iteration, and the loop's report
    says why the graph is off."""
    one, two = op_sweep_runs
    assert one["loop"]["fori_iters"] == 4 and "graph_off" not in one["loop"]
    for r in two:
        loop = r["loop"]
        assert loop["captures"] == 1 and loop["replays"] == 4
        assert loop["fori_iters"] == 0
        assert "CUDA graph" in loop["graph_off"]


# -- the exchange modes across processes on the one card ---------------------

_MODES_CHILD = r'''
import hashlib, json, sys
import numpy as np, torch
import thrill_tpu_torch as tt
from thrill_tpu_torch.data import exchange as ex


def job(ctx):
    mex = ctx.mesh_exec
    W, P, me = mex.num_workers, mex.num_processes, mex.process_index
    out = {}
    if mex.multiprocess:
        # the uneven all-to-all: process p sends (p + 1) * (q + 2) rows
        # to process q, each row holding 100 p + q
        send = [(me + 1) * (q + 2) for q in range(P)]
        recv = [(p + 1) * (me + 2) for p in range(P)]
        for dt in (torch.int64, torch.float64, torch.int16, torch.uint8):
            x = torch.cat([torch.full((send[q], 3), 100 * me + q,
                                      device="cuda").to(dt)
                           for q in range(P)])
            b0 = mex.stats_bytes_cross
            y = mex.exchange_rows(x, send, recv)
            want = torch.cat([torch.full((recv[p], 3), 100 * p + me,
                                         device="cuda").to(dt)
                              for p in range(P)])
            out[str(dt)] = [y.device.type, y.dtype == dt,
                            bool(torch.equal(y, want)),
                            mex.stats_bytes_cross - b0]
    rng = np.random.default_rng(5)
    recs = {"key": rng.integers(0, 256, (1 << 16, 10), dtype=np.uint8),
            "val": np.arange(1 << 16, dtype=np.int64)}
    for mode in ("dense", "onefactor", "ragged"):
        mex.exchange_mode = mode
        o = ctx.Distribute(recs).Sort(key_fn=lambda r: r["key"]) \
            .AllGatherArrays()
        h = hashlib.sha256()
        for k in sorted(o):
            h.update(o[k].cpu().numpy().tobytes())
        out["sort_" + mode] = h.hexdigest()
    mex.exchange_mode = "dense"
    # a capacity overflow in the second process's rows only, on the
    # cached plan: the folded verdict heals both processes
    vals = np.arange(1 << 16, dtype=np.int64)

    def run_site(dest):
        s = ctx.Distribute(vals).node.materialize()
        m0 = mex.stats_cap_cache_misses
        got = np.asarray(ex.exchange(s, dest, ("ovf_card", W))
                         .to_global_numpy())
        return got, mex.stats_cap_cache_misses - m0
    run_site(lambda t, m, w: t % W)
    healed, misses = run_site(lambda t, m, w: torch.where(
        w >= W // 2, torch.zeros_like(t), t % W))
    out["ovf"] = hashlib.sha256(healed.tobytes()).hexdigest()
    out["ovf_misses"] = misses
    return out


if sys.argv[1] == "one":
    print("RESULT " + json.dumps(tt.Run(job, 4)), flush=True)
else:
    print("RESULT " + json.dumps(tt.RunDistributed(
        job, coordinator_address=sys.argv[2], num_processes=2,
        process_id=int(sys.argv[3]), workers_per_process=2)), flush=True)
'''


@pytest.fixture(scope="module")
def modes_runs(tmp_path_factory):
    """The uneven all-to-all, a Sort under each exchange mode and a
    capacity overflow in one process's rows, at W = 4 on one process and
    across two processes sharing the card (gloo, 2 workers each)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tmp = tmp_path_factory.mktemp("modes")
    child = tmp / "modes_child.py"
    child.write_text(_MODES_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    hosts = " ".join(f"127.0.0.1:{p}" for p in ports[1:])

    def run(argvs, env_of):
        procs = [subprocess.Popen(
            [sys.executable, str(child)] + a, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=repo, **env_of(i)))
            for i, a in enumerate(argvs)]
        out = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=300)
                assert p.returncode == 0, e[-3000:]
                out.append(json.loads([l for l in o.splitlines()
                                       if l.startswith("RESULT ")][-1][7:]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return out

    one = run([["one"]], lambda i: {})[0]
    two = run([["two", f"127.0.0.1:{ports[0]}", str(r)] for r in range(2)],
              lambda i: {"THRILL_TPU_HOSTLIST": hosts,
                         "THRILL_TPU_RANK": str(i),
                         "THRILL_TPU_SECRET": "gpu-test"})
    return one, two


@pytest.mark.gpu
def test_the_uneven_all_to_all_moves_cuda_tensors(modes_runs):
    """``MeshExec.exchange_rows`` with uneven splits takes CUDA tensors
    through gloo, the 16-bit type as its bytes, and counts the bytes
    sent to the other process."""
    _, two = modes_runs
    for r, res in enumerate(two):
        for dt, size in (("torch.int64", 8), ("torch.float64", 8),
                         ("torch.int16", 2), ("torch.uint8", 1)):
            dev, same_type, equal, cross = res[dt]
            assert dev == "cuda" and same_type and equal, dt
            assert cross == (r + 1) * (1 - r + 2) * 3 * size, dt


@pytest.mark.gpu
def test_every_exchange_mode_across_processes_on_the_card(modes_runs):
    """The Sort under the 1-factor and the ragged exchange across two
    processes is bit-equal to one process's dense Sort."""
    one, two = modes_runs
    for mode in ("dense", "onefactor", "ragged"):
        assert one["sort_" + mode] == one["sort_dense"]
        for r in two:
            assert r["sort_" + mode] == one["sort_dense"], mode


@pytest.mark.gpu
def test_a_folded_overflow_heals_in_both_processes(modes_runs):
    """An overflow in one process's rows of an optimistic exchange is
    every process's verdict: both heal once, and the rows are one
    process's."""
    one, two = modes_runs
    assert one["ovf_misses"] == 1
    for r in two:
        assert r["ovf_misses"] == 1 and r["ovf"] == one["ovf"]


# -- failure domains, resize and the element types of C21-C23 -----------

@pytest.mark.gpu
def test_resize_of_a_live_result_on_the_card(cuda_device):
    """A kept Sort result on CUDA tensors re-split from W = 4 to 2 on the
    card: the items bit-equal, the layout a fresh W = 2 Distribute's
    (zeros past the counts), the Sort's kernels launched after it."""
    from thrill_tpu_torch.common import tree as pt
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << 40, 50_000).astype(np.int64)
    ctx = tt.Context(num_workers=4)
    try:
        kept = ctx.Distribute(vals).Sort().Keep(4)
        kept.Execute()
        ctx.resize(2)
        sh = kept.node._shards
        assert sh.tree.device.type == "cuda"
        assert sh.counts.tolist() == [25_000, 25_000]
        rows = torch.cat([sh.tree[w, :int(c)] for w, c in
                          enumerate(sh.counts)]).cpu().numpy()
        assert np.array_equal(rows, np.sort(vals))
        for w, c in enumerate(sh.counts):
            assert not bool(sh.tree[w, int(c):].any())
        before = tps.radix_pass.launches
        assert [int(x) for x in ctx.Distribute(vals).Sort().AllGather()] \
            == np.sort(vals).tolist()
        assert tps.radix_pass.launches > before
        assert pt.leaves(sh.tree)[0].shape[1] >= 25_000
    finally:
        ctx.close()


@pytest.mark.gpu
def test_a_heal_after_an_oom_frees_the_card(cuda_device, monkeypatch):
    """A real ``torch.OutOfMemoryError`` inside a pipeline is recoverable:
    the PipelineError names it, the heal releases the failed run's
    memory and the next pipeline is bit-equal to a fresh Context's."""
    import gc
    vals = np.arange(1 << 20, dtype=np.int64)[::-1].copy()
    monkeypatch.setenv("THRILL_TPU_OOM_RETRY", "0")
    ctx = tt.Context(num_workers=4)
    try:
        with ctx.pipeline("warm"):
            want = ctx.Distribute(vals).Sort().AllGatherArrays().cpu()
        torch.cuda.synchronize()
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        free = torch.cuda.mem_get_info()[0]
        with pytest.raises(tt.PipelineError) as ei:
            with ctx.pipeline("oom"):
                d = ctx.Distribute(vals).Map(lambda x: x + 1).Keep(2)
                d.Execute()
                torch.empty(free * 2, dtype=torch.uint8,
                            device=cuda_device)
        assert "OutOfMemoryError" in ei.value.cause
        del ei
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() <= mem0
        with ctx.pipeline("after"):
            got = ctx.Distribute(vals).Sort().AllGatherArrays().cpu()
        assert torch.equal(got, want)
        assert ctx.overall_stats()["pipeline_aborts"] == 1
    finally:
        ctx.close()


_STICKY_CHILD = r'''
import sys, torch
import thrill_tpu_torch as tt
ctx = tt.Context(num_workers=2)
try:
    with ctx.pipeline("sticky"):
        x = torch.zeros(4, device="cuda")
        idx = torch.tensor([1 << 40], device="cuda")
        x[idx] = 1.0                       # an illegal address
        torch.cuda.synchronize()
except tt.PipelineError as e:
    print("HEALED", e.cause)
    sys.exit(3)
except Exception as e:
    print("ESCALATED", type(e).__name__, ctx._aborted)
    sys.exit(0)
'''


@pytest.mark.gpu
def test_a_sticky_cuda_error_escalates_in_its_own_process(cuda_device):
    """An illegal address poisons the process's CUDA context: the heal
    classifies it unrecoverable and the original error is raised (the
    supervised relaunch's case), in a process of its own."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", _STICKY_CHILD],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=repo),
                       cwd=repo)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    assert "ESCALATED" in p.stdout and "True" in p.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [np.int16, np.uint16, np.uint32, np.uint64])
def test_narrow_and_unsigned_columns_on_the_card(cuda_device, dt):
    """Faults C21-C22 on CUDA tensors: Sort, Max, Sum, a Map of ``x + 1``,
    ReduceByKey keyed by the column and ReduceByKey's min and max folds
    of the column give numpy's answers."""
    info = np.iinfo(dt)
    col = np.random.default_rng(5).integers(info.min, info.max, 3000,
                                            dtype=dt, endpoint=True)
    ctx = tt.Context(num_workers=4)
    try:
        d = ctx.Distribute(col).Keep(4)
        assert [int(x) for x in d.Sort().AllGather()] == \
            [int(v) for v in np.sort(col)]
        assert int(d.Max()) == int(col.max())
        s = int(d.Sum())
        if col.dtype.kind == "u":
            assert s % (1 << 64) == int(col.sum(dtype=np.uint64))
        else:
            assert s == int(col.sum(dtype=np.int64))
        add = d.Map(lambda x: x + 1).AllGatherArrays().cpu().numpy()
        assert add.dtype == dt and add.tolist() == (col + dt(1)).tolist()
        kv = ctx.Distribute({"k": col, "v": np.ones(len(col), np.int64)}) \
            .ReduceByKey(lambda t: t["k"],
                         tt.FieldReduce({"k": "first", "v": "sum"}))
        got = sorted((int(t["k"]), int(t["v"])) for t in kv.AllGather())
        u, c = np.unique(col, return_counts=True)
        assert got == [(int(a), int(b)) for a, b in zip(u, c)]
        keys = np.arange(len(col), dtype=np.int64) % 7
        for fold, np_fold in (("min", np.min), ("max", np.max)):
            kv = ctx.Distribute({"k": keys, "v": col}).ReduceByKey(
                lambda t: t["k"], tt.FieldReduce({"k": "first", "v": fold}))
            got = sorted((int(t["k"]), int(t["v"])) for t in kv.AllGather())
            assert got == [(k, int(np_fold(col[keys == k])))
                           for k in range(7)], fold
    finally:
        ctx.close()


# -- checkpoints across processes and the tenant ledger on the card ---------

_CKPT_CHILD = r'''
import json, os, sys
import numpy as np, torch
import thrill_tpu_torch as tt
from thrill_tpu_torch.common.config import Config


def job(ctx):
    rng = np.random.default_rng(31)
    n = 1 << 16
    recs = {"key": rng.integers(0, 256, (n, 10), dtype=np.uint8),
            "u": rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64),
            "s": rng.integers(-2 ** 15, 2 ** 15 - 1, n, dtype=np.int16),
            "val": np.arange(n, dtype=np.int64)}
    d = ctx.Distribute(recs).Sort(key_fn=lambda r: r["key"]) \
        .Checkpoint("sorted").Keep()
    d.Execute()
    sh = d.node._shards
    out = {k: v.cpu().numpy() for k, v in d.AllGatherArrays().items()}
    mgr = ctx.checkpoint
    return {"device": str(sh.tree["key"].device),
            "restored": mgr.restored_nodes,
            "cols": {k: [str(int(x)) for x in v.reshape(-1)[:64]]
                     + [str(int(v.astype(np.int64).sum()))]
                     for k, v in out.items()}}


cfg = Config(ckpt_dir=sys.argv[2])
resume = os.environ.get("THRILL_TPU_RESUME") == "1"
if sys.argv[1] == "one":
    res = tt.Run(job, 4, config=cfg, resume=resume)
else:
    res = tt.RunDistributed(job, coordinator_address=sys.argv[3],
                            num_processes=2, process_id=int(sys.argv[4]),
                            workers_per_process=2, config=cfg, resume=resume)
print("RESULT " + json.dumps(res), flush=True)
'''


def _ckpt_children(tmp_path, mode, ck, resume=False):
    import json
    import os
    import socket
    import subprocess
    import sys
    child = tmp_path / "ckpt_child.py"
    child.write_text(_CKPT_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("THRILL_TPU_RESUME", None)
    if resume:
        env["THRILL_TPU_RESUME"] = "1"
    if mode == "one":
        argvs, envs = [["one", ck]], [env]
    else:
        socks = [socket.socket() for _ in range(3)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        ports = [s.getsockname()[1] for s in socks]
        for s in socks:
            s.close()
        hosts = " ".join(f"127.0.0.1:{p}" for p in ports[1:])
        argvs = [["two", ck, f"127.0.0.1:{ports[0]}", str(r)]
                 for r in range(2)]
        envs = [dict(env, THRILL_TPU_HOSTLIST=hosts,
                     THRILL_TPU_RANK=str(r), THRILL_TPU_SECRET="gpu-test")
                for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(child)] + a,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=e) for a, e in zip(argvs, envs)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=300)
            assert p.returncode == 0, e[-3000:]
            out.append(json.loads([l for l in o.splitlines()
                                   if l.startswith("RESULT ")][-1][7:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.gpu
def test_an_epoch_of_two_processes_on_the_card_is_one_process_s(
        cuda_device, tmp_path):
    """Two processes (two workers each) save their CUDA shards of a
    sorted result with uint64 and int16 columns through the staging
    ring: the epoch is one process's at W = 4, byte for byte, and both
    restore it on the card with the same values."""
    import os
    ck1, ck2 = str(tmp_path / "one"), str(tmp_path / "two")
    one = _ckpt_children(tmp_path, "one", ck1)[0]
    two = _ckpt_children(tmp_path, "two", ck2)

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert files(ck1) == files(ck2) and files(ck1)
    for rel in files(ck1):
        with open(os.path.join(ck1, rel), "rb") as a, \
                open(os.path.join(ck2, rel), "rb") as b:
            assert a.read() == b.read(), rel
    again = _ckpt_children(tmp_path, "two", ck2, resume=True)
    for r in two + again:
        assert r["cols"] == one["cols"] and r["device"].startswith("cuda")
    assert [r["restored"] for r in again] == [1, 1]


@pytest.mark.gpu
def test_a_tenant_spill_on_the_card_frees_its_ledger_bytes(cuda_device):
    """An over-budget tenant's cold result leaves the card by its
    ledger bytes (``memory_allocated``), the other tenant's results stay
    on the card, and the restore is exact."""
    from thrill_tpu_torch.mem.hbm import SpilledShards
    ctx = tt.Context(num_workers=4)
    drops = []
    try:
        real = ctx.hbm.spill

        def spill(node):
            # no garbage of earlier computes may be freed inside the spill
            import gc
            gc.collect()
            torch.cuda.synchronize()
            m0, nb = torch.cuda.memory_allocated(), node._hbm_bytes
            real(node)
            torch.cuda.synchronize()
            drops.append((nb, m0 - torch.cuda.memory_allocated()))

        ctx.hbm.spill = spill

        def cache(tenant, k):
            ctx.current_tenant = tenant
            d = ctx.Distribute(torch.arange(1 << 20, device="cuda") * k)
            d.Keep()
            d.node.materialize(consume=False)
            ctx.current_tenant = None
            return d.node

        b1, a1 = cache("b", 1), cache("a", 3)
        ctx.hbm.tenant_budgets["a"] = int(1.5 * a1._hbm_bytes)
        a2 = cache("a", 5)
        assert isinstance(a1._shards, SpilledShards)
        assert all(x._shards.tree.device.type == "cuda" for x in (b1, a2))
        # 2^20 int64 items over four workers: [4, 2^18] int64, 8 MiB
        assert drops == [(8 << 20, 8 << 20)]
        assert ctx.overall_stats()["tenant_spills"] == 1
        ctx.hbm.touch(a1)
        assert np.array_equal(a1._shards.to_global_numpy(),
                              np.arange(1 << 20) * 3)
    finally:
        ctx.close()


# -- the service plane on the card ---------------------------------------------

def _service_launches():
    from thrill_tpu_torch.core import ordered_fold as tof
    return {"partition_histogram": tpk.partition_histogram.launches,
            "radix_upsweep": tps.radix_upsweep.launches,
            "radix_pass": tps.radix_pass.launches,
            "segment_sum": tpk.segment_sum.launches,
            "presence_fill": tpk.presence_fill.launches,
            "ordered_segment_sum": tof.ordered_segment_sum.launches}


def _svc_word(t):
    return t["w"]


_SVC = {}


def _svc_counted(job):
    """``job`` with its own launches and loop counters (the dispatcher
    runs one job at a time)."""
    def run(ctx):
        mex = ctx.mesh_exec
        torch.cuda.synchronize()
        l0 = _service_launches()
        f0 = (mex.stats_loop_fori_iters, mex.stats_loop_fallbacks)
        out = job(ctx)
        torch.cuda.synchronize()
        l1 = _service_launches()
        return out, {k: l1[k] - l0[k] for k in l0}, (
            mex.stats_loop_fori_iters - f0[0], mex.stats_loop_fallbacks - f0[1])
    return run


def _svc_wordcount(ctx):
    if "sum" not in _SVC:
        _SVC["sum"] = tt.FieldReduce({"w": "first", "c": "sum"})
    gen = torch.Generator(device="cuda").manual_seed(23)
    voc = torch.randint(97, 123, (1 << 14, 12), device="cuda",
                        generator=gen, dtype=torch.uint8)
    ids = torch.randint(0, 1 << 14, (1 << 20,), device="cuda", generator=gen)
    recs = {"w": voc[ids], "c": torch.ones(1 << 20, dtype=torch.int64,
                                           device="cuda")}
    out = ctx.Distribute(recs).ReduceByKey(_svc_word, _SVC["sum"]) \
        .AllGatherArrays()
    return {k: v.cpu() for k, v in out.items()}


def _svc_pagerank(ctx):
    from thrill_tpu_torch.examples import page_rank as tpr
    if "edges" not in _SVC:
        _SVC["edges"] = tpr.zipf_graph(1 << 14, 1 << 16, seed=5)
    return tpr.page_rank(ctx, _SVC["edges"], 1 << 14, 4)


@pytest.mark.gpu
def test_served_jobs_launch_as_their_direct_runs(cuda_device):
    """A WordCount and a PageRank served from four client threads run on
    the scheduler's dispatcher thread: each result bit-equal to the
    direct run's on the same Context, each job's kernel launches its
    warm direct run's, and the served PageRank's whole-loop graph
    captures there (``loop_fori_iters`` its direct run's, no
    fallback)."""
    import threading
    ctx = tt.Context(num_workers=4)
    try:
        want = {}
        for name, job in (("wc", _svc_wordcount), ("pr", _svc_pagerank)):
            for _ in range(2):              # the second run is warm
                want[name] = _svc_counted(job)(ctx)
        assert want["wc"][1]["presence_fill"] > 0
        assert want["pr"][1]["ordered_segment_sum"] > 0
        assert want["pr"][2][0] > 0 and want["pr"][2][1] == 0
        futs = []
        lock = threading.Lock()

        def client(i):
            for name, job in (("wc", _svc_wordcount), ("pr", _svc_pagerank)):
                f = ctx.submit(_svc_counted(job), tenant=f"t{i}")
                with lock:
                    futs.append((name, f))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for name, f in futs:
            out, launches, loop = f.result(600)
            if name == "wc":
                assert all(torch.equal(out[k], want["wc"][0][k])
                           for k in out)
            else:
                assert np.array_equal(out, want["pr"][0])
            assert launches == want[name][1], name
            assert loop == want[name][2], name
        assert ctx.overall_stats()["loop_replay_fallbacks"] == 0
    finally:
        ctx.close()


@pytest.mark.gpu
def test_a_served_tenant_spill_on_the_card(cuda_device):
    """Tenant b's budget below its two kept results, set through
    ``tenancy.set_budget``: b's cold result leaves the card by its
    ledger bytes inside b's served job, a's results stay, and the
    restore is exact."""
    from thrill_tpu_torch.mem.hbm import SpilledShards
    from thrill_tpu_torch.service import tenancy
    ctx = tt.Context(num_workers=4)
    drops = []
    try:
        real = ctx.hbm.spill

        def spill(node):
            import gc
            gc.collect()
            torch.cuda.synchronize()
            m0, nb = torch.cuda.memory_allocated(), node._hbm_bytes
            real(node)
            torch.cuda.synchronize()
            drops.append((node._tenant, nb, m0 - torch.cuda.memory_allocated()))

        ctx.hbm.spill = spill

        def keep(k):
            def job(c):
                d = c.Distribute(torch.arange(1 << 20, device="cuda") * k)
                d.Keep()
                d.node.materialize(consume=False)
                return d
            return job

        a1 = ctx.submit(keep(1), tenant="a").result(300)
        a2 = ctx.submit(keep(2), tenant="a").result(300)
        b1 = ctx.submit(keep(3), tenant="b").result(300)
        tenancy.set_budget(ctx, "b", int(1.5 * b1.node._hbm_bytes))
        b2 = ctx.submit(keep(5), tenant="b").result(300)
        assert isinstance(b1.node._shards, SpilledShards)
        assert all(d.node._shards.tree.device.type == "cuda"
                   for d in (a1, a2, b2))
        # 2^20 int64 items over four workers: [4, 2^18] int64, 8 MiB
        assert drops == [("b", 8 << 20, 8 << 20)]
        assert ctx.overall_stats()["tenant_spills"] == 1
        got = ctx.submit(lambda c: sorted(int(x) for x in b1.AllGather()[:4]),
                         tenant="b").result(300)
        assert got == [0, 3, 6, 9]
    finally:
        ctx.close()


@pytest.mark.gpu
def test_a_loop_graph_captures_when_the_cache_holds_the_card(cuda_device,
                                                             monkeypatch):
    """A whole-loop graph's private pool cannot take the caching
    allocator's free blocks, and a capture cannot release them: with the
    cache holding nearly all of the card just before the capture, the
    capture runs out of memory, the loop releases the cache and captures
    again, so the graph runs (``loop_fori_iters`` as without the filled
    cache) and the ranks are bit-equal."""
    from thrill_tpu_torch.api import loop as tloop
    from thrill_tpu_torch.examples import page_rank as tpr
    edges = tpr.zipf_graph(1 << 14, 1 << 16, seed=5)
    ctx = tt.Context(num_workers=4)
    real = tloop._capture_graph
    calls = []

    def capture(*args):
        if not calls:
            torch.cuda.synchronize()
            free = torch.cuda.mem_get_info()[0]
            hold = torch.empty(free - (4 << 20), dtype=torch.uint8,
                               device="cuda")
            del hold                      # cached now, not free
        calls.append(1)
        return real(*args)

    try:
        want = tpr.page_rank(ctx, edges, 1 << 14, 4)
        fori = ctx.mesh_exec.stats_loop_fori_iters
        assert fori > 0
        monkeypatch.setattr(tloop, "_capture_graph", capture)
        got = tpr.page_rank(ctx, edges, 1 << 14, 4)
        assert len(calls) == 2            # out of memory once, then made
        assert ctx.mesh_exec.stats_loop_fori_iters == 2 * fori
        assert np.array_equal(got, want)
    finally:
        ctx.close()
        torch.cuda.empty_cache()


# -- the ledger's bytes on the card (C25) and the remote vfs ------------------

def _c25_key(r):
    return r["key"]


def _c25_one(s):
    return (s, 1)


def _c25_first(kv):
    return kv[0]


def _held_blocks(shards):
    """(bytes of the storages of a DeviceShards' leaves, bytes of the
    caching allocator's blocks under them and under its device counts).
    Counts that ``MeshExec.put_small``'s content cache holds are not the
    node's: every upload of equal counts shares them, and a spill cannot
    free them."""
    from thrill_tpu_torch.common import tree as pt
    leaves = {l.untyped_storage().data_ptr(): l.untyped_storage().nbytes()
              for l in pt.leaves(shards.tree)}
    ptrs = set(leaves)
    cached = {t.untyped_storage().data_ptr()
              for t in shards.mesh_exec._put_small_cache.values()}
    if shards._counts_dev is not None and \
            shards._counts_dev.untyped_storage().data_ptr() not in cached:
        ptrs.add(shards._counts_dev.untyped_storage().data_ptr())
    blocks = {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
              for b in seg["blocks"] if b["state"] == "active_allocated"}
    return sum(leaves.values()), [blocks[p] for p in ptrs], len(ptrs)


@pytest.mark.gpu
def test_spilling_a_kept_sort_and_its_upstream_frees_their_ledger_bytes(
        cuda_device):
    """A kept W = 4 Sort, its cached source and a degree table (a
    ReduceToIndex of integer sums, whose column was a view of a larger
    scatter buffer, ROADMAP.md fault C25) spilled one by one: each node's
    ledger bytes are the bytes of its leaves' storages, its spill lowers
    ``memory_allocated`` by exactly the caching allocator's blocks under
    them and its device counts (a block exceeds its storage by the
    allocator's rounding: 512 bytes, or a free block's unsplit remainder
    of up to 1 MiB), and each restores exactly."""
    from thrill_tpu_torch.common import tree as pt
    rng = np.random.default_rng(31)
    n = 1 << 20
    rec = rng.integers(0, 256, (n, 16)).astype(np.uint8)
    ids = rng.integers(0, 1 << 18, n).astype(np.int64)
    ctx = tt.Context(num_workers=4)
    try:
        src = ctx.Distribute({"key": rec[:, :10], "value": rec[:, 10:]}
                             ).Cache().Keep()
        srt = src.Sort(key_fn=_c25_key).Keep()
        deg = ctx.Distribute(ids).Map(_c25_one).ReduceToIndex(
            _c25_first, tt.FieldReduce(("first", "sum")), 1 << 18,
            neutral=(0, 0)).Cache().Keep()
        nodes = [src.node, srt.node, deg.node]
        for node in nodes:
            node.materialize(consume=False)
        want = [node._shards.to_global_numpy() for node in nodes]
        drops = []
        for node in nodes:
            import gc
            gc.collect()
            torch.cuda.synchronize()
            nb = node._hbm_bytes
            held, blocks, n_st = _held_blocks(node._shards)
            m0 = torch.cuda.memory_allocated()
            ctx.hbm.spill(node)
            torch.cuda.synchronize()
            drops.append((node.label, nb, held, m0
                          - torch.cuda.memory_allocated(), blocks, n_st))
        for label, nb, held, dr, blocks, n_st in drops:
            assert nb > 0 and nb == held, drops
            assert dr == sum(blocks), drops
            assert 0 <= dr - held <= n_st * (1 << 20), drops
        for node, w in zip(nodes, want):
            ctx.hbm.touch(node)
            got = pt.leaves(node._shards.to_global_numpy())
            assert len(got) == len(pt.leaves(w)) and all(
                np.array_equal(a, b) for a, b in zip(got, pt.leaves(w)))
    finally:
        ctx.close()


def _remote_words(tmp_path, srv, n_words=1 << 18, parts=4):
    """A Zipf text of ``n_words`` words 16 to a line, as ``parts``
    objects on ``srv`` and as files; (the URL glob, the file glob)."""
    rng = np.random.default_rng(32)
    ranks = np.arange(1, 4097, dtype=np.float64)
    w = rng.choice(4096, n_words, p=(1 / ranks) / (1 / ranks).sum())
    words = [f"w{v:x}" for v in w.tolist()]
    lines = [" ".join(words[i:i + 16]) for i in range(0, n_words, 16)]
    per = -(-len(lines) // parts)
    for k in range(parts):
        body = ("\n".join(lines[k * per:(k + 1) * per]) + "\n").encode()
        srv.put(f"b/words-{k:02d}.txt", body)
        (tmp_path / f"words-{k:02d}.txt").write_bytes(body)
    return f"{srv.url}/b/words-*", str(tmp_path / "words-*")


@pytest.mark.gpu
def test_a_remote_text_wordcount_on_the_card_is_the_file_one(cuda_device,
                                                              tmp_path):
    """Phase V1 at a small size: the text WordCount W = 4 of four objects
    over http:// gives the counts of the same four files, bit for bit,
    with the same launches of B1, the radix engine and B4."""
    from thrill_tpu_torch.examples import word_count as twc
    from thrill_tpu_torch.tools.object_server import ObjectServer
    with ObjectServer() as srv:
        url, local = _remote_words(tmp_path, srv)
        got = {}
        for src in (url, local):
            ctx = tt.Context(num_workers=4)
            torch.cuda.synchronize()
            before = _service_launches()
            out = twc.word_count_text_device(ctx, src).AllGatherArrays()
            torch.cuda.synchronize()
            after = _service_launches()
            got[src] = (out, {k: after[k] - before[k] for k in after})
            ctx.close()
    (ro, rl), (lo, ll) = got[url], got[local]
    assert all(torch.equal(ro[k], lo[k]) for k in lo)
    assert int(lo["c"].sum()) == 1 << 18
    assert rl == ll
    assert all(rl[k] > 0 for k in ("partition_histogram", "radix_upsweep",
                                   "radix_pass", "presence_fill"))


def _ckpt_triple(x):
    return x * 3


@pytest.mark.gpu
def test_a_remote_checkpoint_resumes_on_the_card(cuda_device, tmp_path):
    """Phase V3's checkpoint at a small size: a device result and the
    flagship ReadLines -> Sort -> Checkpoint -> AllGather, each with its
    checkpoint directory on the object server, then resumed from the
    remote epoch; equal to the first runs and to file://."""
    from thrill_tpu_torch.common.config import Config
    from thrill_tpu_torch.tools.object_server import ObjectServer

    def device_job(ctx):
        d = ctx.Distribute(np.arange(1 << 16, dtype=np.int64)).Map(
            _ckpt_triple).Checkpoint()
        return (d.AllGatherArrays().cpu().numpy(),
                ctx.overall_stats()["resume_skipped_ops"])

    def lines_job(src):
        def job(ctx):
            return ctx.ReadLines(src).Sort().Checkpoint().AllGather()
        return job

    with ObjectServer() as srv:
        url, local = _remote_words(tmp_path, srv, n_words=1 << 14)
        want_lines = tt.Run(lines_job(local), 4,
                            config=Config(ckpt_dir=str(tmp_path / "ck")))
        for resume in (False, True):
            arr, skipped = tt.Run(device_job, 4, resume=resume, config=Config(
                ckpt_dir=f"{srv.url}/b/ck-dev"))
            assert np.array_equal(np.sort(arr), np.arange(1 << 16) * 3)
            assert (skipped >= 1) == resume
            assert tt.Run(lines_job(url), 4, resume=resume, config=Config(
                ckpt_dir=f"{srv.url}/b/ck-lines")) == want_lines
        assert any(k.startswith("b/ck-dev/epoch_") for k in srv.objects)
        assert any(k.startswith("b/ck-lines/epoch_") for k in srv.objects)


def _nk_word(t):
    return t["w"]


def _nk_add(a, b):
    return {"w": a["w"], "c": a["c"] + b["c"]}


def _nk_group(k, items):
    return (k, len(items), sum(int(i["c"]) for i in items))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 4])
def test_the_card_s_sort_reduce_and_groups_are_the_native_engine_s(
        cuda_device, W):
    """Sort, ReduceByKey (FieldReduce and a generic reduce_fn) and
    GroupByKey on the card give what a CPU mesh's native engine
    (core/host_radix.py) gives: the Sort row for row, the reduces' and
    groups' rows as sets (the card's come key-sorted, the engine's in
    first-appearance order), integer sums exactly."""
    from thrill_tpu_torch.core import host_radix
    rng = np.random.default_rng(70 + W)
    n = 50000
    recs = {"key": rng.integers(0, 256, (n, 10)).astype(np.uint8),
            "pay": rng.integers(0, 256, (n, 6)).astype(np.uint8)}
    words = {"w": rng.integers(0, 3, (n, 4)).astype(np.uint8)
             * np.uint8(40) + np.uint8(97),
             "c": rng.integers(1, 5, n).astype(np.int64)}

    def rows(out):
        w, c = out["w"].cpu().numpy(), out["c"].cpu().numpy()
        return sorted(zip(map(bytes, w), c.tolist()))

    got = {}
    for dev in ("cpu", "cuda"):
        ctx = tt.Context(num_workers=W, device=dev)
        assert host_radix.eligible(ctx.mesh_exec) == (dev == "cpu")
        srt = ctx.Distribute(recs).Sort(lambda r: r["key"]).AllGatherArrays()
        fr = ctx.Distribute(words).ReduceByKey(
            _nk_word, tt.FieldReduce({"w": "first", "c": "sum"})
        ).AllGatherArrays()
        gen = ctx.Distribute(words).ReduceByKey(_nk_word, _nk_add) \
            .AllGatherArrays()
        grp = ctx.Distribute(words).GroupByKey(_nk_word, _nk_group) \
            .AllGather()
        got[dev] = ({k: v.cpu() for k, v in srt.items()}, rows(fr),
                    rows(gen), sorted(grp))
        ctx.close()
    cpu, card = got["cpu"], got["cuda"]
    assert all(torch.equal(cpu[0][k], card[0][k]) for k in recs)
    assert cpu[1] == card[1] == cpu[2] == card[2]
    assert cpu[3] == card[3]
    assert sum(c for _, c in cpu[1]) == int(words["c"].sum())


@pytest.mark.gpu
def test_perf_sentinel_check_is_clean_on_the_card(cuda_device, capsys):
    from thrill_tpu_torch.tools import perf_sentinel
    assert perf_sentinel.main(["--check", "--device", "cuda"]) == 0
    assert "clean: 11 workloads match" in capsys.readouterr().out


@pytest.mark.gpu
def test_the_native_engine_loads_but_never_runs_on_a_card_mesh(cuda_device):
    from thrill_tpu_torch.core import host_radix
    assert host_radix.available()         # hostsort.cpp builds on the host
    ctx = tt.Context(num_workers=4, device="cuda")
    assert not host_radix.eligible(ctx.mesh_exec)
    ctx.close()
    ctx = tt.Context(num_workers=4, device="cpu")
    assert host_radix.eligible(ctx.mesh_exec)
    ctx.close()
