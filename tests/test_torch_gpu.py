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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lo,hi,bins", [
    ((4, 1 << 16), 0, 256, 256),          # radix digits
    ((3, 4097), -9, 300, 256),            # out of range, ragged tiles
    ((4, 5000), 0, 5, 4),                 # send counts: 4 = invalid
    ((2, 8192), 3, 4, 256),               # one digit everywhere
    ((0,), 0, 1, 8),                      # empty
])
def test_cuda_kernels_match_plain(cuda_device, shape, lo, hi, bins):
    rng = np.random.default_rng(9)
    d = torch.as_tensor(rng.integers(lo, hi, size=shape, dtype=np.int32),
                        device=cuda_device)
    launches = (tpk.partition_histogram.launches,
                tps.stable_partition_offsets.launches)
    assert torch.equal(tpk.partition_histogram(d, bins),
                       tpk.partition_histogram_plain(d, bins))
    assert torch.equal(tps.stable_partition_offsets(d, bins),
                       tps.stable_partition_offsets_plain(d, bins))
    assert (tpk.partition_histogram.launches,
            tps.stable_partition_offsets.launches) == (launches[0] + 1,
                                                       launches[1] + 1)


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lo,hi,regs", [
    ((4, 1 << 16), 0, 1 << 17, 1 << 17),  # WordCount's register count
    ((3, 4097), -9, 300, 256),            # out of range, ragged rows
    ((0,), 0, 1, 8),                      # empty
])
def test_presence_fill_matches_plain(cuda_device, shape, lo, hi, regs):
    rng = np.random.default_rng(12)
    h = torch.as_tensor(rng.integers(lo, hi, size=shape, dtype=np.int32),
                        device=cuda_device)
    valid = torch.as_tensor(rng.random(shape) < 0.7, device=cuda_device)
    before = tpk.presence_fill.launches
    assert torch.equal(tpk.presence_fill(h, valid, regs),
                       tpk.presence_fill_plain(h, valid, regs))
    assert tpk.presence_fill.launches == before + 1


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
