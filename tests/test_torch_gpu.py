"""The port's CUDA kernels and its Sort on the card.

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
