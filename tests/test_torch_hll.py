"""The port's HyperLogLog and stable_host_hash against the reference
package on the CPU.

The registers must equal the reference's bit for bit, on the device
path (hash of the key words) and on the host path (``stable_host_hash``
of each item), at W in {1, 2, 3, 4}; the estimates then agree exactly.
Items include keys of 2^63 and above, whose hashes and encodings have
the sign bit set: signed shifts or compares (ROADMAP.md fault C1) would
change the registers.
"""

import jax
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api.ops import hll as jhll
from thrill_tpu.common.hashing import stable_host_hash as jhash
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.ops import hll as thll
from thrill_tpu_torch.common.hashing import stable_host_hash as thash

WIDTHS = [1, 2, 3, 4]


def _ref_registers(W, make, p, monkeypatch):
    """The reference's registers and estimate of ``make(ctx)``."""
    seen = []
    real = jhll._estimate

    def capture(regs, p_):
        seen.append(np.asarray(regs).copy())
        return real(regs, p_)

    monkeypatch.setattr(jhll, "_estimate", capture)
    ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    try:
        est = make(ctx).HyperLogLog(precision=p)
    finally:
        ctx.close()
        monkeypatch.setattr(jhll, "_estimate", real)
    return seen[0], est


def _port_registers(W, make, p):
    shards = make(tt.Context(num_workers=W, device="cpu"))._link().pull()
    if hasattr(shards, "lists"):
        return thll.host_registers(shards.lists, p)
    return thll.device_registers(shards, p).numpy()


def _wide_ints(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    x[:4] = [-1, -(1 << 63), (1 << 63) - 1, 0]
    return np.concatenate([x, x[: n // 3]])       # repeats


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("p", [4, 10])
def test_device_registers_match_reference(W, p, monkeypatch):
    x = _wide_ints(3000, W)

    def make(ctx):
        return ctx.Distribute(x)

    want, est = _ref_registers(W, make, p, monkeypatch)
    got = _port_registers(W, make, p)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert make(tt.Context(num_workers=W, device="cpu")).HyperLogLog(p) == est


@pytest.mark.parametrize("W", WIDTHS)
def test_device_registers_of_pytree_items_after_a_filter_match(W,
                                                               monkeypatch):
    rng = np.random.default_rng(40 + W)
    items = {"a": rng.integers(0, 50, 900).astype(np.int64),
             "f": rng.integers(0, 4, 900).astype(np.float32)}

    def make(ctx):
        return ctx.Distribute(items).Filter(lambda r: r["a"] > 10)

    want, _ = _ref_registers(W, make, 8, monkeypatch)
    assert np.array_equal(_port_registers(W, make, 8), want)


@pytest.mark.parametrize("W", WIDTHS)
def test_host_registers_match_reference(W, monkeypatch):
    items = ([2**63, 2**63 + 5, 2**64 - 1, -1, 0, 3.5, -0.0, "abc", b"xy",
              (1, "a"), True] + list(range(500))
             + [f"w{i}" for i in range(300)])

    def make(ctx):
        return ctx.Distribute(items, storage="host")

    want, est = _ref_registers(W, make, 9, monkeypatch)
    assert np.array_equal(_port_registers(W, make, 9), want)
    assert make(tt.Context(num_workers=W, device="cpu")).HyperLogLog(9) == est


def test_estimate_is_near_the_distinct_count():
    ctx = tt.Context(num_workers=4, device="cpu")
    est = ctx.Generate(20000, fn=lambda i: i % 5000).HyperLogLog(12)
    assert abs(est - 5000) < 3 * 1.04 / 64 * 5000


def test_clz_on_int64_bit_patterns():
    rng = np.random.default_rng(1)
    v = rng.integers(1, 1 << 63, 2000, dtype=np.int64) >> rng.integers(
        0, 63, 2000)
    v = np.concatenate([v, -v, [1, -1, -(1 << 63)]]).astype(np.int64)
    v = v[v != 0]
    got = thll._clz_device(torch.as_tensor(v)).numpy()
    assert got.tolist() == [thll._clz64(int(u)) for u in v.view(np.uint64)]


@pytest.mark.parametrize("obj", [
    0, 1, -1, 2**63, 2**64 + 5, -(2**70), 1.5, -0.0, 0.0, 2.0**64, 1e300,
    float("inf"), "", "abc", "ünï", b"", b"xy\x00", (), (1, "a", (2.5,)),
    True, np.int32(7), np.uint64(2**64 - 1), np.float32(0.25), None,
    [1, 2], ("x", -0.0, b"z")])
def test_stable_host_hash_matches_reference(obj):
    assert thash(obj) == jhash(obj)
