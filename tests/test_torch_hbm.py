"""The port's HBM governor (``mem/hbm.py``) against the reference
package on the CPU, at W = 1, 2 and 4: the cases of the reference's own
``tests/mem/test_hbm_spill.py`` run through both packages with the same
inputs and limits, each result compared and the reference's assertions
made on both packages' counters; then the LRU order, the ``hbm_peak``
ledger, a spill fault that leaves the node resident, and a restore read
from disk through the readahead."""

import json

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.mem.hbm import SpilledShards as JSpilled
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.data.shards import DeviceShards
from thrill_tpu_torch.mem.hbm import SpilledShards

WS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("THRILL_TPU_FAULTS", "THRILL_TPU_HBM_LIMIT",
                "THRILL_TPU_SPILL_RESIDENT", "THRILL_TPU_PREFETCH"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _both(tmp_path, W, limit, log=False):
    """(reference Context, port Context) with the same governor limit,
    spill directory and, with ``log``, an event log each."""
    def cfg(mod, name):
        return mod(hbm_limit=limit, spill_dir=str(tmp_path),
                   log_path=(str(tmp_path / f"{name}-{{host}}.jsonl")
                             if log else None))
    j = JContext(JMeshExec(devices=jax.devices("cpu")[:W]),
                 cfg(JConfig, "jax"))
    t = tt.Context(num_workers=W, device="cpu", config=cfg(Config, "torch"))
    return j, t


def _events(tmp_path, name):
    path = next(tmp_path.glob(f"{name}-*.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("W", WS)
def test_accounting_tracks_cached_nodes(tmp_path, W):
    out = []
    for ctx in _both(tmp_path, W, limit=0):
        d = ctx.Distribute(np.arange(1024, dtype=np.int64)).Map(
            lambda x: x * 2)
        d.Keep().Size()
        total, peak = ctx.hbm.mem.total, ctx.hbm.mem.peak
        assert total > 0 and peak >= total
        # the consuming pull releases the accounting
        assert d.Sum() == 2 * (1023 * 1024 // 2)
        assert ctx.hbm.spill_count == 0 and ctx.hbm.mem.total == 0
        out.append((total, peak, ctx.overall_stats()["hbm_peak"]))
        ctx.close()
    assert out[0] == out[1]


@pytest.mark.parametrize("W", WS)
def test_spill_and_restore_roundtrip(tmp_path, W):
    """A budget below one node: caching the second spills the first,
    whose next pull restores it; both logs carry the events."""
    counts = []
    for ctx in _both(tmp_path, W, limit=4096, log=True):
        a = ctx.Distribute(np.arange(4096, dtype=np.int64))
        a.Keep(3)
        assert a.Size() == 4096
        b = ctx.Distribute(np.arange(8192, dtype=np.int64) * 3)
        b.Keep(2)
        assert b.Size() == 8192
        assert ctx.hbm.spill_count >= 1
        assert isinstance(a.node._shards, (SpilledShards, JSpilled))
        assert [int(x) for x in a.AllGather()] == list(range(4096))
        assert ctx.hbm.restore_count >= 1
        counts.append((ctx.hbm.spill_count, ctx.hbm.restore_count,
                       ctx.hbm.mem.peak))
        ctx.close()
    assert counts[0] == counts[1]
    for name in ("jax", "torch"):
        events = _events(tmp_path, name)
        kinds = [e.get("event") for e in events]
        assert "hbm_spill" in kinds and "hbm_restore" in kinds
        spill = next(e for e in events if e.get("event") == "hbm_spill")
        assert spill["bytes"] > 0


@pytest.mark.parametrize("W", WS)
def test_spill_through_full_pipeline(tmp_path, W):
    """A Sort whose kept input and kept output exceed the budget: the
    cold input spills and restores on its next use."""
    rng = np.random.default_rng(0)
    recs = {"key": rng.integers(0, 256, size=(2048, 10)).astype(np.uint8),
            "val": rng.integers(0, 256, size=(2048, 8)).astype(np.uint8)}
    got = []
    for ctx in _both(tmp_path, W, limit=2048):
        d = ctx.Distribute(recs)
        d.Keep(2)
        srt = d.Sort(key_fn=lambda r: r["key"])
        srt.Keep()
        out = srt.AllGather()               # caching srt evicts kept d
        rows = [(tuple(np.asarray(r["key"]).tolist()),
                 tuple(np.asarray(r["val"]).tolist())) for r in out]
        assert [k for k, _ in rows] == sorted(k for k, _ in rows)
        assert len(rows) == 2048
        assert ctx.hbm.spill_count >= 1
        assert d.Size() == 2048
        assert ctx.hbm.restore_count >= 1
        got.append(rows)
        ctx.close()
    assert got[0] == got[1]


@pytest.mark.parametrize("W", WS)
def test_immediately_consumed_results_skip_lru(tmp_path, W):
    """A one-shot result released by its own pull never evicts a kept
    one."""
    for ctx in _both(tmp_path, W, limit=65536):
        a = ctx.Distribute(np.arange(4096, dtype=np.int64))
        a.Keep(5)
        assert a.Size() == 4096             # 32 KiB of the 64 KiB
        for _ in range(3):
            b = ctx.Distribute(np.arange(8192, dtype=np.int64))
            assert b.Sum() == 8191 * 8192 // 2
        assert ctx.hbm.spill_count == 0
        assert [int(x) for x in a.AllGather()][:3] == [0, 1, 2]
        ctx.close()


@pytest.mark.parametrize("W", WS)
def test_unlimited_budget_never_spills(tmp_path, W):
    peaks = []
    for ctx in _both(tmp_path, W, limit=0):
        for i in range(4):
            d = ctx.Distribute(np.arange(8192, dtype=np.int64) + i)
            d.Keep()
            d.Size()
        assert ctx.hbm.spill_count == 0
        peaks.append(ctx.hbm.mem.peak)
        ctx.close()
    assert peaks[0] == peaks[1] > 0


def _spilled(nodes):
    return [type(n._shards).__name__ == "SpilledShards" for n in nodes]


@pytest.mark.parametrize("W", WS)
def test_the_coldest_node_spills_first(tmp_path, W):
    """Three kept nodes of 32 KiB under a 112 KiB limit; the first is
    pulled again, so the second is the coldest when a fourth is cached."""
    got = []
    for ctx in _both(tmp_path, W, limit=112 << 10):
        dias = [ctx.Distribute(np.arange(4096, dtype=np.int64) + i)
                for i in range(4)]
        for d in dias:
            d.Keep(3)
        for d in dias[:3]:
            d.Size()
        dias[0].Size()                     # LRU bump
        assert ctx.hbm.spill_count == 0
        dias[3].Size()
        state = _spilled([d.node for d in dias])
        assert state == [False, True, False, False]
        assert [int(x) for x in dias[1].AllGather()] == \
            list(range(1, 4097))
        got.append((state, ctx.hbm.spill_count, ctx.hbm.restore_count))
        ctx.close()
    assert got[0] == got[1]


@pytest.mark.parametrize("W", WS)
def test_a_failed_spill_keeps_the_node_resident_and_right(tmp_path, W):
    with faults.inject("mem.hbm.spill", n=0):
        ctx = tt.Context(num_workers=W, device="cpu",
                         config=Config(hbm_limit=4096,
                                       spill_dir=str(tmp_path)))
        a = ctx.Distribute(np.arange(4096, dtype=np.int64))
        a.Keep(2)
        a.Size()
        b = ctx.Distribute(np.arange(100, dtype=np.int64))
        b.Keep()
        b.Size()
        assert isinstance(a.node._shards, DeviceShards)
        assert ctx.hbm.spill_count == 0 and faults.REGISTRY.injected >= 1
        assert any(e.get("what") == "hbm.spill_skipped"
                   for e in faults.REGISTRY.events)
        assert [int(x) for x in a.AllGather()] == list(range(4096))
        ctx.close()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("prefetch", ["4", "0"])
def test_a_restore_from_disk_is_exact(tmp_path, monkeypatch, prefetch):
    """The store keeps 64 KiB resident, so a 512 KiB node's blocks come
    back from files, through the readahead or in turn."""
    monkeypatch.setenv("THRILL_TPU_SPILL_RESIDENT", "64K")
    monkeypatch.setenv("THRILL_TPU_PREFETCH", prefetch)
    ctx = tt.Context(num_workers=4, device="cpu",
                     config=Config(hbm_limit=600 << 10,
                                   spill_dir=str(tmp_path)))
    rng = np.random.default_rng(1)
    data = {"k": rng.integers(0, 1 << 62, 1 << 15),
            "v": rng.standard_normal((1 << 15, 1)).astype(np.float32),
            "b": rng.integers(0, 2, 1 << 15).astype(bool)}
    a = ctx.Distribute(data)
    a.Keep(2)
    a.Size()
    b = ctx.Distribute(np.arange(1 << 15, dtype=np.int64))
    b.Keep()
    b.Size()
    assert isinstance(a.node._shards, SpilledShards)
    ctx.hbm._pool.flush()
    assert any(tmp_path.iterdir())         # parked past the soft limit
    got = a.AllGatherArrays()
    for k in data:
        assert np.array_equal(got[k].numpy(), data[k])
    assert ctx.hbm.restore_count == 1
    ctx.close()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("W", WS)
def test_a_compute_keeps_the_input_it_holds(tmp_path, W):
    """A Zip pulls its kept first input, then computes and caches its
    second under a limit that cannot hold both: the governor spills
    nothing the running compute holds (a spill of it would free no
    memory and a later pull would upload a second copy)."""
    ctx = tt.Context(num_workers=W, device="cpu",
                     config=Config(hbm_limit=48 << 10,
                                   spill_dir=str(tmp_path)))
    a = ctx.Distribute(np.arange(4096, dtype=np.int64))
    a.Keep(2)
    assert a.Size() == 4096                # 32 KiB cached
    b = ctx.Distribute(np.arange(4096, dtype=np.int64)).Map(
        lambda x: x * 3)
    b.Keep()                               # cached by the Zip's pull
    z = tt.Zip(a, b, zip_fn=lambda x, y: x + y)
    got = z.AllGatherArrays().numpy()
    assert np.array_equal(got, np.arange(4096) * 4)
    assert b.node._shards is not None
    assert isinstance(a.node._shards, DeviceShards)
    assert ctx.hbm.spill_count == 0 and ctx.hbm.restore_count == 0
    assert ctx.hbm.mem.total == 2 * (32 << 10)
    # out of the compute, a is cold again and the next cache spills it
    c = ctx.Distribute(np.arange(512, dtype=np.int64))
    c.Keep()
    c.Size()
    assert isinstance(a.node._shards, SpilledShards)
    assert [int(x) for x in a.AllGather()] == list(range(4096))
    ctx.close()


@pytest.mark.parametrize("fail", [False, True])
def test_run_closes_its_context(tmp_path, monkeypatch, fail):
    """``Run`` closes the Context however the job ends: the log gets its
    ``overall_stats`` line and the spill store's files are gone."""
    spill = tmp_path / "spill"
    monkeypatch.setenv("THRILL_TPU_LOG", str(tmp_path / "run-{}.jsonl"))
    monkeypatch.setenv("THRILL_TPU_SPILL_DIR", str(spill))
    monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "64K")
    monkeypatch.setenv("THRILL_TPU_SPILL_RESIDENT", "64K")
    seen = {}

    def job(ctx):
        a = ctx.Distribute(np.arange(1 << 14, dtype=np.int64))
        a.Keep()
        a.Size()                           # 128 KiB: spilled by b
        b = ctx.Distribute(np.arange(1 << 14, dtype=np.int64))
        b.Keep()
        b.Size()
        ctx.hbm._pool.flush()
        seen["files"] = len(list(spill.iterdir()))
        seen["spills"] = ctx.hbm.spill_count
        if fail:
            raise ValueError("the job failed")
        return int(a.Sum())

    if fail:
        with pytest.raises(ValueError, match="the job failed"):
            tt.Run(job, 2, device="cpu")
    else:
        n = 1 << 14
        assert tt.Run(job, 2, device="cpu") == n * (n - 1) // 2
    assert seen["spills"] >= 1 and seen["files"] >= 1
    assert list(spill.iterdir()) == []
    events = [json.loads(line)
              for line in open(tmp_path / "run-0.jsonl")]
    stats = [e for e in events if e.get("event") == "overall_stats"]
    # a.Sum() restores a, which spills b
    assert len(stats) == 1 and stats[0]["hbm_spills"] >= seen["spills"]
    assert faults.REGISTRY._log is None
