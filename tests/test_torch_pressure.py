"""The port's memory-pressure ladder (``mem/pressure.py``) against the
reference package on the CPU: the OOM classifier, admission under
``THRILL_TPU_HBM_LIMIT`` (and none without a budget), rung 2's retry of
an injected ``mem.oom`` with the same spec in both packages (results
bit-equal, no consumed parent pulled twice), ``THRILL_TPU_OOM_RETRY=0``,
errors that are not an OOM, a real ``torch.OutOfMemoryError`` raised in a
compute, and pressured runs equal to unpressured ones."""

import numpy as np
import pytest
import torch

import jax
from thrill_tpu.api import Context as JContext
from thrill_tpu.api import FieldReduce as JFieldReduce
from thrill_tpu.common import faults as jfaults
from thrill_tpu.mem import pressure as jpressure
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api import dia_base
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.data.shards import DeviceShards
from thrill_tpu_torch.mem import pressure

WS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in (faults.ENV_VAR, "THRILL_TPU_HBM_LIMIT",
                "THRILL_TPU_OOM_RETRY", "THRILL_TPU_RETRY",
                "THRILL_TPU_RETRY_ATTEMPTS"):
        monkeypatch.delenv(var, raising=False)
    # no backoff sleeps in the tests
    monkeypatch.setenv("THRILL_TPU_RETRY_BASE_S", "0")
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _jctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _tctx(W):
    return tt.Context(num_workers=W, device="cpu")


# -- the classifier ------------------------------------------------------

CASES = [
    ("simulated", lambda m: m.SimulatedOom("mem.oom"), True),
    ("resource_exhausted", lambda m: RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating 12345 bytes"), True),
    ("memory_error", lambda m: MemoryError(), True),
    ("plain", lambda m: RuntimeError("shape mismatch"), False),
    ("injected_io", lambda m: (faults if m is pressure else jfaults)
     .InjectedIOError("x"), False),
    ("key_error", lambda m: KeyError("RESOURCE_EXHAUSTED"), False),
]


@pytest.mark.parametrize("name,make,want", CASES, ids=[c[0] for c in CASES])
def test_is_oom_error_matches_reference(name, make, want):
    assert pressure.is_oom_error(make(pressure)) is want
    assert jpressure.is_oom_error(make(jpressure)) is want


def test_is_oom_error_knows_torch_and_no_other_cuda_error():
    assert pressure.is_oom_error(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    # a CUDA error leaves the context unusable: never retried, whatever
    # its text says
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: unspecified launch failure",
                "CUDA error: out of memory"):
        assert not pressure.is_oom_error(RuntimeError(msg))


# -- rung 1: admission ----------------------------------------------------

def _kept_then_pipeline(ctx):
    """A kept 32 KiB node, then a 64 KiB pipeline, then the kept node
    again; returns (kept, pipeline) results."""
    a = ctx.Distribute(np.arange(4096, dtype=np.int64))
    a.Keep(2)
    assert a.Size() == 4096
    got = sorted(int(x) for x in ctx.Distribute(
        np.arange(8192, dtype=np.int64)).Map(lambda x: x + 1).AllGather())
    stats = ctx.overall_stats()
    kept = [int(x) for x in a.AllGather()]
    return kept, got, stats


@pytest.mark.parametrize("W", WS)
def test_admission_spills_cold_results_before_the_work(W, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "64Ki")
    out = []
    for ctx in (_jctx(W), _tctx(W)):
        assert ctx.pressure.enabled and ctx.pressure.budget == 64 * 1024
        kept, got, stats = _kept_then_pipeline(ctx)
        assert got == [x + 1 for x in range(8192)]
        assert kept == list(range(4096))
        assert stats["hbm_spills"] >= 1
        assert stats["admission_spills"] >= 1
        assert stats["pressure_spilled_bytes"] > 0
        assert stats["hbm_high_watermark"] > 64 * 1024
        assert stats["oom_retries"] == 0
        out.append((kept, got))
        ctx.close()
    assert out[0] == out[1]
    assert any(e.get("event") == "mem_spill" for e in faults.REGISTRY.events)


@pytest.mark.parametrize("W", WS)
def test_stage_admission_spills_past_the_watermark(W, monkeypatch):
    """Two kept nodes of 32 KiB, computed without a pull, fill the
    64 KiB budget, which the governor's own limit allows but the 85 %
    watermark does not: the next node's stage admission spills the
    coldest."""
    monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "64Ki")
    ctx = _tctx(W)
    a = ctx.Distribute(np.arange(4096, dtype=np.int64))
    b = ctx.Distribute(np.arange(3072, dtype=np.int64))
    for d in (a, b):
        d.Keep(2)
        d.Execute()
    assert ctx.hbm.spill_count == 0 and ctx.hbm.mem.total == 64 << 10
    assert ctx.Generate(16).Size() == 16
    assert type(a.node._shards).__name__ == "SpilledShards"
    assert isinstance(b.node._shards, DeviceShards)
    s = ctx.overall_stats()
    assert s["admission_spills"] == 1 and s["oom_retries"] == 0
    assert [int(x) for x in a.AllGather()] == list(range(4096))
    ctx.close()


def test_no_budget_means_no_admission():
    for ctx in (_jctx(2), _tctx(2)):
        assert not ctx.pressure.enabled
        kept, got, stats = _kept_then_pipeline(ctx)
        assert stats["hbm_high_watermark"] == 0
        assert stats["pressure_spilled_bytes"] == 0
        assert stats["hbm_spills"] == stats["admission_spills"] == 0
        assert stats["oom_retries"] == 0 and stats["segment_splits"] == 0
        ctx.close()


def test_admission_never_spills_what_a_compute_holds(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "1Ki")      # always over
    ctx = _tctx(2)
    a = ctx.Distribute(np.arange(2048, dtype=np.int64))
    a.Keep(2)
    assert a.Size() == 2048
    memo = pressure.PullMemo()
    memo.pulls.append((None, a.node._shards))
    ctx.pressure.memos.append(memo)
    assert ctx.pressure.spill_cold() == 0
    assert isinstance(a.node._shards, DeviceShards)
    ctx.pressure.memos.pop()
    assert ctx.pressure.spill_cold() > 0
    assert [int(x) for x in a.AllGather()] == list(range(2048))
    ctx.close()


# -- rung 2: the OOM retry -------------------------------------------------

def _pipeline(ctx, field_reduce):
    """Distribute -> Sort -> Map -> ReduceByKey -> AllGather: three
    nodes, each consuming its parent."""
    rng = np.random.default_rng(3)
    data = {"k": rng.integers(0, 17, 300).astype(np.int64),
            "v": rng.integers(0, 1000, 300).astype(np.int64)}
    out = ctx.Distribute(data).Sort(key_fn=lambda r: r["v"]) \
        .Map(lambda r: {"k": r["k"], "v": r["v"] * 2}) \
        .ReduceByKey(lambda r: r["k"],
                     field_reduce({"k": "first", "v": "sum"})).AllGather()
    return sorted((int(r["k"]), int(r["v"])) for r in out)


def _count_pulls(monkeypatch):
    """Count each node's consuming materializations."""
    pulls = {}
    real = dia_base.DIABase.materialize

    def counted(self, consume=False):
        if consume:
            pulls[self.label] = pulls.get(self.label, 0) + 1
        return real(self, consume)

    monkeypatch.setattr(dia_base.DIABase, "materialize", counted)
    return pulls


def _oom_retry_case(W, after, monkeypatch):
    pulls = _count_pulls(monkeypatch)
    want_t = _pipeline(_tctx(W), tt.FieldReduce)
    clean_pulls = dict(pulls)
    pulls.clear()
    want_j = _pipeline(_jctx(W), JFieldReduce)
    monkeypatch.setenv(faults.ENV_VAR, f"mem.oom:n=1:after={after}")
    ctx = _tctx(W)
    got_t = _pipeline(ctx, tt.FieldReduce)
    assert pulls == clean_pulls
    assert ctx.overall_stats()["oom_retries"] == 1
    assert faults.REGISTRY.injected == 1
    assert any(e.get("event") == "oom_retry"
               for e in faults.REGISTRY.events)
    jctx = _jctx(W)
    got_j = _pipeline(jctx, JFieldReduce)
    assert got_t == want_t == got_j == want_j


@pytest.mark.parametrize("after", [0, 1, 2])
@pytest.mark.parametrize("W", WS)
def test_oom_retry_is_bit_equal_and_pulls_nothing_twice(W, after,
                                                        monkeypatch):
    """The same ``mem.oom`` spec in both packages, on the per-op path
    (``THRILL_TPU_FUSE=0``), where every op is a site: one injected OOM
    (on the Distribute, the Sort or the ReduceByKey, by ``after``) is
    spilled around and retried; the results equal the unfaulted runs and
    every node is pulled as often as without the fault."""
    monkeypatch.setenv("THRILL_TPU_FUSE", "0")
    _oom_retry_case(W, after, monkeypatch)


@pytest.mark.parametrize("after", [0, 1])
@pytest.mark.parametrize("W", WS)
def test_stitched_oom_retry_is_bit_equal_and_pulls_nothing_twice(
        W, after, monkeypatch):
    """The same with stitching on: the sites are the Distribute's compute
    and the stitched dispatches (at W = 1 the Sort, the Map and the
    ReduceByKey are one); a retry at the dispatch pulls nothing again."""
    _oom_retry_case(W, after, monkeypatch)


def test_oom_retry_spills_a_kept_result_and_restores_it(monkeypatch):
    ctx = _tctx(2)
    a = ctx.Distribute(np.arange(4096, dtype=np.int64))
    a.Keep(2)
    a.Size()
    monkeypatch.setenv(faults.ENV_VAR, "mem.oom:n=1")
    assert ctx.Generate(64).Size() == 64
    s = ctx.overall_stats()
    assert s["oom_retries"] == 1 and s["hbm_spills"] == 1
    assert s["admission_spills"] == 0 and s["pressure_spilled_bytes"] > 0
    assert [int(x) for x in a.AllGather()] == list(range(4096))
    ctx.close()


def test_an_oom_the_ladder_cannot_cure_surfaces(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "mem.oom:n=0")
    ctx = _tctx(2)
    with pytest.raises(pressure.SimulatedOom):
        ctx.Generate(64).Size()
    # the shared budget: 4 attempts, the first the failed compute
    assert ctx.overall_stats()["oom_retries"] == 3
    ctx.close()


def test_ladder_disabled_surfaces_the_oom(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_OOM_RETRY", "0")
    monkeypatch.setenv(faults.ENV_VAR, "mem.oom:n=0")
    for ctx, mod in ((_jctx(2), jpressure), (_tctx(2), pressure)):
        with pytest.raises(mod.SimulatedOom):
            sorted(ctx.Distribute(np.arange(96, dtype=np.int64))
                   .Map(lambda x: x * 3).AllGather())
        assert ctx.overall_stats()["oom_retries"] == 0
        ctx.close()


@pytest.mark.parametrize("exc", [RuntimeError("shape mismatch"),
                                 RuntimeError("CUDA error: out of memory"),
                                 faults.InjectedIOError("x"),
                                 ValueError("bad")])
def test_errors_that_are_not_an_oom_are_never_retried(exc, monkeypatch):
    from thrill_tpu_torch.api.ops import sources
    calls = [0]

    def boom(self):
        calls[0] += 1
        raise exc

    monkeypatch.setattr(sources.GenerateNode, "compute", boom)
    ctx = _tctx(2)
    with pytest.raises(type(exc)):
        ctx.Generate(64).Size()
    assert calls[0] == 1 and ctx.overall_stats()["oom_retries"] == 0
    ctx.close()


def test_a_torch_out_of_memory_error_is_retried(monkeypatch):
    """A real ``torch.OutOfMemoryError`` raised inside a compute (the
    card's allocator raises it): spilled around and retried once."""
    from thrill_tpu_torch.api.ops import sources
    real = sources.GenerateNode.compute
    calls = [0]

    def oom_once(self):
        calls[0] += 1
        if calls[0] == 1:
            scratch = torch.empty(1 << 10)        # freed with the frame
            raise torch.OutOfMemoryError(
                f"CUDA out of memory. Tried to allocate {scratch.numel()}")
        return real(self)

    monkeypatch.setattr(sources.GenerateNode, "compute", oom_once)
    ctx = _tctx(2)
    assert [int(x) for x in ctx.Generate(64).AllGather()] == list(range(64))
    assert calls[0] == 2 and ctx.overall_stats()["oom_retries"] == 1
    ctx.close()


def test_a_host_input_emptied_by_a_compute_is_not_retried(monkeypatch):
    """The host reduce empties its consumed input in place, so a retry
    would read nothing: the OOM surfaces instead of a wrong result."""
    from thrill_tpu_torch.api.ops import reduce as treduce
    real = treduce.ReduceNode._compute_host

    def host_then_oom(self, shards):
        real(self, shards)
        raise MemoryError()

    monkeypatch.setattr(treduce.ReduceNode, "_compute_host", host_then_oom)
    ctx = _tctx(2)
    with pytest.raises(MemoryError):
        ctx.Distribute([("a", 1), ("b", 2), ("a", 3)]).ReducePair(
            "sum").AllGather()
    assert ctx.overall_stats()["oom_retries"] == 0
    ctx.close()


# -- parity under pressure ---------------------------------------------------

@pytest.mark.parametrize("W", WS)
def test_pressured_runs_equal_unpressured(W, monkeypatch):
    """``THRILL_TPU_HBM_LIMIT`` far below the working set and two
    injected OOMs: the same results in both packages as without."""
    want = _pipeline(_tctx(W), tt.FieldReduce)
    monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "4Ki")
    monkeypatch.setenv(faults.ENV_VAR, "mem.oom:n=2:seed=11")
    ctx = _tctx(W)
    got = _pipeline(ctx, tt.FieldReduce)
    assert ctx.overall_stats()["oom_retries"] >= 1
    jfaults.REGISTRY.reset()
    assert got == want == _pipeline(_jctx(W), JFieldReduce)


def test_pagerank_under_pressure_is_bit_equal(monkeypatch):
    from thrill_tpu_torch.examples import page_rank as tpr
    rng = np.random.default_rng(0)
    edges = np.unique(rng.integers(0, 48, size=(300, 2)), axis=0)
    want = tpr.page_rank(_tctx(2), edges, 48, iterations=3)
    monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "8Ki")
    monkeypatch.setenv(faults.ENV_VAR, "mem.oom:n=1:seed=3")
    ctx = _tctx(2)
    got = tpr.page_rank(ctx, edges, 48, iterations=3)
    s = ctx.overall_stats()
    assert s["oom_retries"] == 1 and s["hbm_spills"] >= 1
    assert np.array_equal(got, want)


# -- rungs 2-4 at the stitched dispatch ----------------------------------------
# reference cases: tests/mem/test_pressure.py:163 (split), :187 (host)

def _map_filter(ctx, n=96):
    """A kept, computed source, then Map and Filter as one stitched
    program (the source's own compute is done before any site is armed,
    so the first armed site is the stitched dispatch in both packages)."""
    d = ctx.Distribute(np.arange(n, dtype=np.int64))
    d.Keep()
    assert d.Size() == n
    return d


def _map_filter_items(d):
    return sorted(int(x) for x in d.Map(lambda x: x * 3 + 1).Filter(
        lambda x: x % 2 == 0).AllGather())


def _want_map_filter(n=96):
    return sorted(x * 3 + 1 for x in range(n) if (x * 3 + 1) % 2 == 0)


def _ladder_run(W, spec, monkeypatch):
    """The map-filter chain in both packages under ``spec``: (result,
    stats, events) each."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    out = []
    for make, reg in ((_tctx, faults.REGISTRY), (_jctx, jfaults.REGISTRY)):
        reg.reset()
        ctx = make(W)
        d = _map_filter(ctx)
        monkeypatch.setenv(faults.ENV_VAR, spec)
        try:
            got = _map_filter_items(d)
        finally:
            monkeypatch.delenv(faults.ENV_VAR)
        out.append((got, ctx.overall_stats(), list(reg.events)))
        ctx.close()
    return out


@pytest.mark.parametrize("W", WS)
def test_oom_split_rung_replans_row_ranges(W, monkeypatch):
    """Rung 3: with rung 2's budget spent (one attempt), the row-local
    stitched chain runs as ``split_k`` row-range sub-dispatches
    (``event=segment_split``), bit-equal to the unpressured run."""
    monkeypatch.setenv("THRILL_TPU_RETRY_ATTEMPTS", "1")
    (got, s, ev), (jgot, js, jev) = _ladder_run(W, "mem.oom:n=1:seed=7",
                                                monkeypatch)
    assert got == jgot == _want_map_filter()
    assert s["segment_splits"] == js["segment_splits"] == 1
    assert s["host_fallbacks"] == js["host_fallbacks"] == 0
    splits = [e for e in ev if e.get("event") == "segment_split"]
    jsplits = [e for e in jev if e.get("event") == "segment_split"]
    assert [e["k"] for e in splits] == [e["k"] for e in jsplits] \
        == [pressure.split_k(splits[0]["cap"])]
    assert splits[0]["ops"] == jsplits[0]["ops"] == ["Stack"]


@pytest.mark.parametrize("W", WS)
def test_oom_host_fallback_last_rung(W, monkeypatch):
    """Rung 4: every dispatch runs out of memory, the split chunks too;
    the chain runs per item on the host, bit-equal."""
    monkeypatch.setenv("THRILL_TPU_RETRY_ATTEMPTS", "1")
    (got, s, ev), (jgot, js, jev) = _ladder_run(W, "mem.oom:n=0:seed=7",
                                                monkeypatch)
    assert got == jgot == _want_map_filter()
    assert s["host_fallbacks"] == js["host_fallbacks"] == 1
    assert s["segment_splits"] == js["segment_splits"] == 0
    for events in (ev, jev):
        assert any(e.get("what") == "mem.host_fallback" for e in events)
        assert any(e.get("what") == "mem.split_oom" for e in events)


@pytest.mark.parametrize("W", WS)
def test_oom_retry_at_the_dispatch_counts_each_retry_once(W, monkeypatch):
    """Rung 2 at the dispatch: one injected OOM is one re-dispatch of
    the stitched program, counted once, in both packages; two fires on
    one dispatch are two retries of it."""
    for n in (1, 2):
        (got, s, ev), (jgot, js, _) = _ladder_run(
            W, f"mem.oom:n={n}:seed=3", monkeypatch)
        assert got == jgot == _want_map_filter()
        assert s["oom_retries"] == js["oom_retries"] == n
        assert s["segment_splits"] == s["host_fallbacks"] == 0
        retries = [e for e in ev if e.get("event") == "oom_retry"]
        assert len(retries) == n
        assert all(e["level"] == "dispatch" for e in retries)


def test_split_k_is_the_reference_s():
    for cap in (1, 2, 3, 4, 5, 64, 1 << 20):
        assert pressure.split_k(cap) == jpressure.split_k(cap)


def test_an_oom_that_is_not_the_ladder_s_surfaces_from_a_stitched_chain(
        monkeypatch):
    """A dispatch that fails for another reason re-raises unchanged: no
    retry, no split, no host fallback."""
    from thrill_tpu_torch.api import fusion
    real = fusion._run_stitched

    def boom(*a, **k):
        raise RuntimeError("shape mismatch")

    monkeypatch.setattr(fusion, "_run_stitched", boom)
    ctx = _tctx(2)
    d = _map_filter(ctx)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        _map_filter_items(d)
    s = ctx.overall_stats()
    assert s["oom_retries"] == s["segment_splits"] == s["host_fallbacks"] == 0
    monkeypatch.setattr(fusion, "_run_stitched", real)
    ctx.close()
