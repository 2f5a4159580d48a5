"""The port's sources against the reference package on the CPU.

``Distribute`` of item sequences (a list of ints, of tuples, of dicts, a
generator), ``EqualToDIA`` and ``ConcatToDIA`` must give the reference's
items, per-worker counts included, at W in {1, 2, 4}: on the device for
numeric items, on the host for strings, objects and ``storage="host"``.
"""

import jax
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt

WIDTHS = [1, 2, 4]

ITEM_LISTS = {
    "ints": lambda: [3, 1, 2],
    "floats and bools": lambda: [1.5, -2.0, 0.25, 7.0, 3.0],
    "tuples": lambda: [(1, 2.0), (0, 1.0), (5, -3.5), (2, 0.0), (9, 9.0)],
    "dicts": lambda: [{"a": i, "b": float(i) / 4, "c": i % 2 == 0}
                      for i in range(11)],
    "numpy rows": lambda: [np.array([i, 2 * i], dtype=np.int32)
                           for i in range(6)],
    "numpy scalars": lambda: [np.float32(i) / 3 for i in range(7)],
    "nested": lambda: [(i, {"x": np.int64(i * i), "y": (i, -i)})
                       for i in range(9)],
    "generator": lambda: (i * i for i in range(13)),
    "tuple of items": lambda: tuple(range(10, 0, -1)),
}


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _ref(W, job):
    jctx = _jax_ctx(W)
    try:
        return job(jctx)
    finally:
        jctx.close()


def _same(a, b):
    """Items equal leaf for leaf (numpy rows by value), types of scalars
    included."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, np.asarray(b))
    return type(a) is type(b) and a == b


def _port_counts(dia):
    return dia.node.materialize().counts.tolist()


def _ref_counts(dia):
    shards = dia.node.materialize()
    if hasattr(shards, "lists"):
        return [len(l) for l in shards.lists]
    return np.asarray(shards.counts).tolist()


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("kind", sorted(ITEM_LISTS))
def test_distribute_of_items_matches_reference(W, kind):
    # fault C6: the port raised on any Python list of items
    want = _ref(W, lambda c: c.Distribute(ITEM_LISTS[kind]()).AllGather())
    got = tt.Context(num_workers=W, device="cpu").Distribute(
        ITEM_LISTS[kind]()).AllGather()
    assert _same(want, got), (want, got)


@pytest.mark.parametrize("W", WIDTHS)
def test_distribute_of_items_splits_as_reference(W):
    items = [(i, float(i)) for i in range(23)]

    def job(c):
        d = c.Distribute(items).Keep()
        return _ref_counts(d), d.AllGather()

    want_counts, want = _ref(W, job)
    d = tt.Context(num_workers=W, device="cpu").Distribute(items).Keep()
    assert _port_counts(d) == want_counts
    assert _same(want, d.AllGather())


@pytest.mark.parametrize("W", WIDTHS)
def test_items_flow_through_the_pipeline(W):
    items = [(i % 5, float(i)) for i in range(40)]

    def job(c):
        return (c.Distribute(items).ReducePair("sum")
                .Sort(lambda kv: kv[0]).AllGather())

    want = _ref(W, job)
    got = job(tt.Context(num_workers=W, device="cpu"))
    assert _same(want, got)


def test_columnar_input_passes_through():
    ctx = tt.Context(num_workers=2, device="cpu")
    t = torch.arange(7, dtype=torch.int64) * 3
    got = ctx.Distribute({"t": t, "a": np.arange(7.0)}).AllGatherArrays()
    assert torch.equal(got["t"], t)
    assert torch.equal(got["a"], torch.arange(7.0, dtype=torch.float64))
    assert ctx.Distribute(t).AllGather() == t.tolist()


@pytest.mark.parametrize("W", WIDTHS)
def test_equal_to_dia_matches_reference(W):
    items = [{"k": i % 3, "v": np.float32(i)} for i in range(10)]
    want = _ref(W, lambda c: c.EqualToDIA(items).AllGather())
    got = tt.Context(num_workers=W, device="cpu").EqualToDIA(items)
    assert _same(want, got.AllGather())
    arr = np.arange(12, dtype=np.int64)
    assert (tt.Context(num_workers=W, device="cpu").EqualToDIA(arr)
            .AllGather() == _ref(W, lambda c: c.EqualToDIA(arr)
                                 .AllGather()))


CONCAT_LISTS = {
    "fewer than W": [[1, 2, 3]],
    "W lists": [[1, 2], [], [3], [4, 5, 6], [7]],
    "more than W": [[1], [2, 3], [4], [5, 6], [7], [], [8, 9], [10]],
}


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("case", sorted(CONCAT_LISTS))
def test_concat_to_dia_matches_reference(W, case):
    lists = CONCAT_LISTS[case]
    if case == "W lists":
        lists = (lists * 4)[:W]
    lists = [[(x, float(-x)) for x in l] for l in lists]

    def job(c):
        d = c.ConcatToDIA(lists).Keep()
        return _ref_counts(d), d.AllGather()

    want_counts, want = _ref(W, job)
    d = tt.Context(num_workers=W, device="cpu").ConcatToDIA(lists).Keep()
    assert _port_counts(d) == want_counts
    assert _same(want, d.AllGather())


def test_concat_to_dia_places_each_list_on_its_worker():
    ctx = tt.Context(num_workers=4, device="cpu")
    shards = ctx.ConcatToDIA([[5], [], [6, 7, 8, 9, 10]],
                             storage="device").node.materialize()
    assert shards.counts.tolist() == [1, 0, 5, 0]
    per = shards.to_worker_arrays()
    assert [p.tolist() for p in per] == [[5], [], [6, 7, 8, 9, 10], []]
    # the default is host storage, as in the reference
    shards = ctx.ConcatToDIA([[5], [], [6, 7, 8, 9, 10]]).node.materialize()
    assert shards.counts.tolist() == [1, 0, 5, 0]
    assert shards.lists == [[5], [], [6, 7, 8, 9, 10], []]


class Point:
    def __init__(self, x):
        self.x = x

    def __eq__(self, other):
        return type(other) is Point and other.x == self.x

    def __repr__(self):
        return f"Point({self.x})"


HOST_ITEMS = {
    "ints with storage='host'": (lambda i: i, "host"),
    "strings": (lambda i: f"s{i}" * (i % 3), None),
    "objects": (lambda i: Point(i), None),
    "mixed tuples": (lambda i: (i, f"k{i}", 0.5 * i), None),
}


def _host_source(src, kind, c, n=11):
    make, storage = HOST_ITEMS[kind]
    if src == "Generate":
        return c.Generate(n, make, storage="host")
    items = [make(i) for i in range(n)]
    if src == "ConcatToDIA":
        return c.ConcatToDIA([items[:3], [], items[3:]], storage=storage)
    return getattr(c, src)(items, storage=storage)


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("src", ["Generate", "Distribute", "EqualToDIA",
                                 "ConcatToDIA"])
@pytest.mark.parametrize("kind", sorted(HOST_ITEMS))
def test_host_storage_matches_reference(W, src, kind):
    def job(c):
        d = _host_source(src, kind, c).Keep()
        shards = d.node.materialize()
        return (type(shards).__name__, [list(l) for l in shards.lists],
                d.Size(), d.AllGather())

    want, got = _ref(W, job), job(tt.Context(num_workers=W, device="cpu"))
    assert got[0] == want[0] == "HostShards"
    assert _same(want[1:], got[1:]), (want, got)


@pytest.mark.parametrize("items", [[object(), object()], ["a", "b"],
                                   [(1, "x")]])
def test_to_device_of_objects_raises_the_reference_s_error(items):
    with pytest.raises(TypeError) as want:
        _ref(2, lambda c: c.Distribute(items).ToDevice().AllGather())
    with pytest.raises(TypeError) as got:
        tt.Context(num_workers=2, device="cpu").Distribute(
            items).ToDevice().AllGather()
    assert "Only arrays of numeric types are supported" in str(want.value)
    assert "Only arrays of numeric types are supported" in str(got.value)


def test_empty_items_raise_the_reference_s_error():
    with pytest.raises(ValueError) as want:
        _ref(2, lambda c: c.Distribute([]).AllGather())
    with pytest.raises(ValueError) as got:
        tt.Context(num_workers=2, device="cpu").Distribute([]).AllGather()
    assert str(got.value) == str(want.value)


# the plan layer's thirteen keys (data/exchange.py, api/planner.py,
# common/decisions.py, service/plan_store.py)
PLAN = {"exchanges_overlapped", "cap_cache_hits", "cap_cache_misses",
        "bytes_wire_device", "bytes_wire_device_raw", "device_uploads",
        "plan_builds", "plan_store_hits", "planner_replans",
        "planner_switches", "decisions_recorded", "decisions_joined",
        "decision_accuracy"}
# the performance doctor's (common/doctor.py): host seconds blocked at
# exchange barriers, the worst skew ratio
DOCTOR = {"collective_wait_s", "wait_net_s", "wait_exchange_s", "wait_io_s",
          "wait_skew_s", "straggler_waits", "skew_ratio"}
# the service plane's (service/): the scheduler's, the front door's and
# the autoscaler's counters, all zero before a Context serves, and the
# per-tenant serve-latency quantiles
SERVICE = {"jobs_submitted", "jobs_failed", "jobs_rejected",
           "jobs_rate_limited", "queue_depth_peak", "fd_conns_accepted",
           "fd_conns_dropped", "fd_jobs_submitted", "fd_jobs_rejected",
           "fd_chunks_sent", "fd_slow_clients", "fd_deadline_expired",
           "autoscale_decisions", "autoscale_ticks", "serve_p50_ms",
           "serve_p99_ms"}


def test_overall_stats_counts_what_the_port_keeps(monkeypatch):
    # the reference's jitted engines (its native CPU engine is a fusion
    # barrier; the port has none)
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    ctx = tt.Context(num_workers=4, device="cpu")
    ctx.Distribute([(i % 3, 1) for i in range(50)]).ReducePair(
        "sum").AllGather()
    s = ctx.overall_stats()
    ref = JContext(JMeshExec(num_workers=4))
    ref.Distribute([(i % 3, 1) for i in range(50)]).ReducePair(
        "sum").AllGather()
    # the reference's names, hbm_peak its governor ledger's peak (nothing
    # stayed cached here) and not the allocator's
    assert set(s) == {"workers", "nodes_created", "exchanges", "items_moved",
                      "bytes_moved", "hbm_peak", "hbm_spills",
                      "hbm_restores", "hbm_high_watermark", "oom_retries",
                      "segment_splits", "host_fallbacks", "admission_spills",
                      "pressure_spilled_bytes", "device_dispatches",
                      "device_fetches", "fused_dispatches", "fused_ops",
                      "fused_stages", "join_overflow_retries",
                      "loop_plan_builds", "loop_replays", "loop_fori_iters",
                      "loop_replay_fallbacks", "loop_donated_bytes",
                      "faults_delayed", "generation", "pipeline_aborts",
                      "heal_time_s", "resizes", "resize_time_s",
                      "resizes_proc", "conn_reconnects",
                      "stale_frames_dropped", "runs_adopted",
                      "tenant_hbm_peaks", "tenant_spills"} | PLAN | DOCTOR \
        | SERVICE
    rs = ref.overall_stats()
    assert set(s) <= set(rs)
    assert {k: s[k] for k in SERVICE} == {k: rs[k] for k in SERVICE}
    assert s["workers"] == 4 and s["nodes_created"] == 2
    assert s["exchanges"] == 1 and s["items_moved"] > 0
    assert s["bytes_moved"] >= 16 * s["items_moved"]
    assert s["hbm_peak"] == rs["hbm_peak"] == 0
    # the reduce's pre and post phases each ran as a stitched program
    for k in ("fused_dispatches", "fused_ops", "fused_stages"):
        assert s[k] == rs[k], k
    assert s["device_dispatches"] >= s["fused_dispatches"] == 2
    assert s["device_fetches"] > 0
    # the plan layer's: one synced plan, nothing cached yet
    for k in ("exchanges_overlapped", "cap_cache_hits", "cap_cache_misses",
              "plan_builds", "plan_store_hits", "planner_replans",
              "planner_switches"):
        assert s[k] == rs[k], k
    assert s["plan_builds"] == 2       # the exchange and the dup verdict
    assert s["bytes_wire_device"] == s["bytes_wire_device_raw"] > 0
    assert s["device_uploads"] > 0
    assert s["decisions_recorded"] >= s["decisions_joined"] > 0
    assert isinstance(s["decision_accuracy"], dict)
    # one controller: no host-group waits, no peers; the reduce's one
    # exchange is balanced
    assert s["wait_net_s"] == 0.0 and s["straggler_waits"] == {}
    assert s["collective_wait_s"] >= s["wait_exchange_s"] >= 0.0
    assert 1.0 <= s["skew_ratio"] == rs["skew_ratio"] < 3.0
    # a fresh Context's failure domain is generation 1, as the reference's
    assert s["generation"] == rs["generation"] == 1
    # no tenant was set: the tenant ledger is empty, as the reference's
    assert s["tenant_hbm_peaks"] == rs["tenant_hbm_peaks"] == {}
    assert s["serve_p50_ms"] == s["serve_p99_ms"] == {}
    assert all(s[k] == 0 for k in set(s) - PLAN - DOCTOR - {
        "tenant_hbm_peaks", "serve_p50_ms", "serve_p99_ms",
        "workers", "nodes_created", "exchanges", "items_moved",
        "bytes_moved", "device_dispatches", "device_fetches",
        "fused_dispatches", "fused_ops", "fused_stages", "generation"})
