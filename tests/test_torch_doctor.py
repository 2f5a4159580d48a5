"""The performance doctor (``thrill_tpu_torch/common/doctor.py``) against
the reference package on the CPU.

Tolerance: exact. A hot-keyed ReduceByKey at W = 4 (every item on one
key, so each worker's locally pre-reduced row lands on one worker: a
4:0:0:0 receive) gives the reference's ``skew_ratio``, hot sites (by
exchange site digest), skew decision and plan-lane instant; the critical
path and the rendered report of the same span records are the
reference's, byte for byte; ``THRILL_TPU_DOCTOR=0`` keeps ``RECORDS``
flat across a pipeline; a slow exchange made by the latency fault mode
is what the critical path names.
"""

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.common import doctor as jdoctor
from thrill_tpu.common import faults as jfaults
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import doctor, faults


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in (faults.ENV_VAR, "THRILL_TPU_DOCTOR", "THRILL_TPU_SKEW_HOT"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _make(pkg, W):
    if pkg == "port":
        return tt.Context(num_workers=W, device="cpu")
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _hot_kv(x):
    return (x * 0 + 7, x)


def _mod_kv(x):
    return (x % 32, x)


def _add(a, b):
    return a + b


def _skew_run(pkg, W, kv=_hot_kv, n=400):
    ctx = _make(pkg, W)
    try:
        out = sorted((int(k), int(v)) for k, v in ctx.Distribute(
            np.arange(n, dtype=np.int64)).Map(kv).ReducePair(_add)
            .AllGather())
        st = ctx.overall_stats()
        return {"out": out, "skew_ratio": st["skew_ratio"],
                "hot": ctx.doctor.hot_sites(),
                "skew_decisions": ctx.decisions.kind_counts.get("skew", 0),
                "explain": ctx.explain(),
                "instants": [{k: r[k] for k in ("cat", "name", "kind", "site",
                                                "ratio", "worker")}
                             for r in ctx.tracer.ring
                             if r.get("kind") == "skew"],
                "wait_keys": sorted(k for k in st if k.startswith("wait_")),
                "ring": list(ctx.tracer.ring),
                "report": ctx.doctor_report()}
    finally:
        ctx.close()


@pytest.fixture(scope="module")
def hot():
    mp = pytest.MonkeyPatch()
    mp.setenv("THRILL_TPU_HOST_RADIX", "0")
    try:
        return {pkg: _skew_run(pkg, 4) for pkg in ("port", "ref")}
    finally:
        mp.undo()


def test_hot_key_skew_ratio_is_the_reference_s(hot):
    port, ref = hot["port"], hot["ref"]
    assert port["out"] == ref["out"] == [(7, sum(range(400)))]
    assert port["skew_ratio"] == ref["skew_ratio"] == 4.0
    assert port["skew_ratio"] >= doctor.skew_hot_ratio()


def test_hot_sites_are_the_reference_s(hot):
    port, ref = hot["port"], hot["ref"]
    assert port["hot"] == ref["hot"]
    assert len(port["hot"]) == 1 and port["hot"][0]["hot"]
    assert port["hot"][0]["site"].startswith("xchg:")


def test_the_skew_decision_and_instant_are_the_reference_s(hot):
    port, ref = hot["port"], hot["ref"]
    assert port["skew_decisions"] == ref["skew_decisions"] == 1
    assert "hot slot" in port["explain"]
    assert port["instants"] == ref["instants"]
    assert port["instants"][0]["cat"] == "plan"


def test_a_balanced_exchange_stays_cool():
    for pkg in ("port", "ref"):
        r = _skew_run(pkg, 4, kv=_mod_kv, n=256)
        assert r["skew_ratio"] < 3.0 and r["hot"] == []


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("k", [1, 3, 5, 20])
def test_critical_path_is_the_reference_s_on_the_same_records(hot, pkg, k):
    """Both packages' ``critical_path`` over one run's span records."""
    recs = hot[pkg]["ring"]
    assert doctor.critical_path(recs, k=k) == jdoctor.critical_path(recs,
                                                                     k=k)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_render_report_is_the_reference_s(hot, pkg):
    rep = dict(hot[pkg]["report"])
    rep["straggler_rank"] = 1
    rep["straggler_scores"] = {"1": 0.25}
    rep["wait_by_site"] = {"xchg.plan_sync": 0.5,
                           "xchg.deferred_check": 0.125}
    assert doctor.render_report(rep) == jdoctor.render_report(rep)
    assert "-- partition skew --" in doctor.render_report(rep)
    assert "-- critical path" in doctor.render_report(rep)


def test_critical_path_offline_over_merged_ranks():
    recs = []
    for rank, base in ((0, 100), (1, 100)):
        dur = 50_000 if rank == 0 else 90_000
        recs.append({"event": "span", "cat": "loop", "name": "replay",
                     "trace": f"t{rank}", "span": 1, "rank": rank,
                     "ts": base, "dur_us": dur})
        recs.append({"event": "span", "cat": "exchange", "name": "phase_b",
                     "trace": f"t{rank}", "span": 2, "parent": 1,
                     "rank": rank, "ts": base + 10, "dur_us": dur - 20_000})
    edges = doctor.critical_path(recs)
    assert edges == jdoctor.critical_path(recs)
    assert edges[0]["rank"] == 1
    assert edges[0]["path"].startswith("loop:replay")


def _structural_trees(ring):
    """The span records of ``ring`` with ``ts`` and ``dur_us`` rewritten
    from the span tree alone, one list of records a root span in span-id
    order: a span lasts 1 + its number of descendants, its children are
    laid out one after another from its start in span-id order, and a
    root starts at 0. A critical path over these records depends on the
    tree, never on the clock, and a root's duration counts every span
    under it."""
    spans = [dict(r) for r in ring
             if r.get("event") == "span" and r.get("kind") != "instant"]
    by_key = {(r.get("rank", 0), r.get("trace"), r.get("span")): r
              for r in spans}
    kids = {}
    roots = []
    for key, r in sorted(by_key.items(), key=lambda kv: kv[0][2] or 0):
        pkey = (key[0], key[1], r.get("parent"))
        if r.get("parent") is not None and pkey in by_key:
            kids.setdefault(pkey, []).append(key)
        else:
            roots.append(key)

    def size(key):
        n = 1 + sum(size(c) for c in kids.get(key, ()))
        by_key[key]["dur_us"] = n
        return n

    def place(key, ts, tree):
        by_key[key]["ts"] = ts
        tree.append(by_key[key])
        for c in kids.get(key, ()):
            place(c, ts, tree)
            ts += by_key[c]["dur_us"]
        return tree

    for key in roots:
        size(key)
    return [place(key, 0, []) for key in roots]


def _structural_paths(cp, ring):
    """``cp`` (a package's ``critical_path``) over each root's tree of
    :func:`_structural_trees`, every edge kept."""
    return [cp(tree, k=len(tree)) for tree in _structural_trees(ring)]


def test_the_reports_have_the_reference_s_keys(hot):
    port, ref = hot["port"]["report"], hot["ref"]["report"]
    assert sorted(port) == sorted(ref)
    assert hot["port"]["wait_keys"] == hot["ref"]["wait_keys"]
    assert port["skew_sites"] == ref["skew_sites"]
    # each package's own critical path over its own span tree, timed by
    # the tree's structure: two runs' measured durations differ under
    # load, their trees do not
    port_paths = _structural_paths(doctor.critical_path,
                                   hot["port"]["ring"])
    assert port_paths == _structural_paths(jdoctor.critical_path,
                                           hot["ref"]["ring"])
    assert len(port_paths) > 1
    assert [e["path"] for e in port["critical_path"]] and \
        [e["path"] for e in ref["critical_path"]]


def test_doctor_off_is_a_pinned_no_op(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_DOCTOR", "0")
    before = doctor.RECORDS
    ctx = _make("port", 2)
    try:
        assert ctx.doctor is None and ctx.mesh_exec.doctor is None
        ctx.Distribute(np.arange(64, dtype=np.int64)).Map(_mod_kv) \
            .ReducePair(_add).AllGather()
        st = ctx.overall_stats()
        assert ctx.doctor_report() == {}
    finally:
        ctx.close()
    assert doctor.RECORDS == before
    assert st["collective_wait_s"] == 0.0 and st["skew_ratio"] == 0.0
    assert st["straggler_waits"] == {}


def test_the_doctor_records_exchange_waits_by_default():
    before = doctor.RECORDS
    ctx = _make("port", 2)
    try:
        ctx.Distribute(np.arange(64, dtype=np.int64)).Map(_mod_kv) \
            .ReducePair(_add).AllGather()
        st = ctx.overall_stats()
    finally:
        ctx.close()
    assert doctor.RECORDS > before
    assert st["wait_net_s"] == 0.0
    assert st["collective_wait_s"] == pytest.approx(
        st["wait_net_s"] + st["wait_exchange_s"], abs=2e-4)


def test_the_critical_path_names_a_slow_exchange(monkeypatch):
    """The latency fault mode makes the exchange's chunk dispatch slow
    (0.5 s): the critical path runs through the exchange."""
    monkeypatch.setenv(faults.ENV_VAR, "data.exchange.chunk:delay=0.5s:n=1")
    ctx = _make("port", 2)
    try:
        ctx.Distribute(np.arange(128, dtype=np.int64)).Map(_mod_kv) \
            .ReducePair(_add).AllGather()
        rep = ctx.doctor_report()
        delayed = ctx.overall_stats()["faults_delayed"]
    finally:
        ctx.close()
    assert delayed == 1
    edges = rep["critical_path"]
    assert any(e["cat"] == "exchange" for e in edges)
    deepest = max(edges, key=lambda e: e["path"].count(">"))
    assert "exchange" in deepest["path"]
    for e in edges:
        assert 0 <= e["excl_us"] <= e["dur_us"]


def test_fold_skew_sites_is_the_reference_s():
    events = [{"event": "exchange", "site": "xchg:a", "skew_ratio": 3.5,
               "hot_worker": 2, "hot_rows": 70, "bytes": 64, "items": 8},
              {"event": "exchange", "site": "xchg:a", "skew_ratio": 1.2,
               "hot_worker": 0, "hot_rows": 9, "bytes": 64, "items": 8},
              {"event": "exchange", "site": "xchg:b", "bytes": 8},
              {"event": "span", "cat": "x"}]
    assert doctor.fold_skew_sites(events) == jdoctor.fold_skew_sites(events)
