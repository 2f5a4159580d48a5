"""The decision ledger (``thrill_tpu_torch/common/decisions.py``) and
``Context.explain()`` against the reference package on the CPU: the
counterpart of the reference's ``tests/common/test_decisions.py`` (the
ledger's flight-recorder sibling, ``dump_beside``, is tested with the
tracer in ``test_torch_trace.py``).

Tolerance: results are compared exactly; the audit math to 1e-12 (one
float log2); the PageRank run's decision kinds and verdicts equal the
reference's.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

import jax
from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import decisions, faults
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.examples import page_rank as tpr

_REF_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in (faults.ENV_VAR, "THRILL_TPU_DECISIONS", "THRILL_TPU_PLANNER",
                "THRILL_TPU_HBM_LIMIT"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _kv(x):
    return (x % 9, x)


def _add(a, b):
    return a + b


def _reduce_job(ctx):
    return sorted((int(k), int(v)) for k, v in ctx.Distribute(
        np.arange(72, dtype=np.int64)).Map(_kv).ReducePair(
            _add).AllGather())


def _ref_pagerank():
    if _REF_EXAMPLES not in sys.path:
        sys.path.insert(0, _REF_EXAMPLES)
    import page_rank
    return page_rank


@pytest.fixture(scope="module")
def pagerank_plans():
    """W = 2 PageRank, three iterations, in both packages, with loop
    replay off (the later iterations plan for real, so the optimistic
    exchange is audited) and an HBM limit (admission on)."""
    env = {"THRILL_TPU_HBM_LIMIT": "256Mi", "THRILL_TPU_LOOP_REPLAY": "0",
           "THRILL_TPU_HOST_RADIX": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        edges = tpr.zipf_graph(128, 512, seed=3)
        jpr = _ref_pagerank()
        for name, ctx, mod in (
                ("port", tt.Context(num_workers=2, device="cpu",
                                    config=Config.from_env()), tpr),
                ("ref", JContext(JMeshExec(devices=jax.devices("cpu")[:2])),
                 jpr)):
            res = {}

            def pipeline(c, mod=mod, res=res):
                res["ranks"] = mod.page_rank(c, edges, 128, iterations=3)

            txt = ctx.explain(pipeline, name="page_rank")
            out[name] = (txt, ctx.decisions.snapshot(),
                         ctx.decisions.accuracy(), res["ranks"])
            ctx.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def test_explain_names_fused_segments_and_strategies(pagerank_plans):
    txt, snap, _acc, _ = pagerank_plans["port"]
    fused_ops = {(d.get("inputs") or {}).get("ops") for d in snap
                 if d["kind"] == "fusion"}
    assert fused_ops, "no fusion decisions recorded"
    # the fused nodes carry the stitched program's ops
    assert any(f"~ fused into [{ops}]" in txt for ops in fused_ops), txt
    assert "xchg_strategy: chose dense over onefactor est" in txt
    assert "fusion_barrier" in txt and "multi-consumer" in txt


def test_pagerank_decisions_are_the_reference_s(pagerank_plans):
    """The same ranks (to 1e-12 relative: the contributions' f64 sums
    are unordered in the reference), the same decisions in order by
    (kind, site prefix, chosen), and the exchange's audit verdicts. The
    admission estimates and the sort-engine records are left out: the
    port's stitched ReduceToIndex is a program per host-known input
    total, so after the first optimistic exchange it builds one program
    (and records its engine) where the reference reuses its own."""
    port, ref = pagerank_plans["port"], pagerank_plans["ref"]
    np.testing.assert_allclose(np.asarray(port[3]), np.asarray(ref[3]),
                               rtol=1e-12, atol=0)

    def seq(snap):
        return [(d["kind"], d["site"].split(":")[0], d["chosen"],
                 d.get("verdict") if d["kind"].startswith("xchg") else None)
                for d in snap if d["kind"] not in ("admission",
                                                   "sort_engine")]
    assert seq(port[1]) == seq(ref[1])


def test_acceptance_kinds_predictions_and_joined_actuals(pagerank_plans):
    _txt, snap, acc, _ = pagerank_plans["port"]
    with_pred = {d["kind"] for d in snap if d.get("predicted") is not None}
    assert len(with_pred) >= 4, with_pred
    joined_finite = {d["kind"] for d in snap
                     if d.get("err_log2") is not None}
    assert len(joined_finite) >= 3, joined_finite
    assert any(d["kind"] == "xchg_optimistic"
               and d.get("verdict") in ("hit", "miss") for d in snap)
    for kind in joined_finite:
        assert acc[kind]["joined"] > 0
        assert np.isfinite(acc[kind]["mae_log2"])


def test_decisions_disabled_is_a_noop(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_DECISIONS", "0")
    monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "256Mi")
    ctx = tt.Context(num_workers=2, device="cpu", config=Config.from_env())
    assert not ctx.decisions.enabled
    d0 = ctx.mesh_exec.stats_dispatches
    n0 = decisions.RECORDS_CREATED
    assert _reduce_job(ctx) == sorted(
        (k, sum(v for v in range(72) if v % 9 == k)) for k in range(9))
    assert ctx.mesh_exec.stats_dispatches > d0
    assert decisions.RECORDS_CREATED == n0
    assert not ctx.decisions.kind_counts
    assert "ReducePair" in ctx.explain() or "Reduce" in ctx.explain()
    assert ctx.overall_stats()["decisions_recorded"] == 0
    ctx.close()


@pytest.mark.parametrize("flag", ["1", "0"])
def test_decision_results_identical_on_off(flag, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_DECISIONS", flag)
    ctx = tt.Context(num_workers=2, device="cpu")
    got = _reduce_job(ctx)
    ctx.close()
    ref = JContext(JMeshExec(devices=jax.devices("cpu")[:2]))
    assert got == _reduce_job(ref)
    ref.close()


def test_explain_wordcount_snapshot():
    from thrill_tpu_torch.examples import word_count as twc
    ctx = tt.Context(num_workers=2, device="cpu")
    lines = ["the quick brown fox", "the lazy dog", "the quick dog"] * 8

    def pipeline(c):
        out = twc.word_count(c, lines).AllGather()
        assert dict(out)["the"] == 24

    txt = ctx.explain(pipeline, name="word_count")
    spine = [ln.split("[")[0].strip() for ln in txt.splitlines()
             if ln.lstrip().startswith("- ")]
    labels = [s.split("#")[0].lstrip("- ") for s in spine]
    assert labels[0] == "ReduceByKey", labels
    assert any(d["kind"] == "prune" for d in ctx.decisions.snapshot())
    ctx.close()


def _spine(txt):
    """The plan tree's node lines (label, id and state), in order."""
    return [ln.rstrip() for ln in txt.splitlines()
            if ln.lstrip().startswith("- ")]


def test_dia_explain_wordcount_is_the_reference_s():
    """``DIA.explain()`` of the WordCount result: the reference's text
    (title, the upstream nodes with their states, each decision)."""
    from thrill_tpu_torch.examples import word_count as twc
    if _REF_EXAMPLES not in sys.path:
        sys.path.insert(0, _REF_EXAMPLES)
    import word_count as jwc
    lines = ["the quick brown fox", "the lazy dog", "the quick dog"] * 8
    txt = {}
    for name, ctx, mod in (
            ("port", tt.Context(num_workers=2, device="cpu"), twc),
            ("ref", JContext(JMeshExec(devices=jax.devices("cpu")[:2])),
             jwc)):
        d = mod.word_count(ctx, lines)
        d.Keep()
        assert dict(d.AllGather())["the"] == 24
        txt[name] = d.explain()
        # it reads the ledger and changes nothing
        assert d.explain() == txt[name]
        ctx.close()
    assert txt["port"] == txt["ref"]
    assert txt["port"].splitlines()[0] == "ReduceByKey#2 (W=2)"


def test_dia_explain_pagerank_degrees():
    """``DIA.explain()`` of the PageRank example's degree table in both
    packages: the reference's text, decisions and audits included, but
    for the sort-engine record."""
    port_ctx = tt.Context(num_workers=2, device="cpu")
    ref_ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:2]))
    txt = {}
    try:
        edges = tpr.zipf_graph(64, 256, seed=5)
        for name, ctx, mod in (("port", port_ctx, tpr),
                               ("ref", ref_ctx, _ref_pagerank())):
            deg = ctx.Distribute(edges[:, 0].astype(np.int64)).Map(
                mod._src_one).ReduceToIndex(
                    mod._page_first, mod._ADD_PAIRS, 64,
                    neutral=(0, 0)).Keep()
            deg.Execute()
            txt[name] = deg.explain()
    finally:
        port_ctx.close()
        ref_ctx.close()
    assert _spine(txt["port"]) == _spine(txt["ref"])
    # the whole text but the sort-engine record (the port's CPU engine is
    # its plain one, the reference's XLA's sort)
    same = {name: [ln for ln in t.splitlines()
                   if not ln.strip().startswith(". sort_engine:")]
            for name, t in txt.items()}
    assert same["port"] == same["ref"]
    assert any(ln.strip().startswith(". xchg_strategy:")
               for ln in same["port"])


def test_ledger_persists_next_to_plan_store(tmp_path):
    store = str(tmp_path / "plans")
    ctx = tt.Context(num_workers=2, device="cpu",
                     config=Config(plan_store=store))
    _reduce_job(ctx)
    ctx.close()
    with open(os.path.join(store, "decisions.json")) as f:
        summary = json.load(f)
    assert summary["decisions"] > 0
    assert "xchg_strategy" in summary["accuracy"]
    assert [k for k, v in summary["accuracy"].items()
            if v.get("mae_log2") is not None]
    assert os.path.exists(os.path.join(store, "plans.json"))


def test_audit_math_and_verdicts():
    led = decisions.DecisionLedger(enabled=True)
    ok = led.record("admission", "jit:a", "admit", predicted=100.0)
    led.resolve(ok, 60.0)
    assert ok.verdict == "ok"
    assert abs(ok.err_log2 - math.log2(100 / 60)) < 1e-12
    off = led.record("admission", "jit:b", "admit", predicted=100.0)
    led.resolve(off, 10.0)
    assert off.verdict == "off"
    un = led.record("xchg_chunks", "xchg:c", "4")
    led.resolve(un, 5.0)
    assert un.verdict == "unmeasured" and un.err_log2 is None
    acc = led.accuracy()
    assert acc["admission"]["joined"] == 2
    assert acc["admission"]["mae_log2"] is not None
    assert led.worst_sites()[0]["site"] == "jit:b"


def test_resolve_site_joins_open_records():
    led = decisions.DecisionLedger(enabled=True)
    led.record("prune", "prune:x", "location:on", predicted=0.5, join=True)
    assert led.resolve_site("prune", "prune:x", 0.25)
    assert not led.resolve_site("prune", "prune:x", 0.25)
    assert not led.resolve_site("prune", "prune:never", 0.1)
    assert led.accuracy()["prune"]["joined"] == 1


def test_render_plan_drops_other_plans_node_decisions():
    nodes = [{"id": 5, "label": "A", "state": "EXECUTED", "parents": []}]
    decs = [{"event": "decision", "seq": 1, "kind": "fusion",
             "chosen": "fuse", "site": "s", "dia_id": 2},
            {"event": "decision", "seq": 2, "kind": "xchg_strategy",
             "chosen": "dense", "site": "t"},
            {"event": "decision", "seq": 3, "kind": "admission",
             "chosen": "admit", "site": "u", "dia_id": 5}]
    txt = decisions.render_plan(nodes, decs)
    assert "admission" in txt and "xchg_strategy" in txt
    assert "fusion" not in txt


def test_render_plan_survives_deep_chains():
    n = 3000
    nodes = [{"id": i, "label": "Op", "state": "EXECUTED",
              "parents": [i - 1] if i else []} for i in range(n)]
    assert decisions.render_plan(nodes, []).count("- Op#") == n


def test_ring_bound_keeps_aggregates():
    led = decisions.DecisionLedger(enabled=True, ring=4)
    for i in range(10):
        led.resolve(led.record("fusion", f"fuse:{i}", "fuse",
                               predicted=8.0), 4.0)
    assert len(led.records) == 4
    assert led.kind_counts["fusion"] == 10
    assert led.accuracy()["fusion"]["joined"] == 10
    assert "fusion" in decisions.render_accuracy(led.accuracy(),
                                                 led.worst_sites())


def test_the_thirteen_stats_keys():
    ctx = tt.Context(num_workers=2, device="cpu")
    _reduce_job(ctx)
    s = ctx.overall_stats()
    ctx.close()
    keys = {"exchanges_overlapped", "cap_cache_hits", "cap_cache_misses",
            "bytes_wire_device", "bytes_wire_device_raw", "device_uploads",
            "plan_builds", "plan_store_hits", "planner_replans",
            "planner_switches", "decisions_recorded", "decisions_joined",
            "decision_accuracy"}
    assert keys <= set(s)
    ref = JContext(JMeshExec(devices=jax.devices("cpu")[:2]))
    _reduce_job(ref)
    assert keys <= set(ref.overall_stats())
    ref.close()
