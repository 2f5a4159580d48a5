"""The planner (``thrill_tpu_torch/api/planner.py``) against the
reference package on the CPU: the counterpart of the reference's
``tests/api/test_planner.py`` (its single-controller cases).

Tolerance: results are compared bit for bit (``==`` of the gathered
items or ``np.array_equal``); plan counters (``cap_cache_misses``,
``planner_replans``, ``planner_switches``, ``plan_store_hits``,
``plan_builds``) and the recorded decisions by (kind, site prefix,
chosen) equal the reference's, the reference's sort engine ``xla``
named ``plain`` in the port.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from thrill_tpu.api import Context as JContext
from thrill_tpu.api import InnerJoin as JInnerJoin
from thrill_tpu.api.loop import Iterate as JIterate
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.planner import Planner
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.common.decisions import DecisionLedger
from thrill_tpu_torch.core import preshuffle
from thrill_tpu_torch.parallel.mesh import MeshExec
from thrill_tpu_torch.service.plan_store import _crc

WS = [1, 2, 4]
STATS = ("cap_cache_hits", "cap_cache_misses", "exchanges_overlapped",
         "device_fetches", "planner_replans", "planner_switches",
         "plan_store_hits", "plan_builds")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in (faults.ENV_VAR, "THRILL_TPU_PLANNER", "THRILL_TPU_HBM_LIMIT",
                "THRILL_TPU_PLAN_STORE", "THRILL_TPU_XCHG_CAP_CACHE",
                "THRILL_TPU_DECISIONS"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _kv(x):
    return (x % 11, x)


def _add(a, b):
    return a + b


def _jk(x):
    return x % 13


def _pair(a, b):
    return (a, b)


def _join_job(ctx):
    """A device InnerJoin of two Distribute sources (host-known counts,
    so the planner's guaranteed-miss check has numbers)."""
    IJ = tt.InnerJoin if isinstance(ctx, tt.Context) else JInnerJoin
    left = ctx.Distribute(np.arange(256, dtype=np.int64))
    right = ctx.Distribute(np.arange(0, 512, 2, dtype=np.int64))
    return sorted((int(a), int(b)) for a, b in
                  IJ(left, right, _jk, _jk, _pair).AllGather())


def _wc_job(ctx):
    return sorted((int(k), int(v)) for k, v in ctx.Distribute(
        np.arange(128, dtype=np.int64)).Map(_kv).ReducePair(
            _add).AllGather())


def _sort_job(ctx):
    return [int(x) for x in ctx.Distribute(
        np.arange(3000, dtype=np.int64)[::-1].copy()).Sort().AllGather()]


def _port(W, cfg=None):
    return tt.Context(num_workers=W, device="cpu", config=cfg)


def _ref(W, cfg=None):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]), cfg)


def _seq(ctx):
    """The decision sequence by (kind, site prefix, chosen)."""
    return [(d["kind"], d["site"].split(":")[0],
             "plain" if d["chosen"] == "xla" else d["chosen"])
            for d in ctx.decisions.snapshot()]


def _stats(ctx):
    s = ctx.overall_stats()
    return {k: s[k] for k in STATS}


def _cfgs(td):
    return (dataclasses.replace(Config.from_env(), plan_store=str(td)),
            dataclasses.replace(JConfig.from_env(), plan_store=str(td)))


def _tamper_caps(td, value):
    """Every stored exchange capacity set to ``value`` (the CRC kept
    valid: stale learned state, not corruption)."""
    p = os.path.join(str(td), "plans.json")
    payload = json.loads(open(p).read())
    caps = payload["entries"].get("caps", {})
    assert caps, "no capacities were persisted"
    for dg in caps:
        caps[dg] = list(value)
    payload["crc"] = _crc(payload["entries"])
    open(p, "w").write(json.dumps(payload))


def test_planner_attached_by_default_and_escape_hatch(monkeypatch):
    ctx = _port(2)
    assert ctx.planner is not None
    assert ctx.mesh_exec.planner is ctx.planner
    assert ctx.decisions.audit_hook == ctx.planner.on_audit
    ctx.close()
    monkeypatch.setenv("THRILL_TPU_PLANNER", "0")
    ctx = _port(2)
    assert ctx.planner is None and ctx.mesh_exec.planner is None
    assert ctx.decisions.audit_hook is None
    st = ctx.overall_stats()
    assert st["planner_replans"] == st["planner_switches"] == 0
    ctx.close()


@pytest.mark.parametrize("W", WS)
def test_decisions_and_plan_stats_are_the_reference_s(W):
    """A WordCount, a join and a Sort, twice each (the second run on the
    cached plans): results, the decision sequence and the plan counters
    equal the reference's."""
    got = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(W)
        res = [_wc_job(ctx), _join_job(ctx), _sort_job(ctx),
               _wc_job(ctx), _join_job(ctx), _sort_job(ctx)]
        got[name] = (res, _seq(ctx), _stats(ctx))
        ctx.close()
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    assert got["port"][2] == got["ref"][2]


@pytest.mark.parametrize("planner", ["1", "0"])
def test_planner_vs_per_site_rules_parity(planner, monkeypatch):
    """The planner's choices are the per-site rules' choices: equal
    results and equal strategy, chunk and prune records, on and off."""
    monkeypatch.setenv("THRILL_TPU_PLANNER", planner)
    ctx = _port(2)
    wc, jn = _wc_job(ctx), _join_job(ctx)
    choices = [(d["kind"], d["chosen"]) for d in ctx.decisions.snapshot()
               if d["kind"] in ("xchg_strategy", "xchg_chunks", "prune")]
    ctx.close()
    monkeypatch.setenv("THRILL_TPU_PLANNER", "0" if planner == "1" else "1")
    ctx = _port(2)
    assert (wc, jn) == (_wc_job(ctx), _join_job(ctx))
    assert choices == [(d["kind"], d["chosen"])
                       for d in ctx.decisions.snapshot()
                       if d["kind"] in ("xchg_strategy", "xchg_chunks",
                                        "prune")]
    ctx.close()


@pytest.mark.parametrize("planner", ["1", "0"])
def test_stale_seeded_capacity_as_the_reference(planner, tmp_path,
                                                monkeypatch):
    """Plan-store capacities seeded below the known row counts: with
    the planner the guaranteed miss is caught before the dispatch (no
    healed miss, one replan, the cold run's capacities); without it the
    optimistic dispatch overflows and heals. Either way the results and
    the plan counters are the reference's (on a CPU mesh the capacities
    round to powers of two as the reference's; the card's by
    ``exchange.round_cap``)."""
    monkeypatch.setenv("THRILL_TPU_PLANNER", planner)
    out = {}
    for name, make, cfg_i in (("port", _port, 0), ("ref", _ref, 1)):
        td = tmp_path / name
        cfg = _cfgs(td)[cfg_i]
        ctx = make(2, cfg)
        cold = _join_job(ctx)
        cold_caps = sorted(v for k, v in ctx.mesh_exec._sticky_caps.items()
                           if k[0] == "xchg_caps")
        ctx.close()
        _tamper_caps(td, [1, 1])
        ctx = make(2, cfg)
        warm = _join_job(ctx)
        st = _stats(ctx)
        caps = sorted(v for k, v in ctx.mesh_exec._sticky_caps.items()
                      if k[0] == "xchg_caps")
        text = ctx.explain()
        ctx.close()
        assert warm == cold
        if planner == "1":
            assert caps == cold_caps
        out[name] = (warm, st)
        if planner == "1":
            assert st["cap_cache_misses"] == 0
            assert st["planner_replans"] >= 1
            assert any("replan" in l and "synced" in l
                       and "optimistic" in l for l in text.splitlines())
        else:
            assert st["cap_cache_misses"] >= 1
    assert out["port"] == out["ref"]


def test_overprovisioned_seed_reoptimizes_via_audit(tmp_path):
    """Capacities seeded far above the need: the deferred check's audit
    marks the seeded site, and the next run re-plans to the cold run's
    capacities, as in the reference."""
    out = {}
    for name, make, cfg_i in (("port", _port, 0), ("ref", _ref, 1)):
        td = tmp_path / name
        cfg = _cfgs(td)[cfg_i]
        ctx = make(2, cfg)
        cold = _join_job(ctx)
        cold_caps = sorted(v for k, v in ctx.mesh_exec._sticky_caps.items()
                           if k[0] == "xchg_caps")
        ctx.close()
        _tamper_caps(td, [1 << 16, 1 << 16])
        ctx = make(2, cfg)
        w1, w2 = _join_job(ctx), _join_job(ctx)
        st = _stats(ctx)
        caps = sorted(v for k, v in ctx.mesh_exec._sticky_caps.items()
                      if k[0] == "xchg_caps")
        ctx.close()
        assert w1 == w2 == cold and caps == cold_caps
        assert st["planner_replans"] >= 1
        out[name] = st
    assert out["port"] == out["ref"]


def _mesh_with_planner():
    mex = MeshExec(num_workers=2, device="cpu")
    mex.decisions = DecisionLedger(enabled=True)
    mex.planner = Planner(mex, enabled=True)
    mex.decisions.audit_hook = mex.planner.on_audit
    return mex


def test_prune_verdict_reoptimizes_on_observed_fraction():
    """A prune fraction observed far below the prediction marks the
    site, and its next use re-evaluates at once (not after the resync
    window)."""
    mex = _mesh_with_planner()
    token = ("t-prune",)
    rows, ib = 1_000_000, 32
    assert preshuffle.auto_location_detect(mex, rows, ib, token) is True
    preshuffle.record_prune(mex, token, rows, rows - 1000)
    assert mex.planner._replan, "the audit did not mark the site"
    assert preshuffle.auto_location_detect(mex, rows, ib, token) is False
    assert mex.planner.replans >= 1 and mex.planner.switches >= 1
    recs = [d for d in mex.decisions.snapshot() if d["kind"] == "replan"]
    assert recs and "fraction" in recs[-1]["reason"]
    assert mex.prune_verdicts[("ld", token)] is False


def test_io_prefetch_depth_learns_from_audited_hit_rate():
    """A measured hit rate under target doubles that site's depth (to
    the cap), with a replan record; an explicit off is never
    overridden."""
    mex = _mesh_with_planner()
    pl, led = mex.planner, mex.decisions
    led.resolve(led.record("io_prefetch", "em_sort.merge", "depth=4",
                           predicted=1.0), 0.9)
    assert pl.io_prefetch_depth("em_sort.merge", 4) == 4
    led.resolve(led.record("io_prefetch", "ckpt.restore", "depth=4",
                           predicted=1.0), 0.25)
    assert pl.io_prefetch_depth("ckpt.restore", 4) == 8
    assert pl.io_prefetch_depth("ckpt.restore", 4) == 8
    assert pl.io_prefetch_depth("em_sort.merge", 4) == 4
    recs = [d for d in led.snapshot()
            if d["kind"] == "replan" and d["site"] == "ckpt.restore"]
    assert recs and recs[-1]["chosen"] == "depth=8"
    for _ in range(8):
        led.resolve(led.record("io_prefetch", "ckpt.restore", "depth=8",
                               predicted=1.0), 0.1)
        pl.io_prefetch_depth("ckpt.restore", 4)
    assert pl.io_prefetch_depth("ckpt.restore", 4) == pl.IO_DEPTH_CAP
    assert pl.io_prefetch_depth("ckpt.restore", 0) == 0


def test_io_prefetch_depth_shrinks_after_sustained_high_hit_rate():
    mex = _mesh_with_planner()
    pl, led = mex.planner, mex.decisions
    site = "spill.restore"

    def audit(rate):
        led.resolve(led.record("io_prefetch", site, "depth",
                               predicted=1.0), rate)

    for _ in range(2):
        audit(0.25)
        pl.io_prefetch_depth(site, 4)
    assert pl.io_prefetch_depth(site, 4) == 16
    audit(0.97)
    assert pl.io_prefetch_depth(site, 4) == 16
    audit(0.90)
    audit(0.99)
    assert pl.io_prefetch_depth(site, 4) == 16
    audit(1.0)
    assert pl.io_prefetch_depth(site, 4) == 8
    for _ in range(2):
        audit(0.99)
        audit(0.99)
        pl.io_prefetch_depth(site, 4)
    assert pl.io_prefetch_depth(site, 4) == 4
    assert pl.io_prefetch_depth(site, 0) == 0


def test_io_prefetch_decisions_at_the_sites(monkeypatch, tmp_path):
    """The external-memory Sort's merge records its readahead depth as
    an ``io_prefetch`` decision joined by the measured hit rate, as the
    reference's does."""
    monkeypatch.setenv("THRILL_TPU_HOST_SORT_RUN", "500")
    monkeypatch.setenv("THRILL_TPU_SPILL_RESIDENT", "64K")
    got = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(2)
        items = [f"w{i * 7919 % 4000:05d}" for i in range(4000)]
        out = ctx.Distribute(items).Sort().AllGather()
        recs = [d for d in ctx.decisions.snapshot()
                if d["kind"] == "io_prefetch"]
        got[name] = (out, [(d["site"], d["chosen"]) for d in recs],
                     [d.get("verdict") is not None for d in recs])
        ctx.close()
    assert got["port"] == got["ref"]
    assert got["port"][1] and got["port"][1][0][0] == "em_sort.merge"


def _map_chain(ctx, n):
    return np.asarray(ctx.Distribute(np.arange(n, dtype=np.int64))
                      .Map(lambda x: x * 2 + 1).AllGather())


def test_proactive_fusion_split_under_hbm_estimate(monkeypatch):
    """A row-local stitched chain whose estimate cannot fit under the
    watermark at any spill level runs as row-range sub-dispatches before
    any OOM, bit-equal; with the planner off it dispatches whole."""
    n = 1 << 15
    ctx = _port(2)
    golden = _map_chain(ctx, n)
    ctx.close()
    monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "400K")
    ctx = _port(2, Config.from_env())
    out = _map_chain(ctx, n)
    st = ctx.overall_stats()
    recs = [d for d in ctx.decisions.snapshot()
            if d["kind"] == "fusion_split"]
    ctx.close()
    assert np.array_equal(out, golden)
    assert st["segment_splits"] >= 1 and st["oom_retries"] == 0
    assert recs and recs[0]["chosen"].startswith("split:")
    assert recs[0]["rejected"][0][0] == "whole"
    monkeypatch.setenv("THRILL_TPU_PLANNER", "0")
    ctx = _port(2, Config.from_env())
    out3 = _map_chain(ctx, n)
    st3 = ctx.overall_stats()
    ctx.close()
    assert np.array_equal(out3, golden) and st3["segment_splits"] == 0


def test_skew_mark_forces_resync_on_next_dispatch():
    ctx = _port(2)
    _wc_job(ctx)
    _wc_job(ctx)
    mex = ctx.mesh_exec
    assert ctx.overall_stats()["cap_cache_hits"] >= 1
    sites = [d["site"] for d in ctx.decisions.snapshot()
             if d["kind"] == "xchg_optimistic"]
    assert sites
    ctx.planner.mark_replan(sites[-1], "test: skew observed")
    builds0 = mex.stats_plan_builds
    _wc_job(ctx)
    assert mex.stats_plan_builds > builds0
    assert ctx.planner.replans >= 1
    ctx.close()


def _tape_run(pkg, td, name, body_kind, n=5):
    cfg = _cfgs(td)[0 if pkg == "port" else 1]
    ctx = _port(2, cfg) if pkg == "port" else _ref(2, cfg)
    mex = ctx.mesh_exec
    if pkg == "port":
        it = tt.Iterate
        start = {"v": torch.arange(8)}
        if body_kind == "plain":
            def body(tree):
                return {"v": torch.as_tensor(tree["v"].numpy() + 1)}
        else:
            def body(tree):
                f = mex.jit_cached(("tape-step", body_kind),
                                   lambda x: {"v": x["v"] * 2 + 1})
                return f(tree)
    else:
        it = JIterate
        start = {"v": jnp.arange(8)}
        if body_kind == "plain":
            def body(tree):
                return {"v": jnp.asarray(np.asarray(tree["v"]) + 1)}
        else:
            def body(tree):
                f = mex.jit_cached(("tape-step", body_kind),
                                   lambda x: {"v": x["v"] * 2 + 1})
                return f(tree)
    out = it(ctx, body, start, n, name=name)
    rep = dict(mex.loop_reports[-1])
    st = _stats(ctx)
    ctx.close()
    return np.asarray(out["v"]), rep.get("seed"), rep["captures"], st


@pytest.mark.parametrize("kind", ["tape", "plain"])
def test_loop_tape_metadata_warm_restart(kind, tmp_path):
    """A captured loop's record makes the warm restart's tape "trusted"
    (``seed == "tape"``); a loop that did not capture skips its probes
    (``seed == "nocapture"``); results, captures and the plan counters
    equal the reference's."""
    out = {}
    for pkg in ("port", "ref"):
        td = tmp_path / pkg
        r1 = _tape_run(pkg, td, "loop-" + kind, kind)
        r2 = _tape_run(pkg, td, "loop-" + kind, kind)
        assert np.array_equal(r1[0], r2[0])
        assert r1[1] is None
        assert r2[1] == ("tape" if kind == "tape" else "nocapture")
        out[pkg] = (r1[1:], r2[1:])
    assert out["port"] == out["ref"]
    assert out["port"][1][2]["plan_store_hits"] >= 1


@pytest.mark.parametrize("rows", [1 << 10, 1 << 20, 1 << 24])
@pytest.mark.parametrize("words", [1, 3])
def test_the_card_sorts_on_the_radix_engine(rows, words):
    """``sort_engine_policy``: on the card the radix engine (the port's
    kernels) at every size, with both engines priced by the card's
    constants; the plain engine only where the radix engine is not
    eligible; on the CPU the plain engine, as the reference's ``xla``."""
    from thrill_tpu_torch.core.device_sort import sort_engine_policy
    engine, costs, _ = sort_engine_policy(rows, 64 * words, True, "cuda",
                                          words)
    assert engine == "radix"
    assert set(costs) == {"radix", "plain"}
    assert all(c > 0 for c in costs.values())
    # the fit puts the plain engine ahead of small sorts, not past 4M rows
    assert (costs["plain"] < costs["radix"]) == (rows < (1 << 22))
    assert sort_engine_policy(rows, 64 * words, False, "cuda",
                              words)[0] == "plain"
    assert sort_engine_policy(rows, 64 * words, True, "cpu",
                              words)[0] == "plain"
