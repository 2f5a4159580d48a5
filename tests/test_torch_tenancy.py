"""Tenancy (``thrill_tpu_torch/service/tenancy.py``) and the config
parser it shares with the scheduler (``common/config.py``
``parse_kv_spec``) against the reference package's on the CPU.

``parse_budgets`` and ``parse_kv_spec`` give the reference's dicts and
the reference's notice on stderr over a table of specs, malformed ones
among them. The reference's ``tests/service/test_tenancy.py`` cases run
on both packages: ``set_budget`` and ``activate``; an over-budget tenant
spills only its own results, the same ones by label as the reference's
governor, through ``tenancy.activate`` at W = 1, 2 and 4; and the
scheduler form, budgets from ``THRILL_TPU_SERVE_HBM_BUDGETS`` and two
tenants' jobs submitted to one Context, where the budgeted tenant's
kept results spill and the other's stay on the device, each package
spilling the same jobs' results.

Tolerance: exact.
"""

import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.common import config as jconfig
from thrill_tpu.common import faults as jfaults
from thrill_tpu.mem.hbm import SpilledShards as JSpilled
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
from thrill_tpu.service import tenancy as jtenancy

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import config as tconfig
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.mem.hbm import SpilledShards as TSpilled
from thrill_tpu_torch.service import tenancy as ttenancy

SPECS = ["", "a=1Mi, b=2K ,bad, c=0", "x=3,x=4", "=5", "t=1e3",
         "a=1Gi,b=-1,c=12Mi", " , ,", "tenant one=64K", "a==1", "a=1,b",
         "q=1.5Ki", "w=0x10"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in (faults.ENV_VAR, ttenancy.ENV_BUDGETS, "THRILL_TPU_SERVE_PORT",
                "THRILL_TPU_AUTOSCALE_S"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _ctx(side, W):
    if side == "j":
        return JContext(JMeshExec(num_workers=W))
    return tt.Context(num_workers=W, device="cpu")


@pytest.mark.parametrize("spec", SPECS)
def test_parse_budgets_and_kv_spec_equal_the_reference(spec, capsys):
    assert ttenancy.ENV_BUDGETS == jtenancy.ENV_BUDGETS
    got = ttenancy.parse_budgets(spec)
    err_t = capsys.readouterr().err
    want = jtenancy.parse_budgets(spec)
    err_j = capsys.readouterr().err
    assert got == want and err_t == err_j
    for fn in (float, int, str.upper):
        got = tconfig.parse_kv_spec(spec, fn, "WHAT")
        err_t = capsys.readouterr().err
        want = jconfig.parse_kv_spec(spec, fn, "WHAT")
        err_j = capsys.readouterr().err
        assert got == want and err_t == err_j, (spec, fn)


def test_budget_parsing_and_validation():
    assert ttenancy.parse_budgets("a=1Mi, b=2K ,bad, c=0") == {
        "a": 1 << 20, "b": 2048}
    ctx = _ctx("t", 1)
    try:
        ttenancy.set_budget(ctx, "t", "4Ki")
        assert ctx.hbm.tenant_budgets["t"] == 4096
        ttenancy.set_budget(ctx, "u", 123)
        assert ctx.hbm.tenant_budgets["u"] == 123
        with pytest.raises(ValueError):
            ttenancy.set_budget(ctx, "t", 0)
        # configure: explicit budgets win, the environment fills the rest
        import os
        os.environ[ttenancy.ENV_BUDGETS] = "t=1Ki,v=2Ki"
        try:
            ttenancy.configure(ctx, {"w": 7})
        finally:
            del os.environ[ttenancy.ENV_BUDGETS]
        assert ctx.hbm.tenant_budgets == {"t": 4096, "u": 123, "w": 7,
                                          "v": 2048}
    finally:
        ctx.close()


def test_activate_restores_previous_tenant():
    ctx = _ctx("t", 1)
    try:
        assert ctx.current_tenant is None
        with ttenancy.activate(ctx, "outer"):
            with ttenancy.activate(ctx, "inner"):
                assert ctx.current_tenant == "inner"
                node = ctx.Distribute(np.arange(4)).node
            assert ctx.current_tenant == "outer"
        assert ctx.current_tenant is None
        assert node._tenant == "inner"
    finally:
        ctx.close()


def _cache_array(ctx, n):
    d = ctx.Distribute(np.arange(n, dtype=np.int64))
    d.Keep()
    d.node.materialize(consume=False)
    return d


def _over_budget(side, W):
    ctx = _ctx(side, W)
    tn = jtenancy if side == "j" else ttenancy
    spilled_cls = JSpilled if side == "j" else TSpilled
    try:
        n = 1 << 12
        kept = {}
        with tn.activate(ctx, "b"):
            kept["b1"] = _cache_array(ctx, n)
            kept["b2"] = _cache_array(ctx, n + 1)
        with tn.activate(ctx, "a"):
            kept["a1"] = _cache_array(ctx, n + 2)
        tn.set_budget(ctx, "a", int(1.5 * kept["a1"].node._hbm_bytes))
        with tn.activate(ctx, "a"):
            kept["a2"] = _cache_array(ctx, n + 3)
        spilled = sorted(k for k, d in kept.items()
                         if isinstance(d.node._shards, spilled_cls))
        s = ctx.overall_stats()
        return {"spilled": spilled, "tenant_bytes": dict(ctx.hbm.tenant_bytes),
                "tenant_spills": s["tenant_spills"],
                "tenant_hbm_peaks": s["tenant_hbm_peaks"],
                "a1": sorted(int(x) for x in kept["a1"].AllGather())[:8]}
    finally:
        ctx.close()


@pytest.mark.parametrize("W", [1, 2, 4])
def test_over_budget_tenant_spills_only_itself_as_the_reference(W):
    got, want = _over_budget("t", W), _over_budget("j", W)
    assert got == want
    assert got["spilled"] == ["a1"] and got["tenant_spills"] >= 1
    assert got["a1"] == list(range(8))


def _keeper(tag, size):
    def job(c):
        d = c.Distribute(np.arange(size, dtype=np.int64))
        d.Keep()
        d.node.materialize(consume=False)
        return d
    job.__name__ = f"keeper_{tag}"
    return job


def _served_budgets(side, monkeypatch):
    n = 1 << 12
    # one node of n int64 items pads its capacity to a power of two:
    # 8192 rows x 8 B = 64 KiB; 1.5 nodes keeps one resident
    monkeypatch.setenv(ttenancy.ENV_BUDGETS, f"small={int(1.5 * 65536)}")
    ctx = _ctx(side, 1)
    spilled_cls = JSpilled if side == "j" else TSpilled
    try:
        tags = [("s0", n, "small"), ("b0", n, "big"), ("s1", n + 1, "small"),
                ("b1", n + 1, "big"), ("s2", n + 2, "small")]
        futs = {tag: ctx.submit(_keeper(tag, size), tenant=t, name=tag)
                for tag, size, t in tags}
        kept = {tag: f.result(300) for tag, f in futs.items()}
        spilled = sorted(tag for tag, d in kept.items()
                         if isinstance(d.node._shards, spilled_cls))
        s = ctx.overall_stats()
        out = {"spilled": spilled,
               "small_bytes": ctx.hbm.tenant_bytes["small"],
               "budget": ctx.hbm.tenant_budgets["small"],
               "tenant_spills": s["tenant_spills"],
               "sizes": {tag: len(d.AllGather()) for tag, d in kept.items()}}
        monkeypatch.delenv(ttenancy.ENV_BUDGETS)
        return out
    finally:
        ctx.close()


def test_served_tenants_under_env_budgets_as_the_reference(monkeypatch):
    got = _served_budgets("t", monkeypatch)
    want = _served_budgets("j", monkeypatch)
    assert got == want
    assert got["small_bytes"] <= got["budget"]
    assert got["spilled"] and all(t.startswith("s") for t in got["spilled"])
    assert got["tenant_spills"] >= 1
