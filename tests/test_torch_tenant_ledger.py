"""The HBM governor's tenant ledger (``thrill_tpu_torch/mem/hbm.py``)
against the reference package's on the CPU, at W = 1, 2 and 4.

The reference's ``tests/service/test_tenancy.py::
test_over_budget_tenant_spills_only_itself`` on both packages: tenant
b caches two results, tenant a one, a's budget is set to 1.5 of its
node's ledger bytes, and a's second result pushes a over it. Only a's
cold result spills; b's stay on the device. ``ctx.current_tenant`` and
``ctx.hbm.tenant_budgets`` are set directly (the reference's
``service/tenancy.py`` is not ported yet). The spilled nodes, the tenant
ledger's bytes, ``tenant_spills`` and ``tenant_hbm_peaks`` must equal
the reference's, and the spilled result restores exactly. A second case
makes a tenant spill and a global spill (the ledger's limit) meet in
one cache: both ledgers fall by the spilled nodes' bytes. A third holds
the tenant stamp on nodes and trace spans.

Tolerance: exact.
"""

import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.mem.hbm import SpilledShards as JSpilled
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.mem.hbm import SpilledShards as TSpilled

WIDTHS = [1, 2, 4]


def _ctx(side, W):
    if side == "j":
        return JContext(JMeshExec(num_workers=W))
    return tt.Context(num_workers=W, device="cpu")


def _cache(ctx, tenant, n):
    """One kept device result of ``n`` int64 items made under ``tenant``;
    its node."""
    ctx.current_tenant = tenant
    try:
        d = ctx.Distribute(np.arange(n, dtype=np.int64))
        d.Keep()
        d.node.materialize(consume=False)
    finally:
        ctx.current_tenant = None
    return d.node


def _first_items(side, node):
    sh = node._shards.restore()
    if side == "j":
        import jax
        leaf = np.asarray(jax.tree.leaves(sh.tree)[0])
    else:
        leaf = sh.tree.numpy()
    return sorted(int(x) for x in leaf.reshape(-1)[:8])


def _ledger(ctx):
    s = ctx.overall_stats()
    return {"tenant_bytes": dict(ctx.hbm.tenant_bytes),
            "tenant_spills": s["tenant_spills"],
            "tenant_hbm_peaks": s["tenant_hbm_peaks"],
            "hbm_spills": s["hbm_spills"], "total": ctx.hbm.mem.total}


@pytest.mark.parametrize("W", WIDTHS)
def test_over_budget_tenant_spills_only_itself(W):
    got = {}
    for side in ("j", "t"):
        ctx = _ctx(side, W)
        spilled = JSpilled if side == "j" else TSpilled
        try:
            n = 1 << 12
            nb1 = _cache(ctx, "b", n)
            nb2 = _cache(ctx, "b", n + 1)
            na1 = _cache(ctx, "a", n + 2)
            node_bytes = na1._hbm_bytes
            assert node_bytes > 0
            ctx.hbm.tenant_budgets["a"] = int(1.5 * node_bytes)
            na2 = _cache(ctx, "a", n + 3)
            assert ctx.hbm.tenant_bytes["a"] <= ctx.hbm.tenant_budgets["a"]
            led = _ledger(ctx)
            assert led["tenant_spills"] >= 1
            assert led["tenant_hbm_peaks"]["a"] > \
                ctx.hbm.tenant_budgets["a"]
            assert "b" in led["tenant_hbm_peaks"]
            got[side] = {
                "spilled": [isinstance(x._shards, spilled)
                            for x in (nb1, nb2, na1, na2)],
                "node_bytes": node_bytes, **led,
                "restored": _first_items(side, na1)}
        finally:
            ctx.close()
    assert got["t"] == got["j"]
    # a's cold node only; b's (more bytes, no budget) stay
    assert got["t"]["spilled"] == [False, False, True, False]
    assert got["t"]["restored"] == list(range(8))


@pytest.mark.parametrize("W", WIDTHS)
def test_a_tenant_spill_and_a_global_spill_meet(W):
    got = {}
    for side in ("j", "t"):
        ctx = _ctx(side, W)
        spilled = JSpilled if side == "j" else TSpilled
        try:
            n = 1024 * W
            nb1 = _cache(ctx, "b", n)
            nb2 = _cache(ctx, "b", n)
            na1 = _cache(ctx, "a", n)
            u = na1._hbm_bytes
            # a: 1 + 2 units against 2.5; the ledger: 5 units against 3.5
            ctx.hbm.tenant_budgets["a"] = int(2.5 * u)
            ctx.hbm.mem.limit = int(3.5 * u)
            na2 = _cache(ctx, "a", 2 * n)
            led = _ledger(ctx)
            assert led["total"] == sum(led["tenant_bytes"].values())
            got[side] = {
                "unit": u,
                "spilled": [isinstance(x._shards, spilled)
                            for x in (nb1, nb2, na1, na2)], **led,
                "restored": [_first_items(side, x) for x in (nb1, na1)]}
        finally:
            ctx.close()
    assert got["t"] == got["j"]
    g, u = got["t"], got["t"]["unit"]
    # the tenant spill took a's cold node, the global spill b's coldest
    assert g["spilled"] == [True, False, True, False]
    assert g["tenant_bytes"] == {"a": 2 * u, "b": u}
    assert g["total"] == 3 * u
    assert g["tenant_spills"] == 1 and g["hbm_spills"] == 2
    assert g["restored"] == [list(range(8))] * 2


def test_the_tenant_stamp_on_nodes_and_spans():
    ctx = tt.Context(num_workers=2, device="cpu")
    try:
        assert ctx.current_tenant is None
        plain = ctx.Distribute(np.arange(8, dtype=np.int64))
        ctx.current_tenant = "t1"
        mine = ctx.Distribute(np.arange(8, dtype=np.int64))
        assert ctx.tracer.tenant_fn() == "t1"
        ctx.current_tenant = None
        assert plain.node._tenant is None and mine.node._tenant == "t1"
        assert ctx.tracer.tenant_fn() is None
    finally:
        ctx.close()
